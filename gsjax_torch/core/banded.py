"""Banded scene store: splat groups by SH degree without zero padding —
the PyTorch counterpart of gsjax/core/banded.py.

A quantized PLY partitions its scene into 4 groups by active SH band
count. `BandedGaussians` keeps them as an ordered list of `Gaussians`
groups, each with its OWN K ∈ {1, 4, 9, 16}, in an nn.ModuleList, so its
parameters() reach an optimizer. Projection runs per group (each
evaluates only its own SH degree) and concatenates the projected splats;
everything downstream (layout, bins, blend, gradients) is band-oblivious.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gsjax_torch.core.gaussians import Gaussians


class BandedGaussians(nn.Module):
    """Splat groups in ascending band order (empty groups dropped). Group
    order is the scene's splat order: group i's splats precede group
    i+1's."""

    def __init__(self, groups):
        super().__init__()
        self.groups = nn.ModuleList(groups)

    @property
    def device(self) -> torch.device:
        return self.groups[0].device

    @property
    def n(self) -> int:
        return sum(g.n for g in self.groups)

    @property
    def sh_degree(self) -> int:
        return max(g.sh_degree for g in self.groups)

    @property
    def band_counts(self) -> tuple:
        """Splats per group."""
        return tuple(g.n for g in self.groups)

    def to_gaussians(self) -> Gaussians:
        """One zero-padded Gaussians at the highest degree (differentiable
        back to the groups unless made under torch.no_grad())."""
        out = self.groups[0].with_sh_degree(self.sh_degree)
        for g in self.groups[1:]:
            out = out.concat(g)
        return out

    @staticmethod
    def from_groups(groups) -> "BandedGaussians":
        gs = [g for g in groups if g.n > 0]
        if not gs:
            raise ValueError("BandedGaussians needs at least one splat")
        return BandedGaussians(gs)

    def sh_bytes(self) -> int:
        """The SH storage actually held (no zero padding)."""
        return sum(g.sh.numel() * g.sh.element_size() for g in self.groups)


def project_banded(bg: BandedGaussians, cam, cfg):
    """ProjectedSplats over all groups, each group projected at its own
    SH degree, concatenated in group order."""
    from gsjax_torch.render.project import project

    parts = [project(g, cam, cfg) for g in bg.groups]
    if len(parts) == 1:
        return parts[0]
    return dataclasses.replace(parts[0], **{
        f.name: torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(parts[0])})
