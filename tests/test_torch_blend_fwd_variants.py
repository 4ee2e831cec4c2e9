"""gsjax_torch: the forward variants tools/blend_fwd_variants builds edit
csrc/blend.cuh as each one says."""

import os

import pytest

from gsjax_torch import kernels
from gsjax_torch.render import stream
from gsjax_torch.tools import blend_fwd_variants


@pytest.mark.parametrize("variant", blend_fwd_variants.VARIANTS.split(","))
def test_blend_fwd_variants_edit_the_kernel(variant):
    """Each variant the tool builds by default edits blend.cuh as it says
    (every edit matched as often as it expects), and only the shipped
    mapping with no ablation leaves it unchanged."""
    with open(os.path.join(kernels.CSRC, "blend.cuh")) as fh:
        src = fh.read()
    out = blend_fwd_variants.variant_source(variant, src)
    assert (out == src) == (variant == f"{stream.FWD_PIXELS}x{stream.FWD_WARP_W}")
    grouping = (blend_fwd_variants.BASELINE if variant == "baseline" else variant).split("+")
    pixels, width = grouping[0].split("x")
    assert f"constexpr int kFwdPixels = {pixels};" in out
    assert f"constexpr int kFwdWarpW = {width};" in out
    assert ("stage_warp_masks(sh, smask" in out) == ("no-cull" not in grouping)
    assert ("running = __any_sync" in out) == ("no-stop" not in grouping)
