"""gsjax_torch: kernel F's plain version against autograd of the forward,
and the flat and stream plain paths on one scene."""

import numpy as np
import pytest
import torch

from gsjax_torch.render import flat
from gsjax_torch.render.stream import blend_stream

from test_torch_flat_common import K, _cotangents, _scene_inputs


@pytest.mark.parametrize("name", ["thin", "fat", "fat_eps0.05", "fat_eps0.2"])
def test_slots_backward_matches_autograd_of_forward(name):
    """Kernel F's plain version (the hand-derived VJP, replayed in the
    forward's order) against autograd through kernel E's plain version,
    with random cotangents on both outputs (ct_T reaches the ct_T·T_act
    term); test_torch_train.py's bounds for the stream backward. The fat
    scene runs also with transmittance_eps raised to 0.05 and 0.2, where
    many pixels end near T ≈ eps."""
    att, pid, starts, bins, cfg = _scene_inputs(name)
    att_al, tile_of, cbase = flat.chunked_pair_attrs(att, pid, starts, cfg, K)
    att_al = att_al.detach().requires_grad_()
    args = (starts, cbase, tile_of, 0)
    out = flat.slots_forward_plain(att_al, *args, bins.tiles_x, bins.band_rows, cfg)
    if "_eps" in name:  # many pixels terminate
        assert float((out[:, 4] < cfg.transmittance_eps).float().mean()) > 0.3
    ct_img, ct_T = _cotangents(out.shape[0])
    (d_auto,) = torch.autograd.grad(
        (out[:, 0:3].transpose(1, 2) * ct_img).sum() + (out[:, 3] * ct_T).sum(), att_al)
    d = flat.slots_backward(att_al.detach(), *args, out.detach(), ct_img, ct_T,
                            bins.tiles_x, bins.band_rows, cfg)
    assert d.shape == att_al.shape
    d, d_auto = d.view(-1, 9), d_auto.view(-1, 9)
    peak = d_auto.abs().amax(dim=0) + 1e-12
    rel = ((d - d_auto).abs() / peak).numpy()
    assert (d_auto.abs().amax(dim=0) > 0).all()
    assert np.percentile(rel, 99.9) < 1e-4, np.percentile(rel, 99.9, axis=0)
    assert rel.max() < 1e-2, rel.max(axis=0)


def test_flat_matches_stream_plain_paths():
    """One scene through both backends' plain paths: the same blend over
    the same pairs, so the image and the home-row gradients (after the
    slot gather's VJP) agree."""
    att, pid, starts, bins, cfg = _scene_inputs("thin")
    ct_img, ct_T = _cotangents(bins.tiles_x * bins.band_rows, seed=5)
    res = []
    for backend in ("stream", "pallas"):
        a = att.detach().requires_grad_()
        if backend == "stream":
            img, T = blend_stream(a, pid, starts, 0, bins.tiles_x, cfg)
        else:
            att_al, tile_of, cbase = flat.chunked_pair_attrs(a, pid, starts, cfg, K)
            img, T = flat.blend_slots(att_al, starts, cbase, tile_of, 0, bins.tiles_x,
                                      bins.band_rows, cfg)
        ((img * ct_img).sum() + (T * ct_T).sum()).backward()
        res.append((img.detach(), T.detach(), a.grad))
    (img_s, T_s, d_s), (img_f, T_f, d_f) = res
    assert float((img_f - img_s).abs().max()) <= 1e-6
    assert float((T_f - T_s).abs().max()) <= 1e-6
    peak = d_s.abs().amax(dim=0)
    assert (peak > 0).all()
    assert float(((d_f - d_s).abs() / peak).max()) <= 1e-6
