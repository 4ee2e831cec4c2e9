"""gsjax_torch parity: the flat backend's slot tables, slot gather and
the gather's VJP against gsjax/render/pallas_flat.py's non-Pallas
functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax.render import pallas_flat as jflat
from gsjax_torch.render import flat

from test_torch_flat_common import CHUNK, K, _pairs, _starts


@pytest.mark.parametrize("case", ["empty_tiles", "multiples", "pair_cap"])
def test_slot_tables_match_gsjax(case):
    starts = _starts(case)
    ncb = int(starts[-1]) // CHUNK + starts.shape[0]  # S // chunk + T + 1
    # jitted: one compile instead of one per eager op
    want = jax.jit(jflat._slot_tables, static_argnums=(1, 2))(jnp.asarray(starts), CHUNK, ncb)
    got = flat.slot_tables(torch.from_numpy(starts), CHUNK, ncb)
    for name, a, b in zip(("tile_of", "win", "cbase", "valid_count"), want, got):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_chunked_pair_attrs_match_gsjax():
    att, pid, starts = _pairs(np.random.default_rng(0))
    want = jax.jit(lambda a, p, s: jflat.chunked_pair_attrs(
        a, p, s, gsjax.RenderConfig(chunk=CHUNK), K))(jnp.asarray(att), jnp.asarray(pid),
                                                       jnp.asarray(starts))
    got = flat.chunked_pair_attrs(torch.from_numpy(att), torch.from_numpy(pid),
                                  torch.from_numpy(starts), gt.RenderConfig(chunk=CHUNK), K)
    for name, a, b in zip(("att_al", "tile_of", "cbase"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_gather_pair_attrs_vjp_matches_gsjax():
    rng = np.random.default_rng(1)
    att, pid, starts = _pairs(rng)
    n = att.shape[0]
    # pid_al as chunked_pair_attrs builds it (the slot tables are tested above)
    ncb = pid.shape[0] // CHUNK + starts.shape[0]
    _, win, _, valid = flat.slot_tables(torch.from_numpy(starts), CHUNK, ncb)
    lane = np.arange(CHUNK)
    pid_pad = np.concatenate([pid, np.zeros(CHUNK, np.int32)])
    pid_al = np.where(lane < valid.numpy()[:, None], pid_pad[win.numpy()[:, None] + lane],
                      n * K).astype(np.int32)
    att_pad = np.concatenate([att, np.zeros((1, 9), np.float32)])
    ct = rng.normal(size=(ncb, CHUNK, 9)).astype(np.float32)

    @jax.jit
    def gather_and_vjp(a, p, c):
        out, vjp = jax.vjp(lambda x: jflat.gather_pair_attrs(x, p, K), a)
        return out, vjp(c)[0]

    out_j, d_j = gather_and_vjp(jnp.asarray(att_pad), jnp.asarray(pid_al), jnp.asarray(ct))
    a_t = torch.from_numpy(att_pad).requires_grad_()
    out_t = flat.gather_pair_attrs(a_t, torch.from_numpy(pid_al), K)
    out_t.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    d_j = np.asarray(d_j)
    assert np.abs(d_j[:-1]).max() > 0 and not d_j[-1].any()
    np.testing.assert_allclose(a_t.grad.numpy(), d_j, rtol=1e-6, atol=1e-6 * np.abs(d_j).max())
