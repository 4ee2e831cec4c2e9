"""gsjax_torch.tools — the Hopper counterparts of the four TPU probes G-J —
against the probes in tools/ on the CPU.

CPU tensors run each probe's plain PyTorch version (its wrapper picks it
by the tensor's device). Each is held to the probe's own Pallas kernel,
built here with interpret=True and a small grid from the probe's kernel,
_mk and specs, on the probe's inputs and on random ones from a numpy
seed (negative ints included, for jnp's floor division and modulo), and
J also on its edge inputs (int32 extremes, window offsets 0 and 127).
Where the probe's output is undefined — I's `reduce` does not trace, H's
staging ring and J's scatter3 scratch are never zeroed — the plain
version is held to a numpy statement of what the probe computes."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gsjax_torch.tools import probe_chunk as tchunk
from gsjax_torch.tools import probe_compact as tcompact
from gsjax_torch.tools import probe_mosaic as tmosaic
from gsjax_torch.tools import probe_scalars as tscalars

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_probe(name):
    """tools/<name>.py, imported by path (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_tpu_{name}", os.path.join(_ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jmosaic = _load_probe("probe_mosaic")
jscalars = _load_probe("probe_scalars")
jchunk = _load_probe("probe_chunk")
jcompact = _load_probe("probe_compact")


# --- G: probe_mosaic ---------------------------------------------------------

def _mosaic_reference(x):
    o, s = pl.pallas_call(
        jmosaic.kernel,
        out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.int32),
                   jax.ShapeDtypeStruct((1,), jnp.int32)],
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                   pl.BlockSpec(memory_space=pltpu.SMEM)],
        scratch_shapes=[pltpu.VMEM((8, jmosaic.CAP), jnp.int32)],
        interpret=True,
    )(jnp.asarray(x))
    return np.asarray(o)[3], np.asarray(s)  # the probe writes row t = 3 only


def _mosaic_input(kind):
    cap = jmosaic.CAP
    if kind == "probe":
        return np.arange(8 * cap, dtype=np.int32).reshape(8, cap)
    rng = np.random.default_rng(11)
    if kind == "random":  # negative ints: floor modulo of the roll and slice
        x = rng.integers(-2**31, 2**31, (8, cap), dtype=np.int64).astype(np.int32)
        x[0, 0], x[0, 2] = -1234567, -77
        return x
    x = rng.integers(-5000, 5000, (8, cap)).astype(np.int32)
    x[0, 0], x[0, 2] = 300, 5  # the slice: lanes 640..767 of row 3 of y
    y3 = np.roll(x, 300, 1)[3]
    if kind == "exit_at_once":  # max(col) ≥ 1e9: the loop never runs
        y3[650] = 10**9
    else:  # "exit_after_one": one add takes max(acc) to 1.2e9
        y3[700] = 6 * 10**8
    x[3] = np.roll(y3, -300)
    return x


@pytest.mark.parametrize("kind", ["probe", "random", "exit_at_once", "exit_after_one"])
def test_mosaic_matches_probe(kind):
    x = _mosaic_input(kind)
    o_ref, s_ref = _mosaic_reference(x)
    o, s = tmosaic.probe_mosaic(torch.from_numpy(x))
    np.testing.assert_array_equal(o.numpy(), o_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)


# --- I: probe_scalars --------------------------------------------------------

G_I = 16


def _scalars_inputs(kind):
    if kind == "probe":
        stab, rows = tscalars.probe_inputs(G_I, "cpu")
        return stab.numpy(), rows.numpy()
    rng = np.random.default_rng(12)
    stab = rng.integers(-2**31, 2**31, 6 * G_I, dtype=np.int64).astype(np.int32)
    rows = rng.integers(-2**31, 2**31, (G_I, tscalars.LANES), dtype=np.int64).astype(np.int32)
    rows[:, :128] = rng.integers(-300, 300, (G_I, 128))  # reduce's ids: classes mod 3
    rows[3, :128] = 3 * rng.integers(-40, 40, 128)  # a block with classes 1, 2 empty
    return stab, rows


def _scalars_reference(variant, stab, rows):
    """Every step's o[0, 0]: the probe's kernel and in_specs, with the
    output block indexed by step (the probe's own spec keeps only the
    last step's, out[G − 1])."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(G_I,),
        in_specs=[pl.BlockSpec((1, jscalars.LANES), lambda j, st: (j, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 128), lambda j, st: (j, 0), memory_space=pltpu.VMEM),
    )
    o = pl.pallas_call(jscalars._mk(variant), grid_spec=grid_spec,
                       out_shape=jax.ShapeDtypeStruct((G_I, 128), jnp.int32),
                       interpret=True)(jnp.asarray(stab), jnp.asarray(rows))
    return np.asarray(o)[:, 0]


@pytest.mark.parametrize("kind", ["probe", "random"])
@pytest.mark.parametrize("variant", ["base", "smem", "vmem"])
def test_scalars_match_probe(variant, kind):
    stab, rows = _scalars_inputs(kind)
    out = tscalars.probe_scalars(variant, torch.from_numpy(stab), torch.from_numpy(rows))
    np.testing.assert_array_equal(out.numpy(), _scalars_reference(variant, stab, rows))
    if kind == "probe" and variant != "base":  # the probe's printed o[0, 0]
        assert int(out[-1]) == {"smem": sum(range(6 * G_I - 6, 6 * G_I)),
                                "vmem": sum(range(248, 254))}[variant]


def test_scalars_reduce_does_not_trace_in_the_probe():
    """The reference fault the port does not copy: `rows_ref[0]` is 1-D,
    so `raw[:, :CHUNK]` raises (tools/probe_scalars.py:37-38)."""
    stab, rows = _scalars_inputs("probe")
    with pytest.raises(IndexError):
        _scalars_reference("reduce", stab, rows)


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_scalars_reduce_matches_intent(kind):
    """reduce: per block, six masked reductions over its first 128 ids —
    min and max of the ids ≡ r (mod 3), r = 0, 1, 2 (2^30 and −1 for an
    empty class) — summed with int32 wrap-around."""
    stab, rows = _scalars_inputs(kind)
    ids = rows[:, :128].astype(np.int64)
    want = np.zeros(G_I, np.int64)
    for r in range(3):
        m = np.mod(ids, 3) == r
        want += np.where(m, ids, 2**30).min(axis=1) + np.where(m, ids, -1).max(axis=1)
    want = want.astype(np.int32)  # numpy's int64 → int32 cast wraps
    out = tscalars.probe_scalars("reduce", torch.from_numpy(stab), torch.from_numpy(rows))
    np.testing.assert_array_equal(out.numpy(), want)


# --- J: probe_chunk ----------------------------------------------------------

G_J = 4


def _chunk_inputs(kind):
    """[(rows [8, 256] int32, band [128, 512] float32 holding bf16 values)]:
    the probe's own, probe_chunk.random_inputs (negative ids, a dyadic
    band whose gather sums are exact in f32 in any order, values the
    probe writes that are not 0) or probe_chunk.edge_inputs' two (ids at
    the int32 extremes and at offsets 0 and 127 of each class row's
    window, flatgather descriptors with bit 31 set, the same kind of
    band; pair 0, whose elements the gathers write, in a low window in
    the first and the id I32_MIN in the lowest window in the second)."""
    if kind == "edge":
        made = tchunk.edge_inputs("cpu")
    else:
        made = [{"probe": tchunk.probe_inputs, "random": tchunk.random_inputs}[kind]("cpu")]
    return [(rows.numpy(), band.float().numpy()) for rows, band in made]


def _chunk_reference(variant, rows, band):
    """The probe's o[0, 0] after G_J steps (every step writes it)."""
    o = pl.pallas_call(
        jchunk._mk(variant), grid=(G_J,),
        in_specs=[pl.BlockSpec((8, jchunk.LANES), lambda j: (0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((jchunk.CHUNK, 512), lambda j: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 128), lambda j: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((16, 512), jnp.float32)],
        interpret=True,
    )(jnp.asarray(rows), jnp.asarray(band, dtype=jnp.bfloat16))
    return float(np.asarray(o)[0, 0])


def _scatter3_intent(rows):
    """scatter3 with its scratch zeroed: scr[0, 0] = 2 × the number of
    pairs i of class row 0 (crow = (id mod 9) // 3 = 0) whose sid = id // 9
    equals the first lane of class row 0's window, (sid[0] // 128)·128."""
    ids = rows[0, :128].astype(np.int64)
    sid = np.floor_divide(ids, 9)
    crow = np.floor_divide(ids - sid * 9, 3)
    base = sid[0] // 128 * 128
    return 2.0 * np.sum((crow == 0) & (sid == base))


@pytest.mark.parametrize("kind", ["probe", "random", "edge"])
@pytest.mark.parametrize("variant", tchunk.VARIANTS)
def test_chunk_matches_probe(variant, kind):
    for rows, band in _chunk_inputs(kind):
        out = tchunk.probe_chunk(variant, torch.from_numpy(rows),
                                 torch.from_numpy(band).to(torch.bfloat16), g=G_J)
        assert out.shape == (G_J, 2) and out.dtype == torch.float32
        if variant == "base":
            np.testing.assert_array_equal(out.numpy(), np.repeat(np.arange(G_J), 2)
                                          .reshape(G_J, 2).astype(np.float32))
        else:  # every block computes the same chunk
            assert torch.equal(out, out[:1].expand(G_J, 2))
        v = float(out[-1, 0])
        if variant == "scatter3":  # the probe reads scratch it never zeroed (NaN)
            assert v == _scatter3_intent(rows)
            continue
        want = _chunk_reference(variant, rows, band)
        if variant in tchunk.FLOAT_SUMS:
            assert abs(v - want) <= tchunk.VALUE_RTOL * abs(want), (v, want)
        else:
            assert v == want, (v, want)


# --- H: probe_compact --------------------------------------------------------

NH_H = 4096


def _prefix_reference(alive):
    """probe_compact._prefix_lanes on [n, 128] 0/1 rows, in a one-step
    interpret kernel (the helper broadcasts over rows)."""
    def kernel(x_ref, o_ref):
        o_ref[...] = jcompact._prefix_lanes(x_ref[...])

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(alive.shape, jnp.int32),
        interpret=True)(jnp.asarray(alive)))


@pytest.mark.parametrize("kind", ["probe", "random"])
@pytest.mark.parametrize("classes", [1, 3, 9])
def test_compact_matches_position_arithmetic(classes, kind):
    """Entry fill + pref − 1 for each alive lane, fill summing the totals
    (max of the inclusive prefix) of every (subgroup, class) before, in
    the probe's order (tools/probe_compact.py:67-78)."""
    rng = np.random.default_rng(14 + classes)
    if kind == "probe":
        mask = np.full(NH_H, tcompact.PROBE_MASK, np.int32)
    else:
        mask = rng.integers(-2**31, 2**31, NH_H, dtype=np.int64).astype(np.int32)
        mask[:128] = 0  # an empty subgroup
    vals = rng.normal(size=(8, NH_H)).astype(np.float32)
    ng = NH_H // 128
    alive = ((mask.reshape(ng, 1, 128) >> np.arange(classes)[None, :, None]) & 1)
    pref = _prefix_reference(alive.reshape(ng * classes, 128).astype(np.int32))
    want = np.zeros((8, NH_H * classes), np.float32)
    fill = 0
    for k in range(ng * classes):
        a = alive.reshape(-1, 128)[k] > 0
        pos = fill + pref[k] - 1
        want[:, pos[a]] = vals[:, (k // classes) * 128 + np.nonzero(a)[0]]
        fill += int(pref[k].max())
    stream, count = tcompact.probe_compact(torch.from_numpy(mask.reshape(1, NH_H)),
                                           torch.from_numpy(vals), classes)
    assert stream.shape == (8, NH_H * classes) and count.dtype == torch.int32
    assert int(count[0]) == fill
    np.testing.assert_array_equal(stream[:, :fill].numpy(), want[:, :fill])


# --- the entry points --------------------------------------------------------

@pytest.mark.parametrize("module,argv", [
    (tmosaic, []), (tscalars, []), (tchunk, ["alpha,maskwalk"]),
    (tcompact, ["--nh", "4096"]),
])
def test_probe_entry_points_run_on_cpu(module, argv, capsys):
    module.main(["--device", "cpu", "--reps", "1", *argv])
    out = capsys.readouterr().out
    assert "host-clock" in out and "ms" in out


def test_probe_empty_raises_on_cpu():
    """The empty launch measures the card's launch floor: it has no plain
    version, so a CPU tensor raises and nothing is counted."""
    from gsjax_torch import kernels
    from gsjax_torch.tools import probe_empty

    kernels.reset_launches()
    with pytest.raises(ValueError, match="probe_empty"):
        probe_empty(torch.zeros(1, dtype=torch.int32), 1, 32)
    assert kernels.LAUNCHES["probe_empty"] == 0
