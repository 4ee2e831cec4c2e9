"""The card's peaks, the least time a piece of work can take on it, and
the work counts that more than one per-layer metric reads.

NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 3.35 TB/s of
HBM, 67 TFLOP/s in float32 outside the tensor cores (the port computes
in float32 and uses no tensor core)."""

from gsbench import harness

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def share(least_s: float, taken_s: float):
    """least / taken in %, or None where nothing was timed."""
    if taken_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / taken_s


# kernel C (blend_fwd_kernel), per unit of work counted by the reference
# (gsbench/reference, averaged over the window's units): per pair-pixel
# where the pair is eligible (α ≥ α_min, power ≤ 0) before the pixel
# stopped, FWD_OPS_LIVE operations (the quadratic, exp, α, the tests, the
# transmittance); per included pair-pixel FWD_OPS_INCLUDED more (the
# weight and the colour sums). Bytes: each used attribute row read once,
# each pair's id once, each pixel's colour and transmittance written once.
FWD_KERNELS = ("blend_fwd_kernel",)
FWD_OPS_LIVE = 39
FWD_OPS_INCLUDED = 6
ATT_BYTES = 9 * 4
# kernel D's backward blend: the forward's decisions replayed per eligible
# live pair-pixel; v, U, dα, the nine gradients and their sums per
# included one
BWD_OPS_LIVE = 39
BWD_OPS_INCLUDED = 46

# projection and SH colour per splat, forward (gsbench/reference/render.
# project: camera transform 18, Jacobian 12, T 18, rotation 30, M and its
# exp 15, A 30, covariance 12, conic and radius 20, mean 6, culls 10,
# sigmoid 4, view direction 11); the SH basis for K = 1, 4, 9, 16
# coefficients, and 6 per coefficient for its sum
PROJ_FWD = 18 + 12 + 18 + 30 + 15 + 30 + 12 + 20 + 6 + 10 + 4 + 11
SH_BASIS = {1: 1, 4: 7, 9: 22, 16: 45}


def blend_fwd_share(art):
    """Kernel C's share of its roofline in %, per unit of the traced
    window, or None where C did not run."""
    w, units = art["work"], art["units"]
    taken = harness.kernel_seconds(art, FWD_KERNELS) / units if units else 0.0
    n_bytes = w["rows"] * ATT_BYTES + w["pairs"] * 4 + w["pixels"] * 16
    n_ops = FWD_OPS_LIVE * w["pp_live"] + FWD_OPS_INCLUDED * w["pp_included"]
    return share(least_seconds(n_bytes, n_ops), taken)


def projection_ops(w: dict) -> float:
    """The forward projection and SH colour of every splat of the scene."""
    k = int(w["sh_k"])
    return (PROJ_FWD + SH_BASIS[k] + 6 * k) * w["n_splats"]


def mfu(art, ops_per_unit: float):
    """ops_per_unit over (the traced window's mean unit × the float32
    peak), in %; None off the card."""
    if not art["units"] or not art["cuda"]:
        return None
    return 100.0 * ops_per_unit / (art["window_s"] / art["units"] * FP32_OPS_PER_S)
