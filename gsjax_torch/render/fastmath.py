"""`fexp` — the PyTorch counterpart of gsjax/render/fastmath.py.

exp(x) for x ≤ 0 as 2^(x·log2 e): the exponent is assembled in the float's
exponent field and the fraction goes through the Cephes degree-5 exp2
polynomial, op for op as in the reference, so the blend's alpha is the
reference's alpha. The CUDA blend kernel carries the same sequence
(csrc/common.cuh::fexp); the library exp would round differently.
Its gradient is the exact d exp = exp·dx, as in the reference.
"""

from __future__ import annotations

import torch

_LOG2E = 1.4426950408889634
# Cephes 2^f on [0, 1), degree 5, Horner order (constant term last)
_C5 = 1.53720378e-4
_C4 = 1.33903821e-3
_C3 = 9.61817999e-3
_C2 = 5.55036562e-2
_C1 = 2.40226507e-1
_C0 = 6.93147182e-1


def _fexp_poly(x: torch.Tensor) -> torch.Tensor:
    y = torch.clamp(x, min=-87.0) * _LOG2E  # ∈ [-126, 0]
    n = torch.floor(y)
    f = y - n  # ∈ [0, 1)
    p = f * _C5 + _C4
    p = p * f + _C3
    p = p * f + _C2
    p = p * f + _C1
    p = p * f + _C0
    poly = p * f + 1.0
    # 2^n via exponent-field assembly; n ∈ [-126, 0] so no denormal edge
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return poly * two_n


class _FExp(torch.autograd.Function):
    """The polynomial forward with the exact derivative d fexp(x) =
    fexp(x)·dx (the reference's custom JVP): autograd through the floor
    and the bitcast would give 0."""

    @staticmethod
    def forward(ctx, x):
        y = _fexp_poly(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return dy * y


def fexp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for float32 x ≤ 0 (clamped to [-87, 0]), max relative error
    ~8e-6; differentiable, with the exact derivative fexp(x)."""
    return _FExp.apply(x)
