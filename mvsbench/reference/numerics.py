"""The precision the plain reference computes in.

The reference computes in float32 with TF32 off. Its control computes the
same graph one precision lower: every tensor the network passes on is
rounded to ``dtype`` (bfloat16, or float8 e4m3 with a per-tensor scale that
maps the tensor's largest magnitude to the format's largest finite value):
each convolution's input, weight and output, each normalisation's and
nonlinearity's output, every recurrent state and sum, the sweeps' features
and volumes, stage 1's probabilities; and so is each gradient that flows
back through a rounding point. Each op computes in float32 between its
rounded inputs and its rounded output, as a lower-precision kernel
accumulates in float32. The depth regressions and the losses stay float32,
as the port keeps them in its lower-precision forms.
"""

from __future__ import annotations

import contextlib

import torch

_F8 = torch.float8_e4m3fn
_F8_MAX = 448.0


def round_to(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to its own dtype (``x`` itself
    for None)."""
    if dtype is None:
        return x
    if dtype == _F8:
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = _F8_MAX / amax
        return ((x.float() * scale).to(_F8).float() / scale).to(x.dtype)
    return x.to(dtype).to(x.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return round_to(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.dtype), None


class Numerics:
    """Where the reference rounds: ``q(x)`` at each rounding point; ``dtype``
    None is float32 throughout."""

    def __init__(self, dtype: torch.dtype | None = None):
        self.dtype = dtype

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        return _Round.apply(x, self.dtype)


FLOAT32 = Numerics()

CONTROL_DTYPES = {"float8_e4m3fn": _F8, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matmuls and cuDNN convolutions while the reference
    runs, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
