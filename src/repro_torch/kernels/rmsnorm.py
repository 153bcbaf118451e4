"""K6 — RMSNorm over the last dim: ``y = x · rsqrt(mean(x²) + eps) · g``.

Port of ``repro/kernels/rmsnorm.py::rmsnorm_pallas``. In the port it is
the RMSNorm of every transformer block (``models/layers.rms_norm``), so
one forward or one decode step launches it 2·L + 1 times.

One semantic choice, made by the flag ``round_before_gain`` (a template
parameter of the kernel):

* ``False`` — ``cast(x_f32 · r · g_f32)``, one rounding to x's dtype:
  what ``rmsnorm_pallas`` computes; held against it in the tests;
* ``True`` — ``cast(cast(x_f32 · r) · g)``, rounded to x's dtype before
  the gain too: what the reference model's ``rms_norm`` computes, and
  what ``layers.rms_norm`` launches, so the served model computes what
  the JAX model computes.

In float32 the two are the same chain. The reduction is float32 in both.

``rmsnorm_cuda`` launches the kernel (``csrc/rmsnorm.cu``: one 256-thread
block per row, 16-byte loads, float32 sum of squares by warp shuffles,
``__frsqrt_rn``) on CUDA tensors and counts the launch in ``LAUNCHES``.
The kernel is busy about 3 µs a launch at the LM prefill's 1024 bfloat16
rows of 2048 on an H100, so the wrapper's host time is the cost to keep
down: one pass of checks, no reshape or copy for contiguous operands
(the kernel takes x as numel / D rows of D), one allocation, and the
shared lean launch path of ``kernels.build``.
``rmsnorm_plain`` repeats the kernel's float32 chain step by step in
plain torch (the same order of the sum of squares, a correctly rounded
``rsqrt``), so the two agree bit for bit; it runs on the CPU and is the
kernel's reference on the card. ``kernels.ref.rmsnorm_ref`` is the
oracle: the same function with torch's own reduction order.
"""
from __future__ import annotations

import torch

from . import build
from .ref import rmsnorm_ref

__all__ = ["LAUNCHES", "rmsnorm_cuda", "rmsnorm_plain"]

LAUNCHES = {"rmsnorm": 0}


def _check(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() < 1 or g.dim() != 1 or g.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm takes x [..., D] and g [D]; got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if g.dtype != x.dtype:
        raise TypeError(f"rmsnorm gain dtype {g.dtype} != x dtype {x.dtype}")


_THREADS = 256  # the kernel's block: one row per block


def _kernel_r(x2: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's r = rsqrt(mean(x²) + eps) per row of x2 [R, D], float32,
    formed in the kernel's order: thread t of 256 folds the squares of its
    n = 16 / element_size elements per step (step s: elements s·256·n +
    t·n + i), the 8 warps fold their 32 lanes by xor butterflies (16, 8,
    4, 2, 1), the 8 warp sums are added in order, divided by D, eps added,
    and the reciprocal square root rounded once (here through float64).
    Every step is one float32 rounding, as in the kernel."""
    rows, d = x2.shape
    n = 16 // x2.element_size()
    f32 = dict(dtype=torch.float32, device=x2.device)
    span = _THREADS * n
    steps = -(-d // span)
    xf = torch.zeros((rows, steps * span), **f32)  # zeros add nothing
    xf[:, :d] = x2.float()
    sq = (xf * xf).view(rows, steps, _THREADS, n)
    ss = torch.zeros((rows, _THREADS), **f32)
    for s in range(steps):
        for i in range(n):
            ss = ss + sq[:, s, :, i]
    lanes = ss.view(rows, _THREADS // 32, 32)
    lane = torch.arange(32, device=x2.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., lane ^ off]
    total = torch.zeros((rows,), **f32)
    for w in range(_THREADS // 32):
        total = total + lanes[:, w, 0]
    mean = total / torch.tensor(float(d), **f32)
    arg = mean + torch.tensor(eps, **f32)
    return (1.0 / torch.sqrt(arg.double())).float()[:, None]


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5, *,
                  round_before_gain: bool = False) -> torch.Tensor:
    """The kernel's function in plain torch, step by step: the same float32
    chain as ``csrc/rmsnorm.cu``, so the two give the same bits. Dtypes the
    kernel does not take (float64) get the oracle ``rmsnorm_ref``."""
    _check(x, g)
    if x.dtype not in (torch.float32, torch.bfloat16):
        return rmsnorm_ref(x, g, eps, round_before_gain=round_before_gain)
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    y = x2.float() * _kernel_r(x2, eps)
    if round_before_gain:
        y = y.to(x.dtype).float()
    return (y * g.float()).to(x.dtype).reshape(x.shape)


def rmsnorm_cuda(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5, *,
                 round_before_gain: bool = False) -> torch.Tensor:
    """The K6 kernel on the card: x [..., D], g [D] -> y like x. Only a
    strided x or g is copied (made contiguous) first."""
    if not (x.is_cuda and g.device == x.device):
        raise ValueError("rmsnorm_cuda needs x and g on one CUDA device")
    _check(x, g)
    code = build.dtype_code(x.dtype, "rmsnorm")
    if not x.is_contiguous():
        x = x.contiguous()
    if not g.is_contiguous():
        g = g.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    d = g.shape[0]
    rc = build.library().repro_rmsnorm(
        x.data_ptr(), g.data_ptr(), out.data_ptr(), n // d, d, eps, code,
        round_before_gain, build.stream_of(x))
    build.check(rc, "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return out
