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

**The backward** (no TPU kernel: the reference differentiates its jnp
``rms_norm`` through XLA). ``rmsnorm_bwd_cuda`` launches the kernel pair
of ``csrc/rmsnorm.cu`` — a block of 256 threads per ``BWD_ROWS`` rows,
row by row with the forward's layout (so r and the row sums fold in the
forward's order), each block's ``dg`` as one float32 partial row, then a
fold of the partial rows in ascending block order: no atomics, the same
bits every run — and counts the call in ``LAUNCHES["rmsnorm_bwd"]``.
``rmsnorm_bwd_plain`` repeats its chain in plain torch.
``kernels.ops.rmsnorm_op`` takes the pair under grad (``_RmsNorm``).
"""
from __future__ import annotations

import torch

from . import build
from .ref import rmsnorm_ref

__all__ = ["LAUNCHES", "rmsnorm_cuda", "rmsnorm_plain", "rmsnorm_bwd_cuda",
           "rmsnorm_bwd_plain"]

LAUNCHES = {"rmsnorm": 0, "rmsnorm_bwd": 0}


def _check(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() < 1 or g.dim() != 1 or g.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm takes x [..., D] and g [D]; got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if g.dtype != x.dtype:
        raise TypeError(f"rmsnorm gain dtype {g.dtype} != x dtype {x.dtype}")


_THREADS = 256  # the kernel's block: one row per block


def _chain_sum(terms: torch.Tensor, n: int) -> torch.Tensor:
    """Each row's sum of ``terms`` [R, D] (float32, each term already
    rounded) in the kernel's order: thread t of 256 folds the terms of its
    n = 16 / element_size elements per step (step s: elements s·256·n +
    t·n + i), the 8 warps fold their 32 lanes by xor butterflies (16, 8,
    4, 2, 1) and the 8 warp sums are added in order. Every step is one
    float32 rounding, as in the kernel. Returns [R] float32."""
    rows, d = terms.shape
    f32 = dict(dtype=torch.float32, device=terms.device)
    span = _THREADS * n
    steps = -(-d // span)
    tf = torch.zeros((rows, steps * span), **f32)  # zeros add nothing
    tf[:, :d] = terms
    tf = tf.view(rows, steps, _THREADS, n)
    ss = torch.zeros((rows, _THREADS), **f32)
    for s in range(steps):
        for i in range(n):
            ss = ss + tf[:, s, :, i]
    lanes = ss.view(rows, _THREADS // 32, 32)
    lane = torch.arange(32, device=terms.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., lane ^ off]
    total = torch.zeros((rows,), **f32)
    for w in range(_THREADS // 32):
        total = total + lanes[:, w, 0]
    return total


def _kernel_r(x2: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's r = rsqrt(mean(x²) + eps) per row of x2 [R, D], float32:
    the sum of squares in the kernel's order (``_chain_sum``), divided by
    D, eps added, and the reciprocal square root rounded once (here
    through float64). Returns [R, 1]."""
    f32 = dict(dtype=torch.float32, device=x2.device)
    xf = x2.float()
    total = _chain_sum(xf * xf, 16 // x2.element_size())
    mean = total / torch.tensor(float(x2.shape[1]), **f32)
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


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

BWD_ROWS = 8  # rows per thread block of the backward: one dg partial each
BWD_MAX_D = 12_288  # the block's float32 dg accumulators: 48 KB (opted in)


def _check_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor) -> None:
    _check(x, g)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm backward takes dy like x {tuple(x.shape)} "
                         f"{x.dtype}; got {tuple(dy.shape)} {dy.dtype}")


def _bwd_ref(x, g, dy, eps, round_before_gain):
    """The backward's formulas in x's own dtype (float64 on the float64
    reference runs), torch's own reduction order."""
    d = x.shape[-1]
    r = torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    xn = x * r
    if round_before_gain:
        xn = xn.to(x.dtype)
    dxn = dy * g
    dot = (dxn * x).sum(-1, keepdim=True)
    dx = r * dxn - x * (r * r * r) * (dot / d)
    return dx.to(x.dtype), (dy * xn).reshape(-1, d).sum(0).to(g.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-5, *, round_before_gain: bool = False
                      ) -> tuple:
    """The backward kernel's function in plain torch, step by step:
    ``(dx, dg)`` for ``y = rmsnorm(x, g)`` and the cotangent ``dy``, with
    the kernel's float32 chain (``csrc/rmsnorm.cu``): r and each row's
    ``Σ dxn·x`` in the forward's order (``_chain_sum``), ``dx = r·dxn −
    x·(r·r·r)·(Σ/D)``, and ``dg`` as ``BWD_ROWS``-row partials folded in
    ascending row order, then in ascending block order. Dtypes the kernel
    does not take (float64) get the same formulas in their own dtype."""
    _check_bwd(x, g, dy)
    if x.dtype not in (torch.float32, torch.bfloat16):
        return _bwd_ref(x, g, dy, eps, round_before_gain)
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    xf, dyf, gf = x2.float(), dy.reshape(-1, d).float(), g.float()
    r = _kernel_r(x2, eps)  # [R, 1]
    xn = xf * r
    if round_before_gain:
        xn = xn.to(x.dtype).float()
    dxn = dyf * gf
    dot = _chain_sum(dxn * xf, 16 // x.element_size())[:, None]
    c = ((r * r) * r) * (dot / torch.tensor(float(d), **f32))
    dx = (r * dxn - xf * c).to(x.dtype).reshape(x.shape)
    blocks = -(-rows // BWD_ROWS)
    prod = torch.zeros((blocks * BWD_ROWS, d), **f32)  # zeros add nothing
    prod[:rows] = dyf * xn
    prod = prod.view(blocks, BWD_ROWS, d)
    part = torch.zeros((blocks, d), **f32)
    for i in range(BWD_ROWS):
        part = part + prod[:, i]
    dg = torch.zeros((d,), **f32)
    for b in range(blocks):
        dg = dg + part[b]
    return dx, dg.to(g.dtype)


def rmsnorm_bwd_cuda(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5, *, round_before_gain: bool = False
                     ) -> tuple:
    """K6's backward on the card: ``(dx, dg)`` (x's and g's dtype) from x
    [..., D], g [D] and dy like x. Two launches of ``csrc/rmsnorm.cu`` (the
    rows, then the fold of the dg partials) counted as one call in
    ``LAUNCHES["rmsnorm_bwd"]``; D up to ``BWD_MAX_D``."""
    if not (x.is_cuda and g.device == x.device and dy.device == x.device):
        raise ValueError("rmsnorm_bwd_cuda needs x, g and dy on one CUDA "
                         "device")
    _check_bwd(x, g, dy)
    code = build.dtype_code(x.dtype, "rmsnorm_bwd")
    d = g.shape[0]
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd kernel takes D <= {BWD_MAX_D}, got {d}")
    x, g, dy = (t if t.is_contiguous() else t.contiguous() for t in (x, g, dy))
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return dx, torch.zeros_like(g)
    dg = torch.empty_like(g)
    partial = torch.empty((-(-rows // BWD_ROWS), d), dtype=torch.float32,
                          device=x.device)
    rc = build.library().repro_rmsnorm_bwd(
        x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dg.data_ptr(), rows, d, eps, code,
        round_before_gain, build.stream_of(x))
    build.check(rc, "rmsnorm_bwd")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dg
