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

``rmsnorm_cuda`` launches the kernel (``csrc/rmsnorm.cu``) on CUDA
tensors and counts the launch in ``LAUNCHES``. Rows run in parallel: a
row on a group of at least ``_fwd_layout``'s lanes (32 to 256, each lane
holding at most four 16-byte chunks of the row, the same columns in
every row; the launch doubles them for few rows), read once into
registers; the sum of squares keeps the chain of one 256-thread block a
row (each lane keeps one sum for each of the block's threads it stands
for, one xor butterfly per warp of that block, the 8 warp sums in
order), so the bits do not depend on the lanes. Rows wider than the
lanes hold, and rows without 16-byte access (a width not a multiple of
16 bytes, an unaligned view), take one 256-thread block a row.
The kernel is busy about 3 µs a launch at the LM prefill's 1024 bfloat16
rows of 2048 on an H100, so the wrapper's host time is the cost to keep
down: one pass of checks, no reshape or copy for contiguous operands
(the kernel takes x as numel / D rows of D), one allocation (y's; r
under grad comes from a batch, ``_new_r``), and the shared lean launch
path of ``kernels.build``.
``rmsnorm_plain`` repeats the kernel's float32 chain step by step in
plain torch (the same order of the sum of squares, a correctly rounded
``rsqrt``), so the two agree bit for bit; it runs on the CPU and is the
kernel's reference on the card. ``kernels.ref.rmsnorm_ref`` is the
oracle: the same function with torch's own reduction order.

Under grad the forward also returns r = rsqrt(mean(x²) + eps), one
float32 a row (``return_r=True``: the kernel stores it where the wrapper
passes a pointer; ``rmsnorm_plain`` returns ``_kernel_r``'s), and the
backward reads it instead of summing the squares again.

**The backward** (no TPU kernel: the reference differentiates its jnp
``rms_norm`` through XLA). ``rmsnorm_bwd_cuda`` launches the kernel pair
of ``csrc/rmsnorm.cu`` — rows in parallel: a row on a group of
``lanes`` threads (``_bwd_layout``: 32 to 256, each lane holding at most
four 16-byte chunks of the row, the same columns in every row, so its
slice of g and its ``dg`` sums stay in registers), 256 / lanes rows at
once in a block of 256 threads over a contiguous chunk of rows, x and dy
read once; each block's ``dg`` as one float32 partial row (its groups'
sums added in group order), then a fold of the partial rows in ascending
block order: no atomics, the same bits every run — and counts the call
in ``LAUNCHES["rmsnorm_bwd"]``. Without a saved r it forms r in the
forward's chain first (the forward's kernel, in the same call).
``rmsnorm_bwd_plain`` repeats its chain in plain torch.
``kernels.ops.rmsnorm_op`` takes the pair under grad (``_RmsNorm``).
"""
from __future__ import annotations

import functools

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


_THREADS = 256  # the kernels' block: the forward's one row, the backward's
# 256 / lanes rows


def _chain_sum(terms: torch.Tensor, n: int,
               threads: int = _THREADS) -> torch.Tensor:
    """Each row's sum of ``terms`` [R, D] (float32, each term already
    rounded) in the kernels' order: lane t of ``threads`` (the forward:
    one 256-thread block a row; the backward: a group of ``lanes``) folds
    the terms of its n = 16 / element_size elements per step (step s:
    elements s·threads·n + t·n + i), each warp folds its 32 lanes by xor
    butterflies (16, 8, 4, 2, 1) and the warp sums are added in order
    from 0. Every step is one float32 rounding, as in the kernels.
    Returns [R] float32."""
    rows, d = terms.shape
    f32 = dict(dtype=torch.float32, device=terms.device)
    span = threads * n
    steps = -(-d // span)
    tf = torch.zeros((rows, steps * span), **f32)  # zeros add nothing
    tf[:, :d] = terms
    tf = tf.view(rows, steps, threads, n)
    ss = torch.zeros((rows, threads), **f32)
    for s in range(steps):
        for i in range(n):
            ss = ss + tf[:, s, :, i]
    lanes = ss.view(rows, threads // 32, 32)
    lane = torch.arange(32, device=terms.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., lane ^ off]
    total = torch.zeros((rows,), **f32)
    for w in range(threads // 32):
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


def _ref_r(x: torch.Tensor, eps: float) -> torch.Tensor:
    """r for dtypes the kernels do not take (float64): x's own dtype,
    torch's reduction order, as ``rmsnorm_ref`` and ``_bwd_ref``."""
    return torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5, *,
                  round_before_gain: bool = False, return_r: bool = False):
    """The kernel's function in plain torch, step by step: the same float32
    chain as ``csrc/rmsnorm.cu``, so the two give the same bits. Dtypes the
    kernel does not take (float64) get the oracle ``rmsnorm_ref``. With
    ``return_r``: ``(y, r)``, r [...] float32 (the backward's;
    ``_kernel_r``)."""
    _check(x, g)
    d = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        y = rmsnorm_ref(x, g, eps, round_before_gain=round_before_gain)
        return (y, _ref_r(x, eps)[..., 0]) if return_r else y
    x2 = x.reshape(-1, d)
    r = _kernel_r(x2, eps)
    y = x2.float() * r
    if round_before_gain:
        y = y.to(x.dtype).float()
    y = (y * g.float()).to(x.dtype).reshape(x.shape)
    return (y, r.reshape(x.shape[:-1])) if return_r else y


HELD = 4  # 16-byte chunks of a row one lane holds in registers


@functools.lru_cache(maxsize=None)
def _fwd_layout(d: int, element_size: int) -> int:
    """The lanes a row of ``d`` elements of ``element_size`` bytes goes
    to: the smallest power of two from 32 to 256 whose lanes hold it in
    at most ``HELD`` 16-byte chunks each; 256 for wider rows (bfloat16
    D > 8192, float32 D > 4096), which the wide kernels take, a row a
    256-thread block. Both directions take it: the backward's bits
    depend on it (``_chain_sum(…, lanes)``); the forward's do not (the
    256-thread chain on any lanes), and its launch doubles the lanes
    while a lane would hold more than 3 chunks or rows · lanes < 2**16,
    so that few rows get fewer chunks a lane."""
    nvec = -(-d // (16 // element_size))
    lanes = 32
    while lanes < _THREADS and -(-nvec // lanes) > HELD:
        lanes *= 2
    return lanes


R_BATCH = 64  # r tensors one allocation makes (``_new_r``)
_R_VIEWS: dict = {}  # stream -> (x's shape, device index, r tensors not handed out)


def _new_r(x: torch.Tensor, stream: int) -> torch.Tensor:
    """A fresh float32 tensor of x's leading shape for one launch's r on
    ``stream``. One allocation on that stream makes ``R_BATCH`` of them
    (disjoint views of it, each handed out once), so a launch pays a list
    pop and not an allocation (7–12 µs of host time on an H100's host,
    ``scripts/torch_rmsnorm_fwd_sweep.py --host-parts``); the allocation
    lives while any of its views does."""
    made = _R_VIEWS.get(stream)
    shape, dev = x.shape, x.get_device()
    if made is None or made[0] != shape or made[1] != dev or not made[2]:
        batch = torch.empty((R_BATCH,) + shape[:-1], dtype=torch.float32,
                            device=x.device)
        made = _R_VIEWS[stream] = (shape, dev, list(batch.unbind(0)))
    return made[2].pop()


def rmsnorm_cuda(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5, *,
                 round_before_gain: bool = False, return_r: bool = False):
    """The K6 kernel on the card: x [..., D], g [D] -> y like x (with
    ``return_r``: ``(y, r)``, r [...] float32, stored by the same launch;
    r from ``_new_r``). Only a strided x or g is copied (made contiguous)
    first."""
    if not (x.is_cuda and g.device == x.device):
        raise ValueError("rmsnorm_cuda needs x and g on one CUDA device")
    _check(x, g)
    code = build.dtype_code(x.dtype, "rmsnorm")
    if not x.is_contiguous():
        x = x.contiguous()
    if not g.is_contiguous():
        g = g.contiguous()
    out = torch.empty_like(x)
    stream = build.stream_of(x)
    r = _new_r(x, stream) if return_r else None
    n = x.numel()
    if n == 0:
        return (out, r) if return_r else out
    d = g.shape[0]
    rc = build.library().repro_rmsnorm(
        x.data_ptr(), g.data_ptr(), out.data_ptr(),
        r.data_ptr() if return_r else None, n // d, d,
        _fwd_layout(d, x.element_size()), eps, code, round_before_gain,
        stream)
    build.check(rc, "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return (out, r) if return_r else out


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

BWD_MAX_D = 12_288  # the wide kernel's float32 dg sums: 48 KB (opted in)
BWD_SMS = 132  # the blocks a backward aims at: one per SM of an H100


@functools.lru_cache(maxsize=None)
def _bwd_layout(rows: int, d: int, element_size: int) -> tuple:
    """The backward kernel's layout, which fixes its fold orders:
    ``(lanes, groups, chunk)``. A row goes to ``_fwd_layout``'s lanes;
    a 256-thread block runs ``groups`` = 256 / lanes rows at once over
    ``chunk`` contiguous rows, a multiple of ``groups`` near rows /
    ``BWD_SMS`` (one dg partial row a block)."""
    lanes = _fwd_layout(d, element_size)
    groups = _THREADS // lanes
    chunk = -(-(-(-rows // BWD_SMS)) // groups) * groups
    return lanes, groups, chunk


def _check_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor) -> None:
    _check(x, g)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm backward takes dy like x {tuple(x.shape)} "
                         f"{x.dtype}; got {tuple(dy.shape)} {dy.dtype}")


def _bwd_ref(x, g, dy, eps, round_before_gain, r=None):
    """The backward's formulas in x's own dtype (float64 on the float64
    reference runs), torch's own reduction order; r [...] as
    ``rmsnorm_plain`` returns it, or formed here."""
    d = x.shape[-1]
    r = _ref_r(x, eps) if r is None else r[..., None]
    xn = x * r
    if round_before_gain:
        xn = xn.to(x.dtype)
    dxn = dy * g
    dot = (dxn * x).sum(-1, keepdim=True)
    dx = r * dxn - x * (r * r * r) * (dot / d)
    return dx.to(x.dtype), (dy * xn).reshape(-1, d).sum(0).to(g.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-5, *, round_before_gain: bool = False,
                      r=None) -> tuple:
    """The backward kernel's function in plain torch, step by step:
    ``(dx, dg)`` for ``y = rmsnorm(x, g)`` and the cotangent ``dy``, with
    the kernel's float32 chain (``csrc/rmsnorm.cu``): r as passed (the
    forward's, [...] float32) or else in the forward's order
    (``_kernel_r``); each row's ``Σ dxn·x`` in the layout of
    ``_bwd_layout``'s lanes (``_chain_sum``); ``dx = r·dxn −
    x·(r·r·r)·(Σ/D)``; ``dg`` summed per group over its rows of a chunk in
    ascending order, the groups added in order into one partial row a
    chunk, the partials in ascending chunk order. Dtypes the kernel does
    not take (float64) get the same formulas in their own dtype."""
    _check_bwd(x, g, dy)
    if x.dtype not in (torch.float32, torch.bfloat16):
        return _bwd_ref(x, g, dy, eps, round_before_gain, r)
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    xf, dyf, gf = x2.float(), dy.reshape(-1, d).float(), g.float()
    r = _kernel_r(x2, eps) if r is None else r.reshape(-1, 1).float()
    xn = xf * r
    if round_before_gain:
        xn = xn.to(x.dtype).float()
    dxn = dyf * gf
    lanes, groups, chunk = _bwd_layout(rows, d, x.element_size())
    dot = _chain_sum(dxn * xf, 16 // x.element_size(), lanes)[:, None]
    c = ((r * r) * r) * (dot / torch.tensor(float(d), **f32))
    dx = (r * dxn - xf * c).to(x.dtype).reshape(x.shape)
    blocks = -(-rows // chunk)
    prod = torch.zeros((blocks * chunk, d), **f32)  # zeros add nothing
    prod[:rows] = dyf * xn
    prod = prod.view(blocks, chunk // groups, groups, d)
    acc = torch.zeros((blocks, groups, d), **f32)
    for it in range(chunk // groups):
        acc = acc + prod[:, it]
    part = torch.zeros((blocks, d), **f32)
    for k in range(groups):
        part = part + acc[:, k]
    dg = torch.zeros((d,), **f32)
    for b in range(blocks):
        dg = dg + part[b]
    return dx, dg.to(g.dtype)


_WORK: dict = {}  # (device index, stream) -> the backward's float32 scratch


def _workspace(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` float32 of scratch for launches on ``stream``,
    kept between calls (the stream orders its uses); grown as needed."""
    key = (device.index, stream)
    w = _WORK.get(key)
    if w is None or w.numel() < n:
        w = _WORK[key] = torch.empty(n, dtype=torch.float32, device=device)
    return w


def rmsnorm_bwd_cuda(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5, *, round_before_gain: bool = False,
                     r=None) -> tuple:
    """K6's backward on the card: ``(dx, dg)`` (x's and g's dtype) from x
    [..., D], g [D], dy like x and, when given, the forward's r [...]
    float32 (else formed in the forward's chain in the same call). One
    call of ``csrc/rmsnorm.cu`` (the rows, then the fold of the dg
    partials) counted in ``LAUNCHES["rmsnorm_bwd"]``; D up to
    ``BWD_MAX_D``."""
    if not (x.is_cuda and g.device == x.device and dy.device == x.device):
        raise ValueError("rmsnorm_bwd_cuda needs x, g and dy on one CUDA "
                         "device")
    _check_bwd(x, g, dy)
    code = build.dtype_code(x.dtype, "rmsnorm_bwd")
    d = g.shape[0]
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd kernel takes D <= {BWD_MAX_D}, got {d}")
    if not x.is_contiguous():
        x = x.contiguous()
    if not g.is_contiguous():
        g = g.contiguous()
    if not dy.is_contiguous():
        dy = dy.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return dx, torch.zeros_like(g)
    if r is not None:
        if r.dtype != torch.float32 or r.numel() != rows or \
                r.device != x.device:
            raise ValueError(f"rmsnorm_bwd takes r as float32 [{rows}] on "
                             f"x's device; got {r.dtype} {tuple(r.shape)}")
        if not r.is_contiguous():
            r = r.contiguous()
    lanes, _, chunk = _bwd_layout(rows, d, x.element_size())
    stream = build.stream_of(x)
    work = _workspace(x.device, stream, -(-rows // chunk) * d
                      + (0 if r is not None else rows))
    dg = torch.empty_like(g)
    rc = build.library().repro_rmsnorm_bwd(
        x.data_ptr(), g.data_ptr(), dy.data_ptr(),
        r.data_ptr() if r is not None else None, dx.data_ptr(),
        dg.data_ptr(), work.data_ptr(), rows, d, lanes, chunk, eps, code,
        round_before_gain, stream)
    build.check(rc, "rmsnorm_bwd")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dg
