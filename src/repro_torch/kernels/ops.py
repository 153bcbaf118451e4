"""Executor-facing kernel ops, dispatched by the tensor's device.

Port of ``repro/kernels/ops.py``. Every op takes the stacked rank layout
(leading [P, ...] axis) and dispatches on where its operands live:

* a CUDA tensor launches the hand-written kernel — or raises; there is no
  fallback that hides the device or the kernel;
* a CPU tensor takes the kernel's plain torch version.

There is no environment switch. Each kernel launch is counted by its
wrapper (``launch_counts``), so a run can show that it went through the
kernels.

**Gradients.** The reference differentiates its Pallas ops through
``custom_jvp`` rules whose tangents run the jnp oracles
(``repro/kernels/ops.py:85-101,133-176``, ``sddmm.py:115-135``). Here
each op whose operand requires grad runs as a ``torch.autograd.Function``
whose backward is the transpose of the op, made of the port's own kernels
over host-built maps — on the card the kernels, on the CPU their plain
versions, one composition on both:

* pack (K1) ``out[p, s] = b[p, idx[p, s]]`` — backward: ``db`` is K2
  folding the slots into their rows, over the sorted-scatter maps of
  ``idx`` (pads -1 join no row);
* aggregation (K2) ``c[p, tgt[p, s]] += partials[p, s]`` — backward:
  ``dc`` passes through, ``dpartials`` is the K1 pack of ``dc`` by the
  slot targets rebuilt from ``perm`` / ``meta`` (-1 for pads: zeros);
* coo ``acc[row] += val · b[col]`` (K1 scaled + K2) — backward: ``db`` is
  the same op on the transposed piece, K1 scaled of ``dacc`` by ``row``
  and ``val``, then K2 into ``col`` over its sorted maps (pads -1);
  ``dval[e] = dacc[row[e]] · b[col[e]]`` in plain torch, only when the
  values require grad (the fused path), as the reference's coo SDDMM;
* K5 ``blocks ⊙ (X Yᵀ)`` — backward: ``dX`` is K3 on ``blocks ⊙ g``,
  ``dY`` K3 on the transposed ELL layout of ``blocks ⊙ g``
  (``sddmm.transpose_ell``), ``dblocks`` K5 of ``g``;
* K3 / K4 have no gradient in the reference (``repro/kernels/ops.py:52,
  63`` carry no JVP): they raise under grad;
* K6 (RMSNorm) — backward: K6's own backward kernel pair
  (``rmsnorm.rmsnorm_bwd_cuda``: ``dx``, and ``dg`` folded from per-block
  partials in a fixed order) on the r that the forward's launch saved, on
  the CPU its plain version.

The maps are static per plan: each is built on the host the first time a
gradient needs it and cached beside the plan tensor it derives from, on
that tensor's device, for as long as the tensor lives. A caller whose
index changes every call (the expert-parallel MoE's routing) hands its
own device-made maps instead (``maps=`` / ``targets=``): then nothing
goes to the host. A call that needs no gradient takes the op's direct
path and pays nothing for any of this.
The two in-place ops declare what they write (``ctx.mark_dirty``).

**The meta device** is a planning stand-in, not a device: the dry run
(``launch/dryrun.py``) runs a step's shapes on it and nothing else. A
meta operand takes a path of its own, which returns each op's output
with the kernel's shape and dtype (``new_empty``; the in-place folds
return their target) and builds no map that depends on the data: the
backward maps, like the device maps ``sorted_scatter_maps`` makes, are
empty tensors of their known sizes. A meta call launches nothing, so
``launch_counts`` does not move: it adds one call, and the bytes of its
operands and its output, to its kernel's entry in ``meta_calls()``, so
a plan can say which kernels a step reaches and what they move.
``on_card`` keeps its contract: a meta operand there raises.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import bsr_spmm as _bsr
from . import gather_rows as _gather
from . import rmsnorm as _rms
from . import scatter_add_rows as _scatter
from . import sddmm as _sddmm
from .scatter_add_rows import prepare_sorted_scatter, stack_sorted_scatter

__all__ = [
    "on_card",
    "gather_rows_op",
    "scatter_add_rows_op",
    "pack_rows_op",
    "scatter_add_rows_exec_op",
    "coo_accumulate_rows_op",
    "coo_accumulate_over_op",
    "coo_fold_rows",
    "coo_col_maps",
    "slot_targets",
    "bsr_spmm_op",
    "bsr_spmm_acc_op",
    "bsr_sddmm_op",
    "rmsnorm_op",
    "prepare_sorted_scatter",
    "stack_sorted_scatter",
    "launch_counts",
    "reset_launch_counts",
    "meta_calls",
]

_COUNTERS = (_gather.LAUNCHES, _scatter.LAUNCHES, _bsr.LAUNCHES,
             _sddmm.LAUNCHES, _rms.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    out: Dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for k in counter:
            counter[k] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


# ---------------------------------------------------------------------------
# the meta route: shapes only
# ---------------------------------------------------------------------------

_META_CALLS: Dict[str, Dict[str, int]] = {}


def meta_calls() -> Dict[str, Dict[str, int]]:
    """The kernels' calls on meta operands so far, by kernel name: each
    ``{"calls": n, "bytes": b}``, b the bytes of their operands and
    outputs. A copy; nothing resets it (a reader takes differences)."""
    return {k: dict(v) for k, v in _META_CALLS.items()}


def _on_meta(*tensors: torch.Tensor) -> bool:
    """Whether the operands are meta tensors: the first says, and then
    the others must be too (else ``on_card`` checks their devices). One
    attribute read on the kernels' path."""
    if not tensors[0].is_meta:
        return False
    if not all(t.is_meta for t in tensors[1:]):
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    return True


def _meta_call(kernel: str, out, *operands: torch.Tensor):
    """``out`` (a meta tensor or a tuple of them) as kernel ``kernel``'s
    result on meta operands: one meta call and its bytes recorded."""
    outs = out if isinstance(out, tuple) else (out,)
    rec = _META_CALLS.setdefault(kernel, {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += sum(t.numel() * t.element_size() for t in operands + outs)
    return out


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# the backward maps, built on the host once per plan tensor
# ---------------------------------------------------------------------------

_MAPS: "WeakIdKeyDictionary" = WeakIdKeyDictionary()


def _cached(key: torch.Tensor, kind, build: Callable[[], tuple]) -> tuple:
    """``build()``'s tensors, built once for ``key`` and moved to its
    device; the entry goes when ``key`` does."""
    per = _MAPS.get(key)
    if per is None:
        per = _MAPS[key] = {}
    if kind not in per:
        per[kind] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            key.device) for a in build())
    return per[kind]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _fold_maps(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sorted-scatter maps of an index array [P, ...] (-1 pads): the
    K2 fold of its slots into the rows they name."""
    if idx.is_meta:
        return _empty_maps(idx.flatten(1))
    return _cached(idx, "fold", lambda: stack_sorted_scatter(
        _host(idx.flatten(1))))


def _empty_maps(tgt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sorted-scatter maps' shapes for a target map [P, S] on meta."""
    P_, S = tgt.shape
    return (tgt.new_empty((P_, S), dtype=torch.int32),
            tgt.new_empty((P_, S + 1), dtype=torch.int32))


def _slot_targets_np(perm: np.ndarray, meta: np.ndarray) -> np.ndarray:
    P_, S = perm.shape
    tgt = np.full((P_, S), -1, np.int32)
    for p in range(P_):
        n_valid = int(meta[p, S])
        tgt[p, perm[p, :n_valid]] = meta[p, :n_valid]
    return tgt


def slot_targets(perm: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """The target row of every slot that sorted-scatter maps fold, [P, S]
    int32: ``tgt[perm[s]] = meta[s]`` for ``s < n_valid``, -1 for the
    pads (which join no row)."""
    if perm.is_meta:
        return perm.new_empty(perm.shape, dtype=torch.int32)
    return _cached(perm, "targets", lambda: (
        _slot_targets_np(_host(perm), _host(meta)),))[0]


def coo_col_maps(col: torch.Tensor, perm: torch.Tensor, meta: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A coo piece's transposed sorted maps: every entry folded into its
    column. An entry that joins no row (a pad of ``perm`` / ``meta``, the
    maps of its ``row`` array) joins no column either; a piece whose pads
    join rows (``coo_piece_with_maps``) keeps them in its columns too."""
    if col.is_meta:
        return _empty_maps(col)
    def build():
        tgt = _slot_targets_np(_host(perm), _host(meta))
        return stack_sorted_scatter(np.where(tgt >= 0, _host(col), -1))
    return _cached(col, "columns", build)


# ---------------------------------------------------------------------------
# the direct paths (one launch each; no autograd)
# ---------------------------------------------------------------------------


def _pack(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    flat = idx.flatten(1)  # [P, slots]; P may be 0 (an empty span)
    # every executor body packs here, so a CUDA idx goes straight to the
    # wrapper, which checks b's device itself (looked up on its module at
    # call time, so a recorder that replaces it sees the call)
    if idx.is_cuda:
        out = _gather.gather_rows_cuda(b, flat)
    elif _on_meta(b, idx):
        out = _meta_call("gather_rows", b.new_empty(
            (b.shape[0], flat.shape[1], b.shape[-1])), b, flat)
    else:
        on_card(b, idx)  # raises unless b is on the CPU too
        out = _gather.gather_rows_plain(b, flat)
    return out.reshape(idx.shape + (b.shape[-1],))


def _fold(c, partials, perm, meta):
    if _on_meta(c, partials, perm, meta):
        _scatter._check_shapes(c, partials, perm, meta)
        return _meta_call("scatter_add_rows", c, c, partials, perm, meta)
    fn = _scatter.scatter_add_rows_cuda if on_card(c, partials, perm, meta) \
        else _scatter.scatter_add_rows_plain
    return fn(c, partials, perm, meta)


def _gather_scaled(b, idx, val, out_dtype):
    if _on_meta(b, idx, val):
        return _meta_call("gather_rows_scaled", b.new_empty(
            tuple(idx.shape) + (b.shape[-1],), dtype=out_dtype), b, idx, val)
    fn = _gather.gather_rows_scaled_cuda if on_card(b, idx, val) \
        else _gather.gather_rows_scaled_plain
    return fn(b, idx, val, out_dtype)


def _coo_accumulate(acc, col, val, perm, meta, b):
    return _fold(acc, _gather_scaled(b, col, val, acc.dtype), perm, meta)


def coo_fold_rows(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                  perm: torch.Tensor, meta: torch.Tensor, rows: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """``out [P, rows, n] = 0``, then ``out[tgt[e]] += w[e] · src[idx[e]]``
    for the entries that ``perm`` / ``meta`` fold: K1's scaled form, then
    K2 — the coo compute as the backward compositions run it."""
    out = torch.zeros((src.shape[0], rows, src.shape[2]), dtype=dtype,
                      device=src.device)
    return _fold(out, _gather_scaled(src, idx, w, dtype), perm, meta)


def _k3(cols, blocks, b, m_out, bn):
    if _on_meta(cols, blocks, b):
        return _meta_call("bsr_spmm", b.new_empty(
            (b.shape[0], m_out, b.shape[-1])), cols, blocks, b)
    if on_card(cols, blocks, b):
        return _bsr.bsr_spmm_cuda(cols, blocks, b, m_out, bn=bn)
    return _bsr.bsr_spmm_plain(cols, blocks, b, m_out)


def _k5(cols, blocks, x3, y3):
    if _on_meta(cols, blocks, x3, y3):
        return _meta_call("bsr_sddmm", blocks.new_empty(
            blocks.shape, dtype=torch.float32), cols, blocks, x3, y3)
    if on_card(cols, blocks, x3, y3):
        return _sddmm.bsr_sddmm_cuda(cols, blocks, x3, y3)
    return _sddmm.bsr_sddmm_plain(cols, blocks, x3, y3)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


class _Pack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, idx, maps):
        ctx.idx, ctx.b_shape, ctx.maps = idx, b.shape, maps
        return _pack(b, idx)

    @staticmethod
    def backward(ctx, g):
        P_, K, n = ctx.b_shape
        perm, meta = ctx.maps if ctx.maps is not None else \
            _fold_maps(ctx.idx)
        db = g.new_zeros((P_, K, n))
        return _fold(db, g.reshape(P_, -1, n), perm, meta), None, None


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, partials, perm, meta, targets):
        ctx.maps, ctx.targets = (perm, meta), targets
        ctx.mark_dirty(c)
        return _fold(c, partials, perm, meta)

    @staticmethod
    def backward(ctx, g):
        dpartials = None
        if ctx.needs_input_grad[1]:
            tgt = ctx.targets if ctx.targets is not None else \
                slot_targets(*ctx.maps)
            dpartials = _pack(g, tgt)
        return g, dpartials, None, None, None


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, eps, round_before_gain):
        # the forward's launch also writes r for the backward
        y, r = _rmsnorm(x, g, eps, round_before_gain, return_r=True)
        ctx.save_for_backward(x, g, r)
        ctx.eps, ctx.rbg = eps, round_before_gain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, r = ctx.saved_tensors
        if _on_meta(x, g, dy):
            dx, dg = _meta_call("rmsnorm_bwd", (x.new_empty(x.shape),
                                                  g.new_empty(g.shape)),
                                  x, g, dy, r)
            return (dx if ctx.needs_input_grad[0] else None,
                    dg if ctx.needs_input_grad[1] else None, None, None)
        fn = _rms.rmsnorm_bwd_cuda if on_card(x, g, dy) \
            else _rms.rmsnorm_bwd_plain
        dx, dg = fn(x, g, dy, ctx.eps, round_before_gain=ctx.rbg, r=r)
        return (dx if ctx.needs_input_grad[0] else None,
                dg if ctx.needs_input_grad[1] else None, None, None)


class _CooAccumulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acc, col, val, perm, meta, b):
        ctx.maps = (col, perm, meta)
        ctx.b_like = (b.shape[1], b.dtype)
        ctx.mark_dirty(acc)
        # only what the backward reads: val for dB, b for dval
        ctx.save_for_backward(val if ctx.needs_input_grad[5] else None,
                              b if ctx.needs_input_grad[2] else None)
        return _coo_accumulate(acc, col, val, perm, meta, b)

    @staticmethod
    def backward(ctx, g):
        val, b = ctx.saved_tensors
        col, perm, meta = ctx.maps
        tgt = slot_targets(perm, meta)
        db = dval = None
        if ctx.needs_input_grad[5]:
            k, dtype = ctx.b_like
            db = coo_fold_rows(g, tgt, val, *coo_col_maps(col, perm, meta),
                               k, dtype)
        if ctx.needs_input_grad[2]:
            rows = torch.take_along_dim(g, tgt.clamp(min=0).long()[..., None],
                                        dim=1)
            cols = torch.take_along_dim(b, col.long()[..., None], dim=1)
            dval = torch.where(tgt >= 0, (rows * cols).sum(-1),
                               torch.zeros((), device=g.device)).float()
        return g, None, dval, None, None, db


class _BsrSddmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cols, blocks, x3, y3):
        ctx.save_for_backward(cols, blocks, x3, y3)
        return _k5(cols, blocks, x3, y3)

    @staticmethod
    def backward(ctx, g):
        cols, blocks, x3, y3 = ctx.saved_tensors
        P_, mb, t, bm, bk = blocks.shape
        kb, f = y3.shape[1], y3.shape[3]
        bg = blocks.float() * g
        dblocks = dx3 = dy3 = None
        if ctx.needs_input_grad[1]:
            dblocks = _k5(cols, g.contiguous(), x3, y3).to(blocks.dtype)
        if ctx.needs_input_grad[2]:
            dx3 = _k3(cols, bg, y3.reshape(P_, kb * bk, f), mb * bm,
                       128).view(P_, mb, bm, f)
        if ctx.needs_input_grad[3]:
            cols_t, slot = _cached(cols, ("transposed", kb), lambda: (
                _sddmm.transpose_ell(_host(cols), kb)))
            flat = bg.reshape(P_, mb * t, bm * bk)
            bg_t = torch.take_along_dim(
                flat, slot.clamp(min=0).long().reshape(P_, -1, 1), dim=1)
            bg_t = torch.where(slot.reshape(P_, -1, 1) >= 0, bg_t,
                               torch.zeros((), device=bg.device))
            bg_t = bg_t.view(P_, kb, cols_t.shape[2], bm, bk).transpose(-1, -2)
            dy3 = _k3(cols_t, bg_t.contiguous(),
                       x3.reshape(P_, mb * bm, f), kb * bk,
                       128).view(P_, kb, bk, f)
        return None, dblocks, dx3, dy3


# ---------------------------------------------------------------------------
# the ops the executors call
# ---------------------------------------------------------------------------


def pack_rows_op(b: torch.Tensor, idx: torch.Tensor,
                 maps=None) -> torch.Tensor:
    """Comm-buffer pack: ``out[p, ..., s, :] = b[p, idx[p, ..., s]]``.

    ``b`` is [P, K, n]; ``idx`` [P, ...] may carry layout axes after the
    rank (e.g. [P, P, max_b] in the single-round schedule); the gather
    runs on the flattened slot axis and the result is reshaped back.
    Slots with ``idx < 0`` (plan padding) come back zeroed. ``maps``, the
    sorted-scatter maps (perm, meta) of ``idx`` flattened to [P, S] on its
    device, serve the backward's fold when given (an index made per
    call); else they are built on the host once per ``idx`` tensor.
    """
    if _needs_grad(b):
        return _Pack.apply(b, idx, maps)
    return _pack(b, idx)


def gather_rows_op(b: torch.Tensor, idx) -> torch.Tensor:
    """The reference's ``gather_rows_op``: b [K, n], idx [S] (numpy or a
    tensor) -> ``out[s] = b[idx[s]]`` [S, n], zeros where idx < 0, through
    K1. Differentiable in ``b`` (the pack's backward, K2)."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.ascontiguousarray(idx))
    idx = idx.to(device=b.device, dtype=torch.int32)
    return pack_rows_op(b[None], idx[None])[0]


def scatter_add_rows_op(c: torch.Tensor, partials: torch.Tensor,
                        tgt: np.ndarray) -> torch.Tensor:
    """The reference's ``scatter_add_rows_op``: ``c[tgt[s]] += partials[s]``
    (c [M, n], partials [S, n]) through K2, on a copy of ``c``. ``tgt`` is
    a STATIC host map [S] (-1: no row), prepared on the host by
    ``prepare_sorted_scatter`` as the reference does; each row folds its
    slots in slot order, no atomics. Differentiable in ``c`` and
    ``partials``."""
    perm, meta = (torch.from_numpy(a[None]).to(c.device)
                  for a in prepare_sorted_scatter(np.asarray(tgt)))
    return scatter_add_rows_exec_op(c.clone()[None], partials[None], perm,
                                    meta)[0]


def scatter_add_rows_exec_op(c: torch.Tensor, partials: torch.Tensor,
                             perm: torch.Tensor, meta: torch.Tensor,
                             targets=None) -> torch.Tensor:
    """Result aggregation ``c[p, tgt[p, s]] += partials[p, s]``, IN PLACE.

    ``perm`` / ``meta`` are the sorted-scatter maps of ``tgt``
    (``prepare_sorted_scatter`` once per plan, or ``sorted_scatter_maps``
    on the device). ``targets``, ``tgt`` itself [P, S] int32 (-1 pads) on
    the device, serves the backward's pack when given; else it is rebuilt
    on the host once per ``perm`` tensor. Returns ``c``.
    """
    if _needs_grad(c, partials):
        return _Aggregate.apply(c, partials, perm, meta, targets)
    return _fold(c, partials, perm, meta)


def coo_accumulate_rows_op(acc: torch.Tensor, col: torch.Tensor,
                           val: torch.Tensor, perm: torch.Tensor,
                           meta: torch.Tensor, b: torch.Tensor
                           ) -> torch.Tensor:
    """Padded-COO scatter-add ``acc[p, row[p, e]] += val[p, e]·b[p, col[p, e]]``.

    IN PLACE on ``acc`` [P, m, n] (contiguous), which is returned.
    ``perm`` / ``meta`` are the sorted-scatter maps of the piece's ``row``
    array (``prepare_sorted_scatter``, pads at -1). Two launches, no
    atomics: K1's scaled form gathers ``b[col]`` and multiplies by ``val``
    on the way to its output, ``(b[col] * val).to(acc.dtype)`` with one
    rounding, then K2 folds the products into ``acc`` in slot order. The
    piece's entries are in CSR order, so each row's chain is
    ``acc + e1 + e2 + …`` in ascending column order — the chain
    segment-by-segment accumulation replays, which keeps overlapped coo C
    bit-identical to staged C, and every run equal to the last.
    """
    if _needs_grad(acc, val, b):
        return _CooAccumulate.apply(acc, col, val, perm, meta, b)
    return _coo_accumulate(acc, col, val, perm, meta, b)


def coo_accumulate_over_op(col: torch.Tensor, val: torch.Tensor,
                           perm: torch.Tensor, meta: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """``coo_accumulate_rows_op`` on a zero accumulator, written over
    ``b`` [P, m, n] itself once K1 has read it: K1's scaled form gathers
    the products, then ``b`` is zeroed and K2 folds them into it — the
    same chain, in ``b``'s storage. For an operand the caller owns and
    reads no more (a donated B); no gradient flows through it."""
    if _needs_grad(val, b):
        raise RuntimeError("coo_accumulate_over_op overwrites its operand; "
                           "it takes no gradient")
    products = _gather_scaled(b, col, val, b.dtype)
    return _fold(b.zero_(), products, perm, meta)


def _refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} has no gradient: the reference's bsr_spmm_pallas / "
            f"bsr_spmm_acc_pallas carry no JVP (src/repro/kernels/ops.py:"
            f"52,63), so it trains on the coo backend; call with "
            f"backend='coo', or under torch.no_grad()")


def bsr_spmm_op(block_cols: torch.Tensor, blocks: torch.Tensor,
                b: torch.Tensor, m_out: int, *, bn: int = 128
                ) -> torch.Tensor:
    """``C [P, m_out, n] = A @ B`` for stacked ELL-BSR pieces (K3).
    Raises under grad, as the reference has no JVP for it."""
    _refuse_grad("bsr_spmm (K3)", blocks, b)
    return _k3(block_cols, blocks, b, m_out, bn)


def bsr_spmm_acc_op(block_cols: torch.Tensor, blocks: torch.Tensor,
                    b: torch.Tensor, acc: torch.Tensor, *, bn: int = 128
                    ) -> torch.Tensor:
    """``acc += A @ B`` IN PLACE, folding stored blocks in ascending t (K4).

    Resumes the staged kernel's per-element addition chain, so a piece's
    column segments fed here one after another give the bits of one
    ``bsr_spmm_op`` over the whole piece. Raises under grad, as K3.
    """
    _refuse_grad("bsr_spmm_acc (K4)", blocks, b, acc)
    if _on_meta(block_cols, blocks, b, acc):
        return _meta_call("bsr_spmm_acc", acc, block_cols, blocks, b, acc)
    if on_card(block_cols, blocks, b, acc):
        return _bsr.bsr_spmm_acc_cuda(block_cols, blocks, b, acc, bn=bn)
    return _bsr.bsr_spmm_acc_plain(block_cols, blocks, b, acc)


def bsr_sddmm_op(block_cols: torch.Tensor, blocks: torch.Tensor,
                 x3: torch.Tensor, y3: torch.Tensor) -> torch.Tensor:
    """Sampled ``blocks ⊙ (X_blk · Y_blkᵀ)`` per stored block, float32 (K5).

    ``x3`` [P, mb, bm, F] / ``y3`` [P, kb, bk, F] are the dense rows in
    block-row view; the result has ``blocks``' shape [P, mb, t, bm, bk].
    """
    if _needs_grad(blocks, x3, y3):
        return _BsrSddmm.apply(block_cols, blocks, x3, y3)
    return _k5(block_cols, blocks, x3, y3)


def rmsnorm_op(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5, *,
               round_before_gain: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim, ``x · rsqrt(mean(x²) + eps) · g`` (K6).

    ``round_before_gain`` says where the rounding to x's dtype falls (see
    ``kernels.rmsnorm``): ``False`` as ``rmsnorm_pallas``, ``True`` as the
    model's ``rms_norm``. Under grad (x or g requires it) the call runs
    as ``_RmsNorm``, whose backward is K6's backward kernel pair.
    """
    if _needs_grad(x, g):
        return _RmsNorm.apply(x, g, eps, round_before_gain)
    return _rmsnorm(x, g, eps, round_before_gain)


def _rmsnorm(x, g, eps, round_before_gain, return_r=False):
    # the LM runs this 2·L + 1 times a step, so a CUDA x goes straight to
    # the wrapper, which checks g's device itself. The wrapper is looked up
    # on its module at call time, so a recorder that replaces it sees the
    # call. return_r (under grad): (y, r), r for the backward.
    if x.is_cuda:
        return _rms.rmsnorm_cuda(x, g, eps,
                                 round_before_gain=round_before_gain,
                                 return_r=return_r)
    if _on_meta(x, g):
        y = x.new_empty(x.shape)
        out = (y, x.new_empty(x.shape[:-1], dtype=torch.float32)) \
            if return_r else y
        return _meta_call("rmsnorm", out, x, g)
    on_card(x, g)  # raises unless g is on the CPU too
    return _rms.rmsnorm_plain(x, g, eps,
                              round_before_gain=round_before_gain,
                              return_r=return_r)
