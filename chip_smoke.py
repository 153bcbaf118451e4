#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # full size, one NVIDIA H100
    python3 chip_smoke.py --quick    # a small matrix: build + every check

Run from the repository root on a machine with a CUDA card; it imports the
port from ``src/`` and nothing of JAX or of the JAX package. It drives the
port's main path — ``compile_spmm(a, 8, SpmmConfig(backends=("coo",
"bsr")))``, then ``h(b)``, ``h(b, backend="bsr")`` and ``h(b)`` again —
at the scale of ogbn-arxiv (169,343 nodes rounded up to 169,344 = 8 ×
21,168 so that 8 | M, 1,166,243 edges, 128 feature columns), on a uniform
matrix (coo and bsr) and a power-law one (coo: its ELL form would need
~86 GB), then GAT inference on the uniform graph through the FusedMM
handle. Phases, each of which raises on a failed check:

1. build: nvcc builds K1–K5 from ``src/repro_torch/csrc``;
2. kernels: every kernel's calls on each path are recorded and replayed
   against the kernel's plain torch version on the same inputs (K1 and
   K2 exact, float32 1e-5 for K3–K5), and again at ``tests/test_kernels.py``'s
   sweeps (bfloat16 6e-2); each is timed beside its bound, its plain
   version and one PyTorch library call for the same function;
3. main path, uniform: C within 2e-4 of scipy in float64, the model's
   decisions, collective rows == ``volume_rows_padded``, staged C
   bit-identical to overlapped (bsr and coo), two ``h(b)`` calls
   bit-identical, every kernel launched;
4. main path, power-law (coo): the same checks, and its K1/K2 calls
   replayed against their plain versions as in phase 2;
5. GAT: ``compile_fused(normalize_adjacency(a), 8, SpmmConfig(kernel=
   "fused", edge="leaky_relu", backends=("coo", "bsr")))`` serves a
   2-layer GAT (ogbn-arxiv's 128 features and 40 classes, 128 hidden,
   att_dim 16, weights from numpy seed 0 through ``gat_from_numpy``), one
   forward per backend, then ``h(x, y, kernel="sddmm")`` at F = 128 on
   bsr: decisions equal the reference's, each layer's C and the output
   within 2e-4 of scipy float64, the sampled values within 2e-4 of float64,
   the fused log's shift pairs equal the spmm call's, coo and bsr agree
   and repeat bit for bit, K1, K2, K3 and K5 launched on bsr and K1, K2
   on coo; the kernel calls of both forwards and of the F = 128 SDDMM
   are replayed against the plain versions as in phase 2;
6. timing: median ``h(b)`` per backend and median GAT forward per backend.

It prints the card's name and power limit, then one JSON line of kernel
rows, then ``{"ok": true, "device": {...}}`` as its last line. Without a
CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

P = 8
N_COLS = 128
M_FULL = 169_344  # ogbn-arxiv's 169,343 nodes, rounded up to 8 | M
NNZ_FULL = 1_166_243  # ogbn-arxiv's edges
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores

# the reference's model decisions at full size (same host code, CPU run)
EXPECT_UNIFORM = dict(strategy="flat", plan_strategy="joint", net="tsubame4",
                      schedule_kind="bucketed", schedule_K=2, overlap=True,
                      volume_rows=589422, volume_rows_padded=602920,
                      volume_rows_padded_single=693952, pattern_nnz=1166229)
EXPECT_UNIFORM_EX = dict(max_b=2135, max_c=8708, R_b=14841, R_c=60524)
EXPECT_POWERLAW = dict(strategy="flat", schedule_kind="bucketed",
                       schedule_K=4, overlap=True, volume_rows=260413,
                       volume_rows_padded=827712)
# the reference's fused decisions on normalize_adjacency(uniform) (the JAX
# package's _plan_and_tune on the same matrix, CPU run)
EXPECT_FUSED = dict(kernel="fused", edge="leaky_relu", schedule_kind="bucketed",
                    schedule_K=2, overlap=False,
                    modeled_time_fused=0.006233900800000001,
                    volume_rows=589422, volume_rows_padded=602920,
                    volume_rows_padded_single=693952, pattern_nnz=1335568)
GAT_DIMS = dict(feat_dim=128, hidden=128, n_classes=40, n_layers=2,
                att_dim=16)  # ogbn-arxiv's features and classes
SDDMM_F = 128

KERNELS = {
    # name: (source, the Pallas function it replaces)
    "gather_rows": ("src/repro_torch/csrc/gather_rows.cu",
                    "src/repro/kernels/gather_rows.py:34"),
    "scatter_add_rows": ("src/repro_torch/csrc/scatter_add_rows.cu",
                         "src/repro/kernels/scatter_add_rows.py:71"),
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm.py:53"),
    "bsr_spmm_acc": ("src/repro_torch/csrc/bsr_spmm.cu",
                     "src/repro/kernels/bsr_spmm.py:110"),
    "bsr_sddmm": ("src/repro_torch/csrc/bsr_sddmm.cu",
                  "src/repro/kernels/sddmm.py:72"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def toolchain() -> str:
    from repro_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    return (f"torch {torch.__version__}, torch.version.cuda "
            f"{torch.version.cuda}, nvcc: {nvcc[-1]}, triton {triton_version}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# kernel calls: record on the main path, replay against the plain versions
# ---------------------------------------------------------------------------


def record_kernel_calls(fn):
    """Run ``fn()`` with every kernel wrapper wrapped to keep a copy of
    its arguments; returns {kernel: [(args, kwargs), ...]}."""
    from repro_torch.kernels import (
        bsr_spmm, gather_rows, scatter_add_rows, sddmm,
    )

    targets = {"gather_rows": (gather_rows, "gather_rows_cuda"),
               "scatter_add_rows": (scatter_add_rows, "scatter_add_rows_cuda"),
               "bsr_spmm": (bsr_spmm, "bsr_spmm_cuda"),
               "bsr_spmm_acc": (bsr_spmm, "bsr_spmm_acc_cuda"),
               "bsr_sddmm": (sddmm, "bsr_sddmm_cuda")}
    calls = {k: [] for k in targets}
    originals = {k: getattr(mod, attr) for k, (mod, attr) in targets.items()}

    def wrap(kernel, orig):
        def recorded(*args, **kwargs):
            calls[kernel].append((
                [a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args], dict(kwargs)))
            return orig(*args, **kwargs)
        return recorded

    for k, (mod, attr) in targets.items():
        setattr(mod, attr, wrap(k, originals[k]))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for k, (mod, attr) in targets.items():
            setattr(mod, attr, originals[k])
    return calls


def _distinct_rows(idx: torch.Tensor) -> int:
    """Distinct non-negative entries per rank, summed over ranks."""
    P_ = idx.shape[0]
    total = 0
    for p in range(P_):
        row = idx[p].reshape(-1)
        total += int(torch.unique(row[row >= 0]).numel())
    return total


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bsr_csr(cols, blocks, K: int, m_out: int):
    """The stacked ELL pieces as one block-diagonal CSR matrix (for the
    library call): [P*m_out, P*K]."""
    P_, mb, t, bm, bk = blocks.shape
    p, i, s, r, k = (blocks != 0).nonzero().unbind(1)
    c = cols[p, i, s].long()
    row = i * bm + r
    col = c * bk + k
    keep = (row < m_out) & (col < K)
    idx = torch.stack([p * m_out + row, p * K + col])[:, keep]
    with warnings.catch_warnings():  # beta-state notices of torch.sparse
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(idx, blocks[p, i, s, r, k][keep],
                                      (P_ * m_out, P_ * K)).coalesce()
        return coo.to_sparse_csr()


def _sddmm_csr(cols, blocks, rows: int, ncols: int):
    """The stored nonzeros of stacked ELL pieces as one block-diagonal CSR
    pattern [P*rows, P*ncols] carrying the stored values (the library's
    SDDMM samples at exactly these positions)."""
    P_, mb, t, bm, bk = blocks.shape
    p, i, s, r, k = (blocks != 0).nonzero().unbind(1)
    idx = torch.stack([p * rows + i * bm + r,
                       p * ncols + cols[p, i, s].long() * bk + k])
    with warnings.catch_warnings():  # beta-state notices of torch.sparse
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(idx, blocks[p, i, s, r, k],
                                      (P_ * rows, P_ * ncols)).coalesce()
        return coo.to_sparse_csr()


def kernel_row(name, calls, launches):
    """Replay one kernel's recorded calls: error vs plain, times, bound."""
    from repro_torch.kernels import bsr_spmm as k34
    from repro_torch.kernels import gather_rows as k1
    from repro_torch.kernels import scatter_add_rows as k2
    from repro_torch.kernels import sddmm as k5

    if not calls:
        raise AssertionError(f"{name}: no call recorded on the main path")
    err = ms = plain_ms = lib_ms = bound_ms = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for args, kw in calls:
        if name == "gather_rows":
            b, idx = args
            out = k1.gather_rows_cuda(b, idx)
            ref = k1.gather_rows_plain(b, idx)
            if not torch.equal(out, ref):
                raise AssertionError("gather_rows kernel != plain version")
            P_, K, n = b.shape
            flat = torch.where(idx >= 0, idx.long() + torch.arange(
                P_, device=b.device)[:, None] * K, P_ * K).reshape(-1)
            b_pad = torch.cat([b.reshape(P_ * K, n), b.new_zeros(1, n)])
            run = lambda: k1.gather_rows_cuda(b, idx)  # noqa: E731
            plain = lambda: k1.gather_rows_plain(b, idx)  # noqa: E731
            lib = lambda: b_pad.index_select(0, flat)  # noqa: E731
            es = b.element_size()
            nbytes = (_distinct_rows(idx) * n * es + idx.numel() * 4
                      + idx.numel() * n * es)
            flops = 0.0
        elif name == "scatter_add_rows":
            c0, parts, perm, meta = args
            out = k2.scatter_add_rows_cuda(c0.clone(), parts, perm, meta)
            ref = k2.scatter_add_rows_plain(c0.clone(), parts, perm, meta)
            if not torch.equal(out, ref):  # one slot-order chain in both
                raise AssertionError("scatter_add_rows kernel != plain "
                                     "version")
            P_, S, n = parts.shape
            M = c0.shape[1]
            c = c0.clone()
            valid = torch.arange(S, device=c.device)[None] < meta[:, S:]
            tgt = (meta[:, :S].long() + torch.arange(
                P_, device=c.device)[:, None] * M)[valid]
            rows = torch.take_along_dim(parts, perm.long()[..., None],
                                        dim=1)[valid]
            run = lambda: k2.scatter_add_rows_cuda(c, parts, perm, meta)  # noqa: E731,E501
            plain = lambda: k2.scatter_add_rows_plain(c, parts, perm, meta)  # noqa: E731,E501
            lib = lambda: c.view(P_ * M, n).index_add_(0, tgt, rows)  # noqa: E731,E501
            es = c.element_size()
            n_valid = int(valid.sum())
            touched = int(torch.unique(tgt).numel())
            nbytes = (n_valid * n * es + (perm.numel() + meta.numel()) * 4
                      + 2 * touched * n * es)
            flops = float(n_valid * n)
        elif name == "bsr_sddmm":
            cols, blocks, x3, y3 = args
            out = k5.bsr_sddmm_cuda(cols, blocks, x3, y3)
            ref = k5.bsr_sddmm_plain(cols, blocks, x3, y3)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
            P_, mb, t, bm, bk = blocks.shape
            kb, f = y3.shape[1], y3.shape[3]
            csr = _sddmm_csr(cols, blocks, mb * bm, kb * bk)
            x2 = x3.reshape(P_ * mb * bm, f)
            y2t = y3.reshape(P_ * kb * bk, f).t()
            stored = csr.values()
            run = lambda: k5.bsr_sddmm_cuda(cols, blocks, x3, y3)  # noqa: E731
            plain = lambda: k5.bsr_sddmm_plain(cols, blocks, x3, y3)  # noqa: E731,E501
            lib = lambda: torch.sparse.sampled_addmm(  # noqa: E731
                csr, x2, y2t, beta=0.0).values() * stored
            es = x3.element_size()
            nb = int((cols >= 0).sum())
            flops = 2.0 * nb * bm * bk * f + nb * bm * bk
            nbytes = (nb * bm * bk * 4 + cols.numel() * 4
                      + x3.numel() * es + _distinct_rows(cols) * bk * f * es
                      + out.numel() * 4)
        else:
            acc_form = name == "bsr_spmm_acc"
            cols, blocks, b, last = args
            bn = kw.get("bn", 128)
            P_, mb, t, bm, bk = blocks.shape
            K, n = b.shape[1], b.shape[2]
            m_out = last.shape[1] if acc_form else int(last)
            if acc_form:
                out = k34.bsr_spmm_acc_cuda(cols, blocks, b, last.clone(),
                                            bn=bn)
                ref = k34.bsr_spmm_acc_plain(cols, blocks, b, last.clone())
                acc = last.clone()
                run = lambda: k34.bsr_spmm_acc_cuda(cols, blocks, b, acc, bn=bn)  # noqa: E731,E501
                plain = lambda: k34.bsr_spmm_acc_plain(cols, blocks, b, acc)  # noqa: E731,E501
            else:
                out = k34.bsr_spmm_cuda(cols, blocks, b, m_out, bn=bn)
                ref = k34.bsr_spmm_plain(cols, blocks, b, m_out)
                run = lambda: k34.bsr_spmm_cuda(cols, blocks, b, m_out, bn=bn)  # noqa: E731,E501
                plain = lambda: k34.bsr_spmm_plain(cols, blocks, b, m_out)  # noqa: E731,E501
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
            csr = _bsr_csr(cols, blocks, K, m_out)
            b2 = b.reshape(P_ * K, n)
            if acc_form:
                acc2 = last.reshape(P_ * m_out, n)
                lib = lambda: torch.addmm(acc2, csr, b2)  # noqa: E731
            else:
                lib = lambda: torch.sparse.mm(csr, b2)  # noqa: E731
            es = b.element_size()
            nb = int((cols >= 0).sum())
            flops = 2.0 * nb * bm * bk * n
            nbytes = (nb * bm * bk * 4 + cols.numel() * 4
                      + _distinct_rows(cols) * bk * n * es
                      + P_ * m_out * n * es * (2 if acc_form else 1))
        err = max(err, float((out.float() - ref.float()).abs().max())
                  if out.numel() else 0.0)
        ms += time_ms(run)
        plain_ms += time_ms(plain, iters=1, warmup=0)  # warm from the check
        lib_ms += time_ms(lib)
        b_ms, b_by = _bound(nbytes, flops)
        bound_ms += b_ms
        by[b_by] += b_ms
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": max(by, key=by.get),
            "library_ms": lib_ms, "calls_per_h": len(calls)}


def sweep_checks() -> None:
    """``tests/test_kernels.py``'s sweeps, with 2 stacked ranks."""
    from repro_torch.kernels import bsr_spmm as k34
    from repro_torch.kernels import gather_rows as k1
    from repro_torch.kernels import scatter_add_rows as k2
    from repro_torch.kernels import sddmm as k5

    dev = "cuda"
    rng = np.random.default_rng(0)
    worst = {"f32": 0.0, "bf16": 0.0}
    for mb, t, bm, bk, kb, n, bn in [(2, 3, 8, 8, 4, 16, 16),
                                     (3, 2, 16, 8, 5, 32, 16),
                                     (1, 1, 8, 8, 2, 8, 8),
                                     (4, 5, 32, 16, 8, 64, 64),
                                     (2, 4, 8, 32, 4, 128, 128)]:
        cols = rng.integers(-1, kb, size=(2, mb, t)).astype(np.int32)
        blocks = rng.standard_normal((2, mb, t, bm, bk)).astype(np.float32)
        blocks[cols < 0] = 0.0
        b = rng.standard_normal((2, kb * bk, n)).astype(np.float32)
        cols_d = torch.from_numpy(cols).to(dev)
        for dtype, key, tol in [(torch.float32, "f32", 1e-5),
                                (torch.bfloat16, "bf16", 6e-2)]:
            blk = torch.from_numpy(blocks).to(dev, dtype)
            bb = torch.from_numpy(b).to(dev, dtype)
            out = k34.bsr_spmm_cuda(cols_d, blk, bb, mb * bm, bn=bn)
            ref = k34.bsr_spmm_plain(cols_d, blk, bb, mb * bm)
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            acc = torch.randn((2, mb * bm, n), device=dev).to(dtype)
            out = k34.bsr_spmm_acc_cuda(cols_d, blk, bb, acc.clone(), bn=bn)
            ref = k34.bsr_spmm_acc_plain(cols_d, blk, bb, acc.clone())
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            worst[key] = max(worst[key],
                             float((out.float() - ref.float()).abs().max()))
    for K, n, S in [(16, 8, 5), (64, 32, 20), (8, 128, 3), (128, 256, 64)]:
        b = torch.randn((2, K, n), device=dev)
        idx = torch.from_numpy(
            rng.integers(-1, K, size=(2, S)).astype(np.int32)).to(dev)
        if not torch.equal(k1.gather_rows_cuda(b, idx),
                           k1.gather_rows_plain(b, idx)):
            raise AssertionError(f"gather sweep {(K, n, S)} differs")
    for M, n, S in [(8, 16, 12), (16, 8, 30), (4, 8, 6), (32, 128, 100)]:
        c = torch.randn((2, M, n), device=dev)
        parts = torch.randn((2, S, n), device=dev)
        prep = [k2.prepare_sorted_scatter(rng.integers(-1, M, size=S))
                for _ in range(2)]
        perm = torch.from_numpy(np.stack([a for a, _ in prep])).to(dev)
        meta = torch.from_numpy(np.stack([m for _, m in prep])).to(dev)
        if not torch.equal(
                k2.scatter_add_rows_cuda(c.clone(), parts, perm, meta),
                k2.scatter_add_rows_plain(c.clone(), parts, perm, meta)):
            raise AssertionError(f"scatter sweep {(M, n, S)} differs")
    perm, meta = k2.prepare_sorted_scatter(np.full(3, -1, np.int32))
    c = torch.ones((1, 4, 8), device=dev)
    out = k2.scatter_add_rows_cuda(
        c.clone(), torch.full((1, 3, 8), 7.0, device=dev),
        torch.from_numpy(perm[None]).to(dev),
        torch.from_numpy(meta[None]).to(dev))
    if not torch.equal(out, c):
        raise AssertionError("all-pad scatter changed C")
    worst5 = {"f32": 0.0, "bf16": 0.0}
    for mb, t, bm, bk, kb, f in [(3, 4, 8, 8, 5, 1), (4, 3, 8, 8, 6, 16),
                                 (2, 5, 8, 8, 4, 33), (3, 2, 8, 8, 3, 128),
                                 (4, 0, 8, 8, 3, 16), (2, 3, 16, 8, 4, 24)]:
        cols = rng.integers(-1, kb, size=(2, mb, t)).astype(np.int32)
        if t:
            cols[:, 0] = -1  # all-pad block rows
        blocks = rng.standard_normal((2, mb, t, bm, bk)).astype(np.float32)
        blocks[cols < 0] = 0.0
        cols_d = torch.from_numpy(cols).to(dev)
        blk = torch.from_numpy(blocks).to(dev)
        x3 = torch.randn((2, mb, bm, f), device=dev)
        y3 = torch.randn((2, kb, bk, f), device=dev)
        for dtype, key, tol in [(torch.float32, "f32", 1e-5),
                                (torch.bfloat16, "bf16", 1e-5)]:
            xs, ys = x3.to(dtype), y3.to(dtype)
            out = k5.bsr_sddmm_cuda(cols_d, blk, xs, ys)
            ref = k5.bsr_sddmm_plain(cols_d, blk, xs, ys)
            torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
            if out[cols_d < 0].any():
                raise AssertionError("bsr_sddmm pad slots are not zero")
            if out.numel():
                worst5[key] = max(worst5[key],
                                  float((out - ref).abs().max()))
    log(f"sweeps: K1 exact, K2 exact, K3/K4 max abs err "
        f"f32 {worst['f32']:.3g} (tol 1e-5), bf16 {worst['bf16']:.3g} "
        f"(tol 6e-2); K5 (F 1, 16, 33, 128, t = 0, all-pad rows) max abs "
        f"err f32 {worst5['f32']:.3g}, bf16 inputs {worst5['bf16']:.3g} "
        f"(tol 1e-5: float32 products either way)")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def check_c(c: torch.Tensor, a, b_host: np.ndarray, what: str) -> float:
    """C within the executor tolerance (2e-4) of scipy's product in float64."""
    import scipy.sparse as sp

    ref = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                        shape=a.shape) @ b_host.astype(np.float64)
    got = c.double().cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: C shape {got.shape} or values bad")
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4,
                               err_msg=what)
    return float(np.abs(got - ref).max())


def check_decisions(h, expect: dict, expect_ex: dict, what: str) -> None:
    st = h.stats()
    got = {k: st[k] for k in expect}
    got_ex = {k: h.ex.meta[k] if k in h.ex.meta else getattr(h.ex, k)
              for k in expect_ex}
    log(f"{what} decisions: {json.dumps({**got, **got_ex})}")
    if got != expect or got_ex != expect_ex:
        raise AssertionError(f"{what}: decisions {got} {got_ex} != "
                             f"{expect} {expect_ex}")


def check_rows(h, what: str) -> None:
    want = h.plan.volume_rows_padded(h.schedule)
    if h.comm.rows() != want:
        raise AssertionError(f"{what}: collectives carried {h.comm.rows()} "
                             f"rows, the plan says {want}")


# ---------------------------------------------------------------------------
# GAT on the fused handle
# ---------------------------------------------------------------------------


def gat_params(seed: int = 0):
    """numpy weights in the reference's ``GAT.init`` layout and scale."""
    rng = np.random.default_rng(seed)
    d = GAT_DIMS
    dims = ([d["feat_dim"]] + [d["hidden"]] * (d["n_layers"] - 1)
            + [d["n_classes"]])
    out = []
    for i in range(d["n_layers"]):
        scale = dims[i] ** -0.5
        out.append({
            name: (rng.standard_normal((dims[i], width)) * scale).astype(
                np.float32)
            for name, width in (("wq", d["att_dim"]), ("wk", d["att_dim"]),
                                ("wv", dims[i + 1]))})
        out[-1]["b"] = np.zeros(dims[i + 1], np.float32)
    return out


def fused_oracle(a, q, k, v) -> np.ndarray:
    """scipy float64: ``leaky_relu(a_ij · q_i·k_j)`` on the stored edges,
    then ``@ v``."""
    import scipy.sparse as sp

    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    s = a.data.astype(np.float64) * np.einsum("ef,ef->e", q[rows],
                                              k[a.indices])
    s = np.where(s > 0, s, 0.2 * s)
    return sp.csr_matrix((s, a.indices, a.indptr), shape=a.shape) @ v


def gat_oracle(a, params, feats: np.ndarray) -> np.ndarray:
    """The whole GAT forward in float64."""
    h = feats.astype(np.float64)
    for i, lp in enumerate(params):
        q, k = h @ lp["wq"], h @ lp["wk"]
        v = h @ lp["wv"] + lp["b"]
        h = fused_oracle(a, q, k, v)
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    return h


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.double().cpu().numpy()


def check_close(got: torch.Tensor, want: np.ndarray, what: str) -> str:
    """Within 2e-4 (rtol and atol, the executor tolerance) of ``want``."""
    got = _host64(got)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} (want {want.shape}) "
                             f"or non-finite values")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=what)
    diff = np.abs(got - want)
    return (f"max abs err {diff.max():.3g} at |want| up to "
            f"{np.abs(want).max():.3g}; max err / (2e-4 + 2e-4·|want|) "
            f"{(diff / (2e-4 + 2e-4 * np.abs(want))).max():.3g} (<= 1 passes)")


def _segment_shift(segments, total: int, device) -> torch.Tensor:
    """The shift d of every slot of a flat segment space (-1 off-segment)."""
    out = torch.full((max(total, 1),), -1, dtype=torch.long, device=device)
    for d, off, slot in segments:
        out[off:off + slot] = d
    return out


def bsr_piece_coords(ex, name: str, piece, k_local: int):
    """Global (row, col) of every stored nonzero of one stacked bsr piece,
    traced through the plan's exchange maps: the routing the executors
    implement, rebuilt here independently of them."""
    cols, blocks = piece["block_cols"], piece["blocks"]
    P_, mb, t, bm, bk = blocks.shape
    p, i, s, r, k = (blocks != 0).nonzero().unbind(1)
    lr, lc = i * bm + r, cols[p, i, s].long() * bk + k
    m_local = ex.meta["m_local"]
    single = ex.schedule.kind == "single"
    if name == "diag":
        return (p, i, s, r, k), p * m_local + lr, p * k_local + lc
    if name == "colp":  # columns index the received B (= Y) rows
        idx = ex.b_send_idx.long()
        if single:
            q, j = lc // ex.max_b, lc % ex.max_b
            src = idx[q, p, j]
        else:
            d = _segment_shift(ex.meta["b_segments"], ex.meta["R_b"],
                               lc.device)[lc]
            if (d < 0).any():
                raise AssertionError("colp nonzero outside every B segment")
            q = (p - d) % P_
            src = idx[q, lc]
        if (src < 0).any():
            raise AssertionError("colp nonzero on a padding slot")
        return (p, i, s, r, k), p * m_local + lr, q * k_local + src
    rows = ex.c_recv_rows.long()  # rowp: rows index the partial-C rows
    if single:
        dst, j = lr // ex.max_c, lr % ex.max_c
        tgt = rows[dst, p, j]
    else:
        d = _segment_shift(ex.meta["c_segments"], ex.meta["R_c"],
                           lr.device)[lr]
        if (d < 0).any():
            raise AssertionError("rowp nonzero outside every C segment")
        dst = (p + d) % P_
        tgt = rows[dst, lr]
    if (tgt < 0).any():
        raise AssertionError("rowp nonzero on a padding slot")
    return (p, i, s, r, k), dst * m_local + tgt, p * k_local + lc


def check_sddmm_values(h, vals, a, x: torch.Tensor, y: torch.Tensor) -> float:
    """The bsr SDDMM values, piece by piece, against float64 a_ij·x_i·y_j
    at the global (i, j) each stored element maps to; the stored values
    at those coordinates must rebuild A exactly, and every other slot of
    the result must be an exact zero."""
    pieces = h.ex.pieces["bsr"]
    k_local = a.shape[1] // h.plan.P
    keys, stored, err = [], [], 0.0
    for name in ("diag", "colp", "rowp"):
        at, g_row, g_col = bsr_piece_coords(h.ex, name, pieces[name], k_local)
        got = vals[name]
        sampled = got[at].double()
        want = pieces[name]["blocks"][at].double() * (
            x[g_row].double() * y[g_col].double()).sum(dim=1)
        torch.testing.assert_close(sampled, want, rtol=2e-4, atol=2e-4,
                                   msg=lambda m: f"sddmm {name}: {m}")
        err = max(err, float((sampled - want).abs().max()))
        mask = torch.ones_like(got, dtype=torch.bool)
        mask[at] = False
        if got[mask].any():
            raise AssertionError(f"sddmm {name}: non-zero value off the "
                                 f"stored nonzeros")
        keys.append(g_row * a.shape[1] + g_col)
        stored.append(pieces[name]["blocks"][at])
    keys, order = torch.sort(torch.cat(keys))
    stored = torch.cat(stored)[order]
    # A's duplicate entries (a self-loop added to a stored diagonal) sum
    # into one block element, in CSR order, as the ELL layout builds them
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a.indptr))
    want_keys, inv = np.unique(rows * a.shape[1] + a.indices,
                               return_inverse=True)
    want_vals = np.zeros(want_keys.size, np.float32)
    np.add.at(want_vals, inv, a.data)
    if not (torch.equal(keys.cpu(), torch.from_numpy(want_keys))
            and torch.equal(stored.cpu(), torch.from_numpy(want_vals))):
        raise AssertionError("the bsr pieces' stored nonzeros do not rebuild "
                             "A through the exchange maps")
    return err


def median_gat_ms(model, feats, fused, reps: int = 7):
    """Median device time and host time of one GAT forward."""
    from repro_torch.models.gnn import gat_forward

    dev_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        gat_forward(model, feats, fused)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(host_ms)


def median_call_ms(h, b, backend: str, reps: int = 7):
    """Median device time and host time of one ``h(b)`` call."""
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        h(b, backend=backend)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(host_ms)


def profile_cells(cells) -> None:
    """torch.profiler over 3 calls per cell (``(fn, what)``, ``fn()`` one
    call): the kernels' device time as a share of the wall time (profiler
    overhead included), and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn, what in cells:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
        log(f"profile {what}: kernels busy {busy_ms:.3f} ms of "
            f"{wall_ms:.3f} ms wall per call (device idle "
            f"{100 - 100 * busy_ms / wall_ms:.1f}%)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3 / 3:8.3f} ms  "
                f"{e.count // 3:4d}x  {e.key[:70]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="small matrix; skips the full-size decision "
                             "checks")
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of one "
                             "h(b) per cell and one GAT forward per backend")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import SpmmConfig, compile_fused, compile_spmm
    from repro_torch.core.dist_spmm import flat_spmm
    from repro_torch.core.sparse import power_law_sparse, random_sparse
    from repro_torch.kernels import build, ops
    from repro_torch.models.gnn import (
        gat_forward, gat_from_numpy, normalize_adjacency,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"toolchain: {toolchain()}")

    # 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"build: K1-K5 in {time.perf_counter() - t0:.1f} s -> "
        f"{build.build()}")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    m = 16_384 if args.quick else M_FULL
    nnz = 7 * m if args.quick else NNZ_FULL
    rng = np.random.default_rng(0)
    b_host = rng.standard_normal((m, N_COLS), dtype=np.float32)
    b = torch.from_numpy(b_host).cuda()

    # 2. uniform cell: plan, then record + replay the kernels ------------
    t0 = time.perf_counter()
    a_u = random_sparse(m, m, nnz / m ** 2, seed=0)
    cfg = SpmmConfig(backends=("coo", "bsr"))
    if args.quick:
        cfg = SpmmConfig(backends=("coo", "bsr"), schedule=2, overlap=True)
    h = compile_spmm(a_u, P, cfg)
    log(f"uniform: {m}x{m}, nnz {a_u.nnz}, compile_spmm "
        f"{time.perf_counter() - t0:.1f} s: {h}")
    if not args.quick:
        check_decisions(h, EXPECT_UNIFORM, EXPECT_UNIFORM_EX, "uniform")
    for piece in ("diag", "rowp"):
        log(f"  bsr {piece} ELL: "
            f"{list(h.ex.pieces['bsr'][piece]['blocks'].shape)}")

    # the executor calls h(b, backend="bsr") and h(b) make, outside the
    # handle's cache and before the counted run
    calls = record_kernel_calls(
        lambda: flat_spmm(h.ex, b, backend="bsr", overlap=h.overlap))
    coo_calls = record_kernel_calls(
        lambda: flat_spmm(h.ex, b, backend="coo", overlap=h.overlap))
    sweep_checks()

    # 3. main path, uniform: counts from 0 over exactly these calls -------
    ops.reset_launch_counts()
    c_coo = h(b)
    check_rows(h, "uniform coo")
    c_bsr = h(b, backend="bsr")
    check_rows(h, "uniform bsr")
    c_hit = h(b)
    check_rows(h, "uniform coo (cache hit)")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"uniform main path launches: {json.dumps(launches)}")
    if min(launches[k] for k in KERNELS if k != "bsr_sddmm") < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if h.cache_info()["lowerings"] != 2 or h.cache_info()["hits"] != 1:
        raise AssertionError(f"cache: {h.cache_info()}")
    for c, what in [(c_coo, "uniform coo"), (c_bsr, "uniform bsr"),
                    (c_hit, "uniform coo (cache hit)")]:
        log(f"  {what}: max abs err vs scipy float64 "
            f"{check_c(c, a_u, b_host, what):.3g} (tol 2e-4)")
    for backend, c in (("bsr", c_bsr), ("coo", c_coo)):
        c_staged = flat_spmm(h.ex, b, backend=backend, overlap=False)
        if not torch.equal(c_staged, c):
            raise AssertionError(f"uniform {backend}: staged C != "
                                 f"overlapped C")
        log(f"  uniform {backend}: staged C bit-identical to overlapped C")
    if not torch.equal(c_hit, c_coo):
        raise AssertionError("uniform coo: two h(b) calls differ")
    log("  uniform coo: two h(b) calls bit-identical")

    # 4. power-law cell, coo ---------------------------------------------
    t0 = time.perf_counter()
    a_p = power_law_sparse(m, m, nnz, 0.8, seed=0)
    hp = compile_spmm(a_p, P, SpmmConfig(backends=("coo",)))
    log(f"power-law: {m}x{m}, nnz {a_p.nnz}, compile_spmm "
        f"{time.perf_counter() - t0:.1f} s: {hp}")
    if not args.quick:
        check_decisions(hp, EXPECT_POWERLAW, {}, "power-law")
    # the executor call hp(b) makes (K1/K2 at this cell's own shapes),
    # outside the handle's cache and before the counted run
    p_calls = record_kernel_calls(
        lambda: flat_spmm(hp.ex, b, backend="coo", overlap=hp.overlap))
    ops.reset_launch_counts()
    c_p = hp(b)
    check_rows(hp, "power-law coo")
    c_p2 = hp(b)
    torch.cuda.synchronize()
    p_launches = ops.launch_counts()
    log(f"power-law main path launches: {json.dumps(p_launches)}")
    if p_launches["gather_rows"] < 1 or p_launches["scatter_add_rows"] < 1:
        raise AssertionError(f"power-law: K1/K2 not launched: {p_launches}")
    for c, what in [(c_p, "power-law coo"), (c_p2, "power-law coo (hit)")]:
        log(f"  {what}: max abs err vs scipy float64 "
            f"{check_c(c, a_p, b_host, what):.3g} (tol 2e-4)")
    if hp.overlap:
        c_staged = flat_spmm(hp.ex, b, backend="coo", overlap=False)
        if not torch.equal(c_staged, c_p):
            raise AssertionError("power-law coo: staged C != overlapped C")
        log("  power-law coo: staged C bit-identical to overlapped C")
    if not torch.equal(c_p2, c_p):
        raise AssertionError("power-law coo: two h(b) calls differ")
    log("  power-law coo: two h(b) calls bit-identical")

    # 5. GAT on the fused handle (uniform graph) ----------------------------
    t0 = time.perf_counter()
    adj = normalize_adjacency(a_u)
    hf = compile_fused(adj, P, SpmmConfig(
        kernel="fused", edge="leaky_relu", backends=("coo", "bsr")))
    log(f"GAT graph: normalize_adjacency(uniform), nnz {adj.nnz}, "
        f"compile_fused {time.perf_counter() - t0:.1f} s: {hf}")
    if not args.quick:
        check_decisions(hf, EXPECT_FUSED, {}, "fused")
    params = gat_params(0)
    model = gat_from_numpy(params, m, device="cuda")
    feats_host = rng.standard_normal((m, GAT_DIMS["feat_dim"]),
                                     dtype=np.float32)
    feats = torch.from_numpy(feats_host).cuda()
    layer_calls = {"coo": [], "bsr": []}

    def fused_fn(backend, record=None):
        def call(q, k, v):
            c = hf(q, k, v, backend=backend)
            if record is not None:
                record.append((q, k, v, c, list(hf.comm.log)))
            return c
        return call

    # the kernel calls one forward per backend makes, before the counted
    # runs
    gat_calls = record_kernel_calls(
        lambda: gat_forward(model, feats, fused_fn("bsr")))
    gat_calls_coo = record_kernel_calls(
        lambda: gat_forward(model, feats, fused_fn("coo")))
    gat_out, gat_launches = {}, {}
    for backend in ("coo", "bsr"):
        ops.reset_launch_counts()
        gat_out[backend] = gat_forward(model, feats,
                                       fused_fn(backend, layer_calls[backend]))
        torch.cuda.synchronize()
        gat_launches[backend] = ops.launch_counts()
        log(f"GAT {backend} forward launches: "
            f"{json.dumps(gat_launches[backend])}")
    missing = [k for k in ("gather_rows", "scatter_add_rows", "bsr_spmm",
                           "bsr_sddmm") if gat_launches["bsr"][k] < 1]
    missing += [f"{k} (coo)" for k in ("gather_rows", "scatter_add_rows")
                if gat_launches["coo"][k] < 1]
    if missing:
        raise AssertionError(f"GAT path did not launch {missing}")
    want = gat_oracle(adj, params, feats_host)
    for backend in ("coo", "bsr"):
        for i, (q, k, v, c, _) in enumerate(layer_calls[backend]):
            err = check_close(c, fused_oracle(adj, _host64(q), _host64(k),
                                              _host64(v)),
                              f"GAT {backend} layer {i} C")
            log(f"  GAT {backend} layer {i} (F={q.shape[1]}, N="
                f"{v.shape[1]}): C vs scipy float64: {err}")
        err = check_close(gat_out[backend], want, f"GAT {backend} output")
        log(f"  GAT {backend} output {list(gat_out[backend].shape)} vs the "
            f"float64 forward: {err}")
        again = gat_forward(model, feats, fused_fn(backend))
        if not torch.equal(again, gat_out[backend]):
            raise AssertionError(f"GAT {backend}: two forwards differ")
        log(f"  GAT {backend}: two forwards bit-identical")
    log(f"  GAT coo vs bsr: "
        f"{check_close(gat_out['coo'], _host64(gat_out['bsr']), 'GAT coo vs bsr')}")

    # the fused log against the spmm call's on the same plan and schedule
    hf(b, kernel="spmm", backend="bsr")
    spmm_log = list(hf.comm.log)
    fused_log = layer_calls["bsr"][-1][4]
    pairs = lambda lg: {pr for _, prs, _ in lg for pr in prs}  # noqa: E731
    n_extra = (len(hf.ex.meta["c_segments"])
               if hf.schedule.kind == "bucketed" else 1)
    if pairs(fused_log) != pairs(spmm_log) or \
            len(fused_log) != len(spmm_log) + n_extra:
        raise AssertionError(f"fused log: {len(fused_log)} exchanges over "
                             f"{len(pairs(fused_log))} pairs; spmm "
                             f"{len(spmm_log)} over {len(pairs(spmm_log))}")
    log(f"  fused log: the spmm call's {len(pairs(spmm_log))} shift pairs, "
        f"{len(fused_log)} exchanges = spmm {len(spmm_log)} + {n_extra} "
        f"reversed X rounds")

    # SDDMM at a 128-wide F on bsr
    x128 = torch.randn((m, SDDMM_F), device="cuda")
    y128 = torch.randn((m, SDDMM_F), device="cuda")
    sd_calls = record_kernel_calls(
        lambda: hf(x128, y128, kernel="sddmm", backend="bsr", edge=None))
    ops.reset_launch_counts()
    vals = hf(x128, y128, kernel="sddmm", backend="bsr", edge=None)
    torch.cuda.synchronize()
    sd_launches = ops.launch_counts()
    log(f"sddmm F={SDDMM_F} bsr launches: {json.dumps(sd_launches)}")
    if sd_launches["bsr_sddmm"] < 1:
        raise AssertionError("sddmm: K5 not launched")
    err = check_sddmm_values(hf, vals, adj, x128, y128)
    log(f"  sddmm F={SDDMM_F}: values max abs err vs float64 {err:.3g} "
        f"(tol 2e-4); the stored nonzeros rebuild A through the plan's "
        f"exchange maps")

    # 6. timing --------------------------------------------------------
    # every recorded call of each path replayed against the plain version
    # and timed; a row's top level is its first path's, "paths" holds
    # each path's own numbers and max_abs_err is the worst over them
    k1k2 = {"uniform": (calls, launches), "uniform_coo": (coo_calls, launches),
            "power_law": (p_calls, p_launches),
            "gat": (gat_calls, gat_launches["bsr"]),
            "gat_coo": (gat_calls_coo, gat_launches["coo"])}
    paths = {
        "gather_rows": {**k1k2, "sddmm_f128": (sd_calls, sd_launches)},
        "scatter_add_rows": k1k2,
        "bsr_spmm": {"uniform": (calls, launches),
                     "gat": (gat_calls, gat_launches["bsr"])},
        "bsr_spmm_acc": {"uniform": (calls, launches)},
        "bsr_sddmm": {"gat": (gat_calls, gat_launches["bsr"]),
                      "sddmm_f128": (sd_calls, sd_launches)},
    }
    rows = []
    for k in KERNELS:
        per_path = {path: kernel_row(k, c[k], n[k])
                    for path, (c, n) in paths[k].items()}
        for path, r in per_path.items():
            log(f"kernel {k} {path} [{card}]: {r['ms']:.4f} ms per call "
                f"of the path over {r['calls_per_h']} launch(es), "
                f"{r['launches']} launch(es) counted, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                f"max abs err {r['max_abs_err']:.3g}")
        row = dict(next(iter(per_path.values())))
        row["max_abs_err"] = max(r["max_abs_err"] for r in per_path.values())
        row["paths"] = {
            path: {key: r[key] for key in (
                "launches", "calls_per_h", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
            for path, r in per_path.items()}
        rows.append(row)
    cells = [(h, "coo", "uniform coo"), (h, "bsr", "uniform bsr"),
             (hp, "coo", "power-law coo")]
    for handle, backend, what in cells:
        dev_ms, host_ms = median_call_ms(handle, b, backend)
        log(f"h(b) {what} [{card}]: median of 7: {dev_ms:.3f} ms device "
            f"events, {host_ms:.3f} ms host wall")
    for backend in ("coo", "bsr"):
        dev_ms, host_ms = median_gat_ms(model, feats, fused_fn(backend))
        log(f"GAT forward {backend} [{card}]: median of 7: {dev_ms:.3f} ms "
            f"device events, {host_ms:.3f} ms host wall")
    if args.profile:
        profile_cells(
            [(lambda hh=hh, be=be: hh(b, backend=be), what)
             for hh, be, what in cells]
            + [(lambda be=be: gat_forward(model, feats, fused_fn(be)),
                f"GAT forward {be}") for be in ("coo", "bsr")])
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
