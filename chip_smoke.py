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
~86 GB). Phases, each of which raises on a failed check:

1. build: nvcc builds K1–K4 from ``src/repro_torch/csrc``;
2. kernels: every kernel's calls on the main path are recorded and
   replayed against the kernel's plain torch version on the same inputs
   (K1 exact, float32 1e-5), and again at ``tests/test_kernels.py``'s
   sweeps (bfloat16 6e-2 for K3); each is timed beside its bound, its
   plain version and one PyTorch library call for the same function;
3. main path, uniform: C within 2e-4 of scipy in float64, the model's
   decisions, collective rows == ``volume_rows_padded``, staged bsr C
   bit-identical to overlapped, every kernel launched;
4. main path, power-law (coo): the same checks, and its K1/K2 calls
   replayed against their plain versions as in phase 2; coo staged vs
   overlapped is reported, not held (``index_add_`` on CUDA uses atomics);
5. timing: median ``h(b)`` per backend.

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
    from repro_torch.kernels import bsr_spmm, gather_rows, scatter_add_rows

    targets = {"gather_rows": (gather_rows, "gather_rows_cuda"),
               "scatter_add_rows": (scatter_add_rows, "scatter_add_rows_cuda"),
               "bsr_spmm": (bsr_spmm, "bsr_spmm_cuda"),
               "bsr_spmm_acc": (bsr_spmm, "bsr_spmm_acc_cuda")}
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


def kernel_row(name, calls, launches):
    """Replay one kernel's recorded calls: error vs plain, times, bound."""
    from repro_torch.kernels import bsr_spmm as k34
    from repro_torch.kernels import gather_rows as k1
    from repro_torch.kernels import scatter_add_rows as k2

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
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
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
        plain_ms += time_ms(plain, iters=3, warmup=1)
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
        torch.testing.assert_close(
            k2.scatter_add_rows_cuda(c.clone(), parts, perm, meta),
            k2.scatter_add_rows_plain(c.clone(), parts, perm, meta),
            rtol=1e-5, atol=1e-5)
    perm, meta = k2.prepare_sorted_scatter(np.full(3, -1, np.int32))
    c = torch.ones((1, 4, 8), device=dev)
    out = k2.scatter_add_rows_cuda(
        c.clone(), torch.full((1, 3, 8), 7.0, device=dev),
        torch.from_numpy(perm[None]).to(dev),
        torch.from_numpy(meta[None]).to(dev))
    if not torch.equal(out, c):
        raise AssertionError("all-pad scatter changed C")
    log(f"sweeps: K1 exact, K2 within 1e-5, K3/K4 max abs err "
        f"f32 {worst['f32']:.3g} (tol 1e-5), bf16 {worst['bf16']:.3g} "
        f"(tol 6e-2)")


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


def profile_cells(cells, b) -> None:
    """torch.profiler over 3 calls per cell: the kernels' device time as a
    share of the wall time (profiler overhead included), and the kernels
    that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for handle, backend, what in cells:
        handle(b, backend=backend)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                handle(b, backend=backend)
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
                             "h(b) per cell")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import SpmmConfig, compile_spmm
    from repro_torch.core.dist_spmm import flat_spmm
    from repro_torch.core.sparse import power_law_sparse, random_sparse
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"toolchain: {toolchain()}")

    # 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"build: K1-K4 in {time.perf_counter() - t0:.1f} s -> "
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

    # the executor call h(b, backend="bsr") makes, outside the handle's
    # cache and before the counted run
    calls = record_kernel_calls(
        lambda: flat_spmm(h.ex, b, backend="bsr", overlap=h.overlap))
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
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if h.cache_info()["lowerings"] != 2 or h.cache_info()["hits"] != 1:
        raise AssertionError(f"cache: {h.cache_info()}")
    for c, what in [(c_coo, "uniform coo"), (c_bsr, "uniform bsr"),
                    (c_hit, "uniform coo (cache hit)")]:
        log(f"  {what}: max abs err vs scipy float64 "
            f"{check_c(c, a_u, b_host, what):.3g} (tol 2e-4)")
    c_staged = flat_spmm(h.ex, b, backend="bsr", overlap=False)
    if not torch.equal(c_staged, c_bsr):
        raise AssertionError("uniform bsr: staged C != overlapped C")
    log("  uniform bsr: staged C bit-identical to overlapped C")
    c_staged = flat_spmm(h.ex, b, backend="coo", overlap=False)
    log(f"  uniform coo: staged vs overlapped torch.equal="
        f"{torch.equal(c_staged, c_coo)}, max abs diff "
        f"{float((c_staged - c_coo).abs().max()):.3g} (index_add_ atomics; "
        f"reported, not held)")

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
        log(f"  power-law coo: staged vs overlapped torch.equal="
            f"{torch.equal(c_staged, c_p)}, max abs diff "
            f"{float((c_staged - c_p).abs().max()):.3g} (reported, not held)")

    # 5. timing --------------------------------------------------------
    # every recorded call of each path replayed against the plain version
    # and timed; the row's top level is the uniform cell's, "paths" holds
    # each cell's own numbers and max_abs_err is the worst over both
    rows = []
    for k in KERNELS:
        per_path = {"uniform": kernel_row(k, calls[k], launches[k])}
        if k in ("gather_rows", "scatter_add_rows"):
            per_path["power_law"] = kernel_row(k, p_calls[k], p_launches[k])
        for path, r in per_path.items():
            log(f"kernel {k} {path} [{card}]: {r['ms']:.4f} ms per h(b) "
                f"over {r['calls_per_h']} call(s), {r['launches']} "
                f"launch(es), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, max abs err "
                f"{r['max_abs_err']:.3g}")
        row = dict(per_path["uniform"])
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
    if args.profile:
        profile_cells(cells, b)
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
