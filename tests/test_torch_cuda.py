"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one. Shapes follow ``tests/test_kernels.py``'s sweeps, with
a stacked rank axis in front. This file imports nothing of the JAX
package, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bsr_spmm as K34
from repro_torch.kernels import gather_rows as K1
from repro_torch.kernels import scatter_add_rows as K2
from repro_torch.kernels.ops import launch_counts

# decided when each test runs, never while the module is imported
requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the hand-written kernels have no CPU mode")

BSR_SHAPES = [
    # (mb, t, bm, bk, kb, n, bn)
    (2, 3, 8, 8, 4, 16, 16),
    (3, 2, 16, 8, 5, 32, 16),
    (1, 1, 8, 8, 2, 8, 8),
    (4, 5, 32, 16, 8, 64, 64),
    (2, 4, 8, 32, 4, 128, 128),
]
P = 3  # stacked ranks per launch


def _cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _bsr_inputs(shape, seed):
    mb, t, bm, bk, kb, n, _ = shape
    rng = np.random.default_rng(seed)
    cols = rng.integers(-1, kb, size=(P, mb, t)).astype(np.int32)
    blocks = rng.standard_normal((P, mb, t, bm, bk)).astype(np.float32)
    blocks[cols < 0] = 0.0
    b = rng.standard_normal((P, kb * bk, n)).astype(np.float32)
    return _cuda(cols), _cuda(blocks), _cuda(b), rng


@requires_cuda
@pytest.mark.parametrize("shape", BSR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_spmm_kernel_matches_plain(shape, dtype):
    mb, t, bm, bk, kb, n, bn = shape
    cols, blocks, b, _ = _bsr_inputs(shape, sum(shape))
    blocks, b = blocks.to(dtype), b.to(dtype)
    m_out = mb * bm - 3
    before = launch_counts()["bsr_spmm"]
    out = K34.bsr_spmm_cuda(cols, blocks, b, m_out, bn=bn)
    torch.cuda.synchronize()
    assert launch_counts()["bsr_spmm"] == before + 1
    ref = K34.bsr_spmm_plain(cols, blocks, b, m_out)
    tol = 1e-5 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@requires_cuda
@pytest.mark.parametrize("shape", BSR_SHAPES)
def test_bsr_spmm_acc_kernel_matches_plain_and_chains(shape):
    """K4 equals its plain version, and folding a piece's t-slots one K4
    call after another gives the bits of one K3 call."""
    mb, t, bm, bk, kb, n, bn = shape
    cols, blocks, b, rng = _bsr_inputs(shape, sum(shape) + 1)
    acc0 = _cuda(rng.standard_normal((P, mb * bm, n)).astype(np.float32))
    out = K34.bsr_spmm_acc_cuda(cols, blocks, b, acc0.clone(), bn=bn)
    ref = K34.bsr_spmm_acc_plain(cols, blocks, b, acc0.clone())
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)

    whole = K34.bsr_spmm_cuda(cols, blocks, b, mb * bm, bn=bn)
    acc = torch.zeros_like(whole)
    for s in range(t):
        K34.bsr_spmm_acc_cuda(cols[:, :, s:s + 1].contiguous(),
                              blocks[:, :, s:s + 1].contiguous(), b, acc,
                              bn=bn)
    assert torch.equal(acc, whole)


@requires_cuda
@pytest.mark.parametrize("K,n,S", [(16, 8, 5), (64, 32, 20), (8, 128, 3),
                                   (128, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_kernel_matches_plain(K, n, S, dtype):
    rng = np.random.default_rng(K * 1000 + S)
    b = _cuda(rng.standard_normal((P, K, n)).astype(np.float32)).to(dtype)
    idx = _cuda(rng.integers(-1, K, size=(P, S)).astype(np.int32))
    out = K1.gather_rows_cuda(b, idx)
    assert torch.equal(out, K1.gather_rows_plain(b, idx))


@requires_cuda
@pytest.mark.parametrize("M,n,S", [(8, 16, 12), (16, 8, 30), (4, 8, 6),
                                   (32, 128, 100)])
def test_scatter_add_kernel_matches_plain(M, n, S):
    rng = np.random.default_rng(M * 77 + S)
    c = _cuda(rng.standard_normal((P, M, n)).astype(np.float32))
    parts = _cuda(rng.standard_normal((P, S, n)).astype(np.float32))
    tgt = rng.integers(-1, M, size=(P, S)).astype(np.int32)
    prep = [K2.prepare_sorted_scatter(tgt[p]) for p in range(P)]
    perm = _cuda(np.stack([pm for pm, _ in prep]))
    meta = _cuda(np.stack([mt for _, mt in prep]))
    out = K2.scatter_add_rows_cuda(c.clone(), parts, perm, meta)
    ref = K2.scatter_add_rows_plain(c.clone(), parts, perm, meta)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@requires_cuda
def test_scatter_add_kernel_all_pads_leaves_c():
    c = torch.ones((P, 4, 8), device="cuda")
    parts = torch.full((P, 3, 8), 7.0, device="cuda")
    perm, meta = K2.prepare_sorted_scatter(np.full(3, -1, np.int32))
    perm = _cuda(np.stack([perm] * P))
    meta = _cuda(np.stack([meta] * P))
    out = K2.scatter_add_rows_cuda(c.clone(), parts, perm, meta)
    assert torch.equal(out, c)


def test_kernels_reject_cpu_operands():
    b = torch.zeros((1, 4, 8))
    idx = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K1.gather_rows_cuda(b, idx)
