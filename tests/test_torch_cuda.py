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
from repro_torch.kernels import rmsnorm as K6
from repro_torch.kernels import sddmm as K5
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


def _sparse_bsr_inputs(bm, bk, n, seed, mb=6, t=9, kb=7):
    """ELL pieces as sparse as the main path's: one nonzero per stored
    block (so all-zero rows and A columns), a few blocks with two or three
    nonzero columns, a stored all-zero block, pad slots in the middle of a
    row's slots, a block-row of pads only, and B rows ending inside the
    last block column (K = kb * bk - 3)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, kb, size=(P, mb, t)).astype(np.int32)
    cols[:, :, [2, 5, 6]] = -1
    cols[:, 1] = -1
    cols[:, 3, 0] = kb - 1
    blocks = np.zeros((P, mb, t, bm, bk), np.float32)
    for idx in zip(*np.nonzero(cols >= 0)):
        blocks[idx + (rng.integers(bm), rng.integers(bk))] = rng.standard_normal()
    blocks[:, 0, 0, :, [1, bk - 1]] = rng.standard_normal((2, P, bm))
    blocks[:, 2, 1, 3, :] = rng.standard_normal((P, bk))
    cols[:, 4, 3] = 0
    blocks[:, 4, 3] = 0.0  # stored zeros
    K = kb * bk - 3
    b = rng.standard_normal((P, K, n)).astype(np.float32)
    return cols, blocks, b


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts one element past an
    aligned address (16-byte loads would misalign)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@requires_cuda
@pytest.mark.parametrize("block", [(8, 8), (16, 16), (8, 32)], ids=str)
@pytest.mark.parametrize("n", [1, 40, 128, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernels_on_sparse_blocks_and_ragged_widths(block, n, dtype):
    """K3 and K4 on blocks with about one nonzero each, at ragged widths,
    with B aligned and one element off: the plain version within the
    kernels' tolerance, and the unaligned (one element at a time) access
    giving the bits of the vector access."""
    bm, bk = block
    cols, blocks, b = _sparse_bsr_inputs(bm, bk, n, bm * bk + n)
    cols, blocks = _cuda(cols), _cuda(blocks)
    b = _cuda(b).to(dtype)
    m_out = cols.shape[1] * bm - 5
    tol = 1e-5 if dtype == torch.float32 else 6e-2
    before = launch_counts()["bsr_spmm"]
    out = K34.bsr_spmm_cuda(cols, blocks, b, m_out)
    torch.cuda.synchronize()
    assert launch_counts()["bsr_spmm"] == before + 1
    ref = K34.bsr_spmm_plain(cols, blocks, b, m_out)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(K34.bsr_spmm_cuda(cols, blocks, _misaligned(b), m_out),
                       out)
    rng = np.random.default_rng(n)
    acc0 = _cuda(rng.standard_normal((P, m_out, n)).astype(np.float32)
                 ).to(dtype)
    got = K34.bsr_spmm_acc_cuda(cols, blocks, b, acc0.clone())
    want = K34.bsr_spmm_acc_plain(cols, blocks, b, acc0.clone())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    acc_off = _misaligned(acc0)
    K34.bsr_spmm_acc_cuda(cols, blocks, _misaligned(b), acc_off)
    assert torch.equal(acc_off, got)


@requires_cuda
@pytest.mark.parametrize("block", [(8, 8), (16, 8)], ids=str)
def test_bsr_kernels_skip_non_finite_rows_of_zero_columns(block):
    """An inf, a -inf and a NaN in B rows whose A column is zero in some
    stored blocks and nonzero in others: K3 and K4 leave the zero columns
    out, as their plain version does, so the same entries are NaN and inf
    in both and the finite ones agree within float32 1e-5."""
    bm, bk = block
    cols, blocks, b = _sparse_bsr_inputs(bm, bk, 40, 3 * bm + bk)
    rng = np.random.default_rng(bm)
    for v in (np.inf, -np.inf, np.nan):
        b[:, rng.integers(b.shape[1], size=4), rng.integers(40, size=4)] = v
    cols, blocks, b = _cuda(cols), _cuda(blocks), _cuda(b)
    m_out = cols.shape[1] * bm - 5
    acc0 = _cuda(rng.standard_normal((P, m_out, 40)).astype(np.float32))
    runs = [(K34.bsr_spmm_cuda(cols, blocks, b, m_out),
             K34.bsr_spmm_plain(cols, blocks, b, m_out)),
            (K34.bsr_spmm_acc_cuda(cols, blocks, b, acc0.clone()),
             K34.bsr_spmm_acc_plain(cols, blocks, b, acc0.clone()))]
    torch.cuda.synchronize()
    for out, ref in runs:
        assert torch.equal(out.isnan(), ref.isnan())
        assert torch.equal(out.isinf(), ref.isinf())
        assert torch.equal(out.isinf() & (out > 0), ref.isinf() & (ref > 0))
        fin = out.isfinite()
        torch.testing.assert_close(out[fin], ref[fin], rtol=1e-5, atol=1e-5)
        assert bool(fin.any()) and not bool(fin.all())
    # some inf or NaN met only zero columns: those entries stay finite
    dense_bad = torch.zeros_like(runs[0][0], dtype=torch.bool)
    bad_row = ~b.isfinite()
    kb = (b.shape[1] + bk - 1) // bk
    pad = torch.zeros((P, kb * bk - b.shape[1], 40), dtype=torch.bool,
                      device="cuda")
    bad_blk = torch.cat([bad_row, pad], 1).view(P, kb, bk, 40).any(2)
    for s in range(cols.shape[2]):
        c = cols[:, :, s].long()
        hit = torch.where((c >= 0)[..., None],
                          bad_blk[torch.arange(P, device="cuda")[:, None],
                                  c.clamp(min=0)], False)
        dense_bad |= hit.repeat_interleave(bm, 1)[:, :m_out]
    assert bool((dense_bad & runs[0][0].isfinite()).any())


@requires_cuda
@pytest.mark.parametrize("block", [(8, 8), (16, 8)], ids=str)
@pytest.mark.parametrize("n", [40, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_acc_slot_by_slot_equals_one_call_on_sparse_blocks(block, n,
                                                               dtype):
    """K4 over the stored slots one call at a time gives the bits of one
    K3 call, on inputs as sparse as the main path's (in bfloat16 the
    accumulator is float32, as the executor keeps it)."""
    bm, bk = block
    cols, blocks, b = (_cuda(x) for x in _sparse_bsr_inputs(bm, bk, n, n))
    b = b.to(dtype)
    m_out = cols.shape[1] * bm
    whole = K34.bsr_spmm_cuda(cols, blocks, b.float(), m_out)
    acc = torch.zeros_like(whole)
    for s in range(cols.shape[2]):
        K34.bsr_spmm_acc_cuda(cols[:, :, s:s + 1].contiguous(),
                              blocks[:, :, s:s + 1].contiguous(), b.float(),
                              acc)
    assert torch.equal(acc, whole)


def _scatter_case(tgt, n, dtype, seed):
    rng = np.random.default_rng(seed)
    M = int(tgt.max()) + 3
    S = tgt.shape[1]
    c = _cuda(rng.standard_normal((P, M, n)).astype(np.float32)).to(dtype)
    parts = _cuda(rng.standard_normal((P, S, n)).astype(np.float32)
                  ).to(dtype)
    prep = [K2.prepare_sorted_scatter(t) for t in tgt]
    perm = _cuda(np.stack([pm for pm, _ in prep]))
    meta = _cuda(np.stack([mt for _, mt in prep]))
    return c, parts, perm, meta


@requires_cuda
@pytest.mark.parametrize("n", [40, 128, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_kernel_hub_segment(n, dtype):
    """One target takes 5,000 of 6,000 slots (longer than any unit's
    batch or stage), the rest spread over 40 rows, some slots pads: the
    kernel folds the same chain as the plain version."""
    rng = np.random.default_rng(n)
    tgt = rng.integers(-1, 40, size=(P, 6000)).astype(np.int32)
    for p in range(P):
        tgt[p, rng.permutation(6000)[:5000]] = 7 + p
    c, parts, perm, meta = _scatter_case(tgt, n, dtype, n + 1)
    before = launch_counts()["scatter_add_rows"]
    out = K2.scatter_add_rows_cuda(c.clone(), parts, perm, meta)
    torch.cuda.synchronize()
    assert launch_counts()["scatter_add_rows"] == before + 1
    assert torch.equal(out, K2.scatter_add_rows_plain(c.clone(), parts,
                                                      perm, meta))


@requires_cuda
@pytest.mark.parametrize("n", [40, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_kernel_segments_straddle_unit_edges(n, dtype):
    """Segments of 1 to 300 slots placed across the 32-slot warp and
    256-slot block edges and around the one-warp length limit, with C and
    the partials one element off an aligned address."""
    runs = [31, 1, 33, 64, 65, 63, 2, 200, 256, 257, 3, 32, 300, 5, 66]
    tgt = np.repeat(np.arange(len(runs), dtype=np.int32) * 2, runs)
    tgt = np.stack([np.concatenate([tgt[p:], np.full(p, -1, np.int32)])
                    for p in range(P)])
    c, parts, perm, meta = _scatter_case(tgt, n, dtype, n)
    want = K2.scatter_add_rows_plain(c.clone(), parts, perm, meta)
    assert torch.equal(K2.scatter_add_rows_cuda(c.clone(), parts, perm, meta),
                       want)
    c_off = _misaligned(c)
    K2.scatter_add_rows_cuda(c_off, _misaligned(parts), perm, meta)
    assert torch.equal(c_off, want)


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


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of a float32 / bfloat16 tensor (so -0.0 != +0.0)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _k1_both_forms(b, idx, val, what):
    """Both K1 forms against their plain versions, bit for bit (the scaled
    form into b's dtype and into float32), each call counting one launch;
    returns the pack and the scaled outputs."""
    before = launch_counts()
    pack = K1.gather_rows_cuda(b, idx)
    scaled = {dt: K1.gather_rows_scaled_cuda(b, idx, val, dt)
              for dt in dict.fromkeys((b.dtype, torch.float32))}
    torch.cuda.synchronize()
    after = launch_counts()
    launched = 1 if idx.numel() and b.shape[-1] else 0
    assert after["gather_rows"] == before["gather_rows"] + launched, what
    assert after["gather_rows_scaled"] == (
        before["gather_rows_scaled"] + len(scaled) * launched), what
    assert torch.equal(_bits(pack), _bits(K1.gather_rows_plain(b, idx))), what
    for dt, got in scaled.items():
        want = K1.gather_rows_scaled_plain(b, idx, val, dt)
        assert got.dtype == dt and got.shape == want.shape, what
        assert torch.equal(_bits(got), _bits(want)), f"{what} -> {dt}"
    return pack, scaled[b.dtype]


K1_WIDTHS = [1, 3, 16, 40, 128, 130, 256, 2048]


@requires_cuda
@pytest.mark.parametrize("n", K1_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ranks", [1, 8])
def test_gather_rows_both_forms_match_plain(n, dtype, ranks):
    """Both K1 forms at the path's widths and ragged ones: random slots with
    pads and negative values (a pad times a negative value is -0.0), no
    slots, all pads, one hub index repeated 3,000 times, and b one element
    off a 16-byte boundary (the element instance, the same bits)."""
    gen = torch.Generator("cuda").manual_seed(n * 10 + ranks)
    K = 300
    b = torch.randn((ranks, K, n), device="cuda", generator=gen).to(dtype)
    cases = {
        "random": torch.randint(-1, K, (ranks, 700), device="cuda",
                                generator=gen, dtype=torch.int32),
        "no slots": torch.zeros((ranks, 0), device="cuda", dtype=torch.int32),
        "all pads": torch.full((ranks, 50), -1, device="cuda",
                               dtype=torch.int32),
        "hub": torch.full((ranks, 3000), 17, device="cuda",
                          dtype=torch.int32),
    }
    for what, idx in cases.items():
        val = torch.randn(idx.shape, device="cuda", generator=gen)
        pack, scaled = _k1_both_forms(b, idx, val, f"{what} n={n}")
        if what == "all pads":
            assert not pack.any() and not pack.signbit().any()
            assert torch.equal(scaled.signbit(), (val < 0)[..., None].expand(
                scaled.shape))
        if what == "random":
            off = _misaligned(b)
            off_pack, off_scaled = _k1_both_forms(off, idx, val,
                                                  f"misaligned n={n}")
            assert torch.equal(_bits(off_pack), _bits(pack))
            assert torch.equal(_bits(off_scaled), _bits(scaled))


@requires_cuda
@pytest.mark.parametrize("n", [3, 128])
def test_gather_rows_many_blocks_and_non_finite_rows(n):
    """300,000 slots of one rank (thousands of blocks in the grid) over b
    rows holding an inf, a -inf and a NaN: both forms as their plain
    versions (NaN where the plain version has NaN, the same bits
    elsewhere)."""
    gen = torch.Generator("cuda").manual_seed(n)
    K, S = 1000, 300_000
    b = torch.randn((1, K, n), device="cuda", generator=gen)
    b[0, 3, 0], b[0, 5, n - 1], b[0, 7, n // 2] = (float("inf"),
                                                   float("-inf"),
                                                   float("nan"))
    idx = torch.randint(-1, K, (1, S), device="cuda", generator=gen,
                        dtype=torch.int32)
    idx[0, :3] = torch.tensor([3, 5, 7], dtype=torch.int32)
    val = torch.randn((1, S), device="cuda", generator=gen)
    val[0, 10] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        bb = b.to(dtype)
        pack = K1.gather_rows_cuda(bb, idx)
        want = K1.gather_rows_plain(bb, idx)
        assert torch.equal(pack.isnan(), want.isnan())
        assert torch.equal(_bits(pack)[~pack.isnan()],
                           _bits(want)[~want.isnan()])
        for dt in (dtype, torch.float32):
            got = K1.gather_rows_scaled_cuda(bb, idx, val, dt)
            want = K1.gather_rows_scaled_plain(bb, idx, val, dt)
            torch.cuda.synchronize()
            assert bool(got.isnan().any())
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(_bits(got)[~got.isnan()],
                               _bits(want)[~want.isnan()])


@requires_cuda
def test_gather_rows_scaled_rejects_what_it_does_not_take():
    b = torch.zeros((1, 4, 8), device="cuda")
    idx = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        K1.gather_rows_scaled_cuda(b, idx, torch.zeros((1, 2), device="cuda",
                                                       dtype=torch.float64),
                                   torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K1.gather_rows_scaled_cuda(b, idx, torch.zeros((1, 2), device="cuda"),
                                   torch.float16)
    with pytest.raises(ValueError, match="val must be"):
        K1.gather_rows_scaled_cuda(b, idx, torch.zeros((1, 3), device="cuda"),
                                   torch.float32)


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
    assert torch.equal(out, ref)  # one slot-order chain in both


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
    with pytest.raises(ValueError, match="CUDA"):
        K1.gather_rows_scaled_cuda(b, idx, torch.zeros((1, 2)),
                                   torch.float32)


SDDMM_SHAPES = [
    # (mb, t, bm, bk, kb, F): F 1, 16, 33, 128, an empty piece, 16x8 blocks
    (3, 4, 8, 8, 5, 1),
    (4, 3, 8, 8, 6, 16),
    (2, 5, 8, 8, 4, 33),
    (3, 2, 8, 8, 3, 128),
    (4, 0, 8, 8, 3, 16),
    (2, 3, 16, 8, 4, 24),
]


@requires_cuda
@pytest.mark.parametrize("shape", SDDMM_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_sddmm_kernel_matches_plain(shape, dtype):
    mb, t, bm, bk, kb, f = shape
    rng = np.random.default_rng(sum(shape))
    cols = rng.integers(-1, kb, size=(P, mb, t)).astype(np.int32)
    if t:
        cols[:, 0] = -1  # all-pad block rows
    blocks = rng.standard_normal((P, mb, t, bm, bk)).astype(np.float32)
    blocks[cols < 0] = 0.0
    x3 = _cuda(rng.standard_normal((P, mb, bm, f)).astype(np.float32))
    y3 = _cuda(rng.standard_normal((P, kb, bk, f)).astype(np.float32))
    cols, blocks = _cuda(cols), _cuda(blocks)
    x3, y3 = x3.to(dtype), y3.to(dtype)
    before = launch_counts()["bsr_sddmm"]
    out = K5.bsr_sddmm_cuda(cols, blocks, x3, y3)
    torch.cuda.synchronize()
    assert launch_counts()["bsr_sddmm"] == before + (1 if t else 0)
    assert out.dtype == torch.float32 and out.shape == blocks.shape
    # the plain version repeats the kernel's chain: the same bits
    assert torch.equal(out, K5.bsr_sddmm_plain(cols, blocks, x3, y3))
    assert not out[cols < 0].any()  # pad slots are exact zeros


def _sparse_sddmm_inputs(block, f, seed, mb=5, t=37, kb=6):
    """Stored blocks of one nonzero, every fifth a denser block with stored
    zeros among its entries, an all-zero stored block (slot 2) and pads in
    the middle of rows; t = 37 crosses the 8x8 kernel's 32-slot column
    prefetch and its 8-slot groups."""
    bm, bk = block
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, kb, size=(P, mb, t)).astype(np.int32)
    cols[..., 1::4] = -1
    blocks = np.zeros((P, mb, t, bm, bk), np.float32)
    p, i, s = np.meshgrid(np.arange(P), np.arange(mb), np.arange(t),
                          indexing="ij")
    blocks[p, i, s, rng.integers(0, bm, p.shape),
           rng.integers(0, bk, p.shape)] = rng.standard_normal(p.shape)
    dense = rng.standard_normal(blocks.shape).astype(np.float32)
    dense *= rng.random(blocks.shape) < 0.6
    blocks[:, :, 3::5] = dense[:, :, 3::5]
    blocks[:, :, 2] = 0.0
    cols[:, :, 2] = 0
    blocks[cols < 0] = 0.0
    x3 = rng.standard_normal((P, mb, bm, f)).astype(np.float32)
    y3 = rng.standard_normal((P, kb, bk, f)).astype(np.float32)
    return _cuda(cols), _cuda(blocks), _cuda(x3), _cuda(y3)


def _off_by_one(t: torch.Tensor) -> torch.Tensor:
    """The same values in a contiguous view one element past an aligned
    start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@requires_cuda
@pytest.mark.parametrize("block", [(8, 8), (16, 8)], ids=str)
@pytest.mark.parametrize("f", [1, 16, 33, 128, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_sddmm_kernel_on_sparse_blocks(block, f, dtype):
    cols, blocks, x3, y3 = _sparse_sddmm_inputs(block, f, f + block[0])
    x3, y3 = x3.to(dtype), y3.to(dtype)
    out = K5.bsr_sddmm_cuda(cols, blocks, x3, y3)
    shifted = K5.bsr_sddmm_cuda(cols, blocks, _off_by_one(x3),
                                _off_by_one(y3))
    torch.cuda.synchronize()
    assert torch.equal(out, K5.bsr_sddmm_plain(cols, blocks, x3, y3))
    # one element off alignment takes the element-wise loads: same bits
    assert torch.equal(shifted.view(torch.int32), out.view(torch.int32))
    zero = blocks == 0  # stored zeros, the all-zero block and the pads
    assert not out[zero].any() and not out[zero].signbit().any()
    assert bool(out[~zero].ne(0).all())


@requires_cuda
@pytest.mark.parametrize("block", [(8, 8), (16, 8)], ids=str)
def test_bsr_sddmm_zero_entries_skip_non_finite_rows(block):
    """A stored zero writes +0.0 without forming its dot, so an inf in a Y
    row reaches only the nonzero entries that use it."""
    cols, blocks, x3, y3 = _sparse_sddmm_inputs(block, 16, 7)
    y3[:, :, 0, 3] = float("inf")  # row 0 of every block column
    out = K5.bsr_sddmm_cuda(cols, blocks, x3, y3)
    ref = K5.bsr_sddmm_plain(cols, blocks, x3, y3)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    zero = blocks == 0
    assert torch.equal(out[zero], torch.zeros_like(out[zero]))
    assert not out[zero].signbit().any()
    assert not bool(out[~zero].isfinite().all())  # the inf reached some


@requires_cuda
def test_bsr_sddmm_kernel_rounds_each_fma_once():
    """acc = 64 + 2⁻¹⁷ then x·y = 2⁻¹⁸ − 2⁻⁶⁴: ``__fmaf_rn`` keeps acc, as
    the plain version does (two roundings would give 64 + 2⁻¹⁶)."""
    acc0 = 64 + 2.0 ** -17
    x3 = torch.tensor([acc0, 2.0 ** -9 * (1 + 2.0 ** -23)]).expand(
        1, 1, 8, 2).contiguous().cuda()
    y3 = torch.tensor([1.0, 2.0 ** -9 * (1 - 2.0 ** -23)]).expand(
        1, 1, 8, 2).contiguous().cuda()
    cols = torch.zeros((1, 1, 1), dtype=torch.int32, device="cuda")
    blocks = torch.ones((1, 1, 1, 8, 8), device="cuda")
    out = K5.bsr_sddmm_cuda(cols, blocks, x3, y3)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, acc0))
    assert torch.equal(out, K5.bsr_sddmm_plain(cols, blocks, x3, y3))


def _executor_case():
    from repro_torch.core import comm_schedule, dist_spmm, planner, sparse

    a = sparse.power_law_sparse(512, 512, 6000, 1.2, seed=2)
    plan = planner.build_plan(a, 8)
    ex = dist_spmm.flat_exec_arrays(
        plan, backends=("coo", "bsr"),
        schedule=comm_schedule.build_comm_schedule(plan, K=4)).to("cuda")
    return a, ex


@requires_cuda
def test_coo_overlapped_bit_identical_on_the_card():
    """The coo fold (K1's scaled gather, K2 sorted fold) has no atomics:
    overlapped C equals staged C bit for bit, and two calls give the same
    bits."""
    from repro_torch.core.dist_spmm import flat_spmm

    a, ex = _executor_case()
    b = torch.randn((512, 64), device="cuda")
    staged = flat_spmm(ex, b, backend="coo")
    over = flat_spmm(ex, b, backend="coo", overlap=True)
    again = flat_spmm(ex, b, backend="coo", overlap=True)
    torch.cuda.synchronize()
    assert torch.equal(over, staged) and torch.equal(again, over)
    want = a.to_dense().astype(np.float64) @ b.double().cpu().numpy()
    np.testing.assert_allclose(staged.cpu().numpy(), want, rtol=2e-4,
                               atol=2e-4)


@requires_cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_coo_path_launches_the_scaled_gather_and_no_multiply(overlap):
    """Each coo piece is one K1 scaled launch and one K2 fold: the B pack
    is K1's pack form, and no elementwise multiply runs on the path."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.dist_spmm import flat_spmm

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    a, ex = _executor_case()
    b = torch.randn((512, 64), device="cuda")
    before = launch_counts()
    with Ops() as seen:
        c = flat_spmm(ex, b, backend="coo", overlap=overlap)
    torch.cuda.synchronize()
    after = launch_counts()
    pieces = 3 if not overlap else 1 + len(ex.meta["c_segments"]) + len(
        ex.meta["b_segments"])
    assert after["gather_rows_scaled"] - before["gather_rows_scaled"] == pieces
    assert after["gather_rows"] - before["gather_rows"] == 1  # the B pack
    assert not [n for n in seen.names if "mul" in n], seen.names
    want = a.to_dense().astype(np.float64) @ b.double().cpu().numpy()
    np.testing.assert_allclose(c.cpu().numpy(), want, rtol=2e-4, atol=2e-4)


@requires_cuda
def test_flat_fused_bsr_repeats_bit_for_bit():
    from repro_torch.core.dist_sddmm import flat_fused

    a, ex = _executor_case()
    x, y = torch.randn((512, 16), device="cuda"), \
        torch.randn((512, 16), device="cuda")
    b = torch.randn((512, 32), device="cuda")
    before = launch_counts()
    c1 = flat_fused(ex, x, y, b, backend="bsr", edge="leaky_relu")
    c2 = flat_fused(ex, x, y, b, backend="bsr", edge="leaky_relu")
    torch.cuda.synchronize()
    after = launch_counts()
    assert torch.equal(c1, c2)
    for k in ("gather_rows", "scatter_add_rows", "bsr_spmm", "bsr_sddmm"):
        assert after[k] > before[k], k
    s = a.to_dense().astype(np.float64) * (
        x.double().cpu().numpy() @ y.double().cpu().numpy().T)
    want = np.where(s > 0, s, 0.2 * s) @ b.double().cpu().numpy()
    np.testing.assert_allclose(c1.cpu().numpy(), want, rtol=2e-4, atol=2e-4)


def _hier_case(G, L, K):
    """A hier exec plan on the CPU and its copy on the card."""
    from repro_torch.core import (
        comm_schedule, dist_spmm, hierarchy, planner, sparse,
    )

    a = sparse.power_law_sparse(512, 512, 6000, 1.2, seed=2)
    hier = hierarchy.build_hier_plan(planner.build_plan(a, G * L), G, L)
    sched = None if K is None else comm_schedule.build_hier_comm_schedule(
        hier, K=K)
    ex = dist_spmm.hier_exec_arrays(hier, backends=("coo", "bsr"),
                                    schedule=sched)
    return a, ex, ex.to("cuda")


HIER_CASES = [(2, 4, None), (2, 4, 1), (4, 2, None), (4, 2, 4)]


@requires_cuda
@pytest.mark.parametrize("G,L,K", HIER_CASES, ids=str)
@pytest.mark.parametrize("backend", ["coo", "bsr"])
def test_hier_spmm_on_the_card_matches_cpu(G, L, K, backend):
    """The two-tier executor through the kernels: C within 2e-4 of the
    CPU run of the plain versions (and of float64), overlapped == staged
    and call == call bit for bit, the same collective log as the CPU."""
    from repro_torch.core.dist_spmm import hier_spmm
    from repro_torch.distributed.comm import LocalComm

    a, ex_cpu, ex = _hier_case(G, L, K)
    b = torch.randn((512, 64), device="cuda")
    before = launch_counts()
    comm = LocalComm(G * L, G)
    staged = hier_spmm(ex, b, comm, backend=backend)
    again = hier_spmm(ex, b, backend=backend)
    torch.cuda.synchronize()
    after = launch_counts()
    kernels = ("gather_rows", "scatter_add_rows") + (
        ("gather_rows_scaled",) if backend == "coo" else ("bsr_spmm",))
    for k in kernels:
        assert after[k] > before[k], k
    assert torch.equal(again, staged)
    cpu_comm = LocalComm(G * L, G)
    cpu = hier_spmm(ex_cpu, b.cpu(), cpu_comm, backend=backend)
    assert comm.log == cpu_comm.log
    np.testing.assert_allclose(staged.cpu().numpy(), cpu.numpy(), rtol=2e-4,
                               atol=2e-4)
    want = a.to_dense().astype(np.float64) @ b.double().cpu().numpy()
    np.testing.assert_allclose(staged.cpu().numpy(), want, rtol=2e-4,
                               atol=2e-4)
    if K is not None:
        before = launch_counts()["bsr_spmm_acc"]
        over = hier_spmm(ex, b, backend=backend, overlap=True)
        torch.cuda.synchronize()
        assert torch.equal(over, staged)
        if backend == "bsr":
            assert launch_counts()["bsr_spmm_acc"] > before


@requires_cuda
@pytest.mark.parametrize("G,L,K", HIER_CASES, ids=str)
@pytest.mark.parametrize("backend", ["coo", "bsr"])
def test_hier_fused_on_the_card_matches_cpu(G, L, K, backend):
    from repro_torch.core.dist_sddmm import hier_fused

    a, ex_cpu, ex = _hier_case(G, L, K)
    x, y = torch.randn((512, 16), device="cuda"), \
        torch.randn((512, 16), device="cuda")
    b = torch.randn((512, 32), device="cuda")
    before = launch_counts()
    c1 = hier_fused(ex, x, y, b, backend=backend, edge="leaky_relu")
    c2 = hier_fused(ex, x, y, b, backend=backend, edge="leaky_relu")
    torch.cuda.synchronize()
    after = launch_counts()
    assert torch.equal(c1, c2)
    if backend == "bsr":
        assert after["bsr_sddmm"] > before["bsr_sddmm"]
    cpu = hier_fused(ex_cpu, x.cpu(), y.cpu(), b.cpu(), backend=backend,
                     edge="leaky_relu")
    np.testing.assert_allclose(c1.cpu().numpy(), cpu.numpy(), rtol=2e-4,
                               atol=2e-4)
    s = a.to_dense().astype(np.float64) * (
        x.double().cpu().numpy() @ y.double().cpu().numpy().T)
    want = np.where(s > 0, s, 0.2 * s) @ b.double().cpu().numpy()
    np.testing.assert_allclose(c1.cpu().numpy(), want, rtol=2e-4, atol=2e-4)


@requires_cuda
@pytest.mark.parametrize("c", [2, 4])
@pytest.mark.parametrize("backend", ["coo", "bsr"])
def test_replicated_spmm_on_the_card_matches_cpu(c, backend):
    """The 1.5D executor through the kernels: on coo C equals the CPU run
    of the plain versions bit for bit (K1's scaled form and K2 keep one
    chain), on bsr within float32 1e-5 (K3's FMAs); within 2e-4 of
    float64; call == call; the same collective log as the CPU."""
    from repro_torch.core import comm_schedule, dist_spmm, planner, sparse
    from repro_torch.distributed.comm import LocalComm

    a = sparse.power_law_sparse(512, 512, 6000, 1.2, seed=2)
    rp = planner.replicate_plan(planner.build_plan(a, 8 // c), c)
    ex_cpu = dist_spmm.replicated_exec_arrays(
        rp, backends=("coo", "bsr"),
        schedule=comm_schedule.build_replicated_schedule(rp))
    ex = ex_cpu.to("cuda")
    b = torch.randn((512, 64), device="cuda")
    before = launch_counts()
    comm = LocalComm(8, replicas=c)
    out = dist_spmm.replicated_spmm(ex, b, comm, backend=backend)
    again = dist_spmm.replicated_spmm(ex, b, backend=backend)
    torch.cuda.synchronize()
    after = launch_counts()
    kernels = ("gather_rows", "scatter_add_rows") + (
        ("gather_rows_scaled",) if backend == "coo" else ("bsr_spmm",))
    for k in kernels:
        assert after[k] > before[k], k
    assert torch.equal(again, out)
    cpu_comm = LocalComm(8, replicas=c)
    cpu = dist_spmm.replicated_spmm(ex_cpu, b.cpu(), cpu_comm,
                                    backend=backend)
    assert comm.log == cpu_comm.log
    assert comm.rows("s") == ex.schedule.volume_rows_padded()
    if backend == "coo":
        assert torch.equal(out.cpu(), cpu)
    else:
        torch.testing.assert_close(out.cpu(), cpu, rtol=1e-5, atol=1e-5)
    want = a.to_dense().astype(np.float64) @ b.double().cpu().numpy()
    np.testing.assert_allclose(out.cpu().numpy(), want, rtol=2e-4,
                               atol=2e-4)


@requires_cuda
@pytest.mark.parametrize("c", [2, 4])
def test_replica_collectives_on_cuda_equal_cpu(c):
    """The lane exchange is a copy and the replica fold a fixed chain of
    float additions: on the card they give the CPU's bits."""
    from repro_torch.distributed.comm import LocalComm

    s = 8 // c
    gen = torch.Generator().manual_seed(c)
    x = torch.randn((8, 2 * c, 5), generator=gen) * torch.exp(
        4 * torch.randn((8, 2 * c, 1), generator=gen))
    cpu, card = LocalComm(8, replicas=c), LocalComm(8, replicas=c)
    xc = x.cuda()
    shifts = tuple(1 + r % (s - 1) for r in range(c))
    pairs = [
        (cpu.replica_psum_scatter(x), card.replica_psum_scatter(xc)),
        (cpu.lane_shift(x, shifts, range(c)),
         card.lane_shift(xc, shifts, range(c))),
        (cpu.lane_shift(x, shifts, (c - 1,)),
         card.lane_shift(xc, shifts, (c - 1,))),
        (cpu.replicate(x[:s]), card.replicate(xc[:s])),
    ]
    for want, got in pairs:
        assert got.is_cuda and torch.equal(got.cpu(), want)
    assert card.log == cpu.log


@requires_cuda
@pytest.mark.parametrize("G", [2, 4])
def test_grid_collectives_on_cuda_equal_cpu(G):
    """Every grid collective is a device copy or a fixed chain of float
    additions: on the card it gives the CPU's bits."""
    from repro_torch.distributed.comm import LocalComm

    P_, L = 8, 8 // G
    gen = torch.Generator().manual_seed(G)
    x = torch.randn((P_, G, 3 * L, 5), generator=gen) * torch.exp(
        4 * torch.randn((P_, G, 3 * L, 1), generator=gen))
    cpu, card = LocalComm(P_, G), LocalComm(P_, G)
    xc = x.cuda()
    pairs = [
        (cpu.group_all_to_all(x), card.group_all_to_all(xc)),
        (cpu.local_psum_scatter(x, 1), card.local_psum_scatter(xc, 1)),
        (cpu.local_psum_scatter(x[:, 1], 0),
         card.local_psum_scatter(xc[:, 1], 0)),
        (cpu.local_all_gather(x), card.local_all_gather(xc)),
    ] + [(cpu.group_shift(x, d), card.group_shift(xc, d)) for d in range(G)]
    for want, got in pairs:
        assert got.is_cuda and torch.equal(got.cpu(), want)
    assert card.log == cpu.log


RMS_SHAPES = [
    # (leading dims, D): test_rmsnorm_kernel_matches_ref's four shapes, the
    # OLMoE width at decode (8 rows) and prefill (1024 rows), a 3-d input,
    # and widths that take the one-element access path (D % 8 != 0)
    ((4,), 32), ((128,), 64), ((16,), 128), ((3,), 48), ((8,), 2048),
    ((1024,), 2048), ((2, 3), 64), ((5,), 50), ((2,), 1001),
    # the configs' widths from smollm's 576 to 8192 on 32 to 256 lanes a
    # row and 1 to 4 chunks a lane, at 1, 7 and 2048 rows (few rows get
    # more lanes), and 4100 (the wide kernel: one element at a time in
    # bfloat16, past what the lanes hold in float32)
    ((1,), 576), ((7,), 576), ((2048,), 576), ((7,), 1536), ((2048,), 1536),
    ((1,), 4096), ((7,), 4096), ((1,), 8192), ((7,), 8192), ((2048,), 8192),
    ((3,), 4100),
    # falcon-mamba-7b's d_model at its prefill (8 × 256 rows) and decode
    ((2048,), 4096), ((8,), 4096),
    # zamba2-2.7b's d_model (320 16-byte chunks a bfloat16 row: not a whole
    # number a lane at 128 lanes) and seamless-m4t-medium's, at their
    # prefills and decode
    ((2048,), 2560), ((8,), 2560), ((1024,), 1024), ((8,), 1024),
]


@requires_cuda
@pytest.mark.parametrize("lead,d", RMS_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_rmsnorm_kernel_matches_plain(lead, d, dtype, round_before_gain):
    rng = np.random.default_rng(d + len(lead))
    x = _cuda(rng.standard_normal(lead + (d,)).astype(np.float32)).to(dtype)
    g = _cuda(rng.standard_normal(d).astype(np.float32)).to(dtype)
    before = launch_counts()["rmsnorm"]
    out = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=round_before_gain)
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm"] == before + 1
    # the plain version repeats the kernel's float32 chain: the same bits
    assert torch.equal(out, K6.rmsnorm_plain(
        x, g, 1e-5, round_before_gain=round_before_gain))


@requires_cuda
def test_rmsnorm_kernel_unaligned_rows_and_bad_operands():
    """A view whose data does not start on 16 bytes takes the
    one-element-access path: the same elements in the same order, so the
    same bits as the plain version."""
    rows, d = 6, 256
    buf = torch.randn(rows * d + 1, device="cuda")
    x = buf[1:].view(rows, d)  # 4 bytes past an aligned start
    assert x.data_ptr() % 16 and x.is_contiguous()
    g = torch.randn(d, device="cuda")
    assert torch.equal(K6.rmsnorm_cuda(x, g), K6.rmsnorm_plain(x, g))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K6.rmsnorm_cuda(x.double(), g.double())
    with pytest.raises(TypeError, match="gain dtype"):
        K6.rmsnorm_cuda(x, g.to(torch.bfloat16))


@requires_cuda
def test_rmsnorm_kernel_strided_x():
    """A strided x is made contiguous first; the result has x's shape and
    the plain version's bits."""
    base = torch.randn((6, 2, 256), device="cuda", dtype=torch.bfloat16)
    x = base[:, 1]  # rows 512 elements apart
    g = torch.randn(256, device="cuda", dtype=torch.bfloat16)
    assert not x.is_contiguous()
    before = launch_counts()["rmsnorm"]
    out = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=True)
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm"] == before + 1
    assert out.shape == x.shape
    assert torch.equal(out, K6.rmsnorm_plain(x, g, 1e-5,
                                             round_before_gain=True))


# K6's backward: rows around its group edges (9), the first chunk edges
# (132 · groups rows for 1, 2, 4 and 8 groups), up to 4096 (the LM steps'
# 1024 and 2048 rows included); the smollm and OLMoE widths, a narrow one,
# and widths the lanes hold at 256 lanes (bfloat16 4104) or not (float32
# 4104, 8200: the wide kernel)
RMS_BWD_ROWS = [1, 3, 8, 9, 130, 131, 133, 264, 265, 528, 529, 1024, 1056,
                1057, 4096]


def _k6_bwd_both_ways(x, g, dy, rbg):
    """K6's backward with the forward's saved r and without it: both the
    plain version's bits (which repeats the kernel's chain) and each
    other's; a second launch gives them again (no atomics). Returns the
    launch's (dx, dg)."""
    _, r = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=rbg, return_r=True)
    before = launch_counts()["rmsnorm_bwd"]
    dx, dg = K6.rmsnorm_bwd_cuda(x, g, dy, 1e-5, round_before_gain=rbg, r=r)
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm_bwd"] == before + 1
    assert dx.dtype == x.dtype and dg.dtype == g.dtype
    pdx, pdg = K6.rmsnorm_bwd_plain(x, g, dy, 1e-5, round_before_gain=rbg,
                                    r=r)
    assert torch.equal(dx, pdx) and torch.equal(dg, pdg)
    for saved in (None, r):
        dx2, dg2 = K6.rmsnorm_bwd_cuda(x, g, dy, 1e-5, round_before_gain=rbg,
                                       r=saved)
        assert torch.equal(dx2, dx) and torch.equal(dg2, dg)
    pdx, pdg = K6.rmsnorm_bwd_plain(x, g, dy, 1e-5, round_before_gain=rbg)
    assert torch.equal(dx, pdx) and torch.equal(dg, pdg)
    return dx, dg


@requires_cuda
@pytest.mark.parametrize("rows", RMS_BWD_ROWS)
@pytest.mark.parametrize("d", [64, 576, 1024, 2048, 2560, 4096, 4104, 8200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_rmsnorm_bwd_kernel_matches_plain(rows, d, dtype, round_before_gain):
    rng = np.random.default_rng(rows * d)
    x, dy = (_cuda(rng.standard_normal((rows, d)).astype(np.float32)).to(
        dtype) for _ in range(2))
    g = _cuda(rng.standard_normal(d).astype(np.float32)).to(dtype)
    _k6_bwd_both_ways(x, g, dy, round_before_gain)


@requires_cuda
@pytest.mark.parametrize("lead,d", RMS_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_rmsnorm_kernel_writes_r_without_changing_y(lead, d, dtype,
                                                    round_before_gain):
    """Under grad the forward's launch also stores r: y is the launch
    without an r pointer's, bit for bit, and r the plain version's."""
    rng = np.random.default_rng(d + len(lead))
    x = _cuda(rng.standard_normal(lead + (d,)).astype(np.float32)).to(dtype)
    g = _cuda(rng.standard_normal(d).astype(np.float32)).to(dtype)
    y = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=round_before_gain)
    before = launch_counts()["rmsnorm"]
    y2, r = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=round_before_gain,
                            return_r=True)
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm"] == before + 1
    assert torch.equal(y2, y)
    assert r.dtype == torch.float32 and r.shape == lead
    _, pr = K6.rmsnorm_plain(x, g, 1e-5, round_before_gain=round_before_gain,
                             return_r=True)
    assert torch.equal(r, pr)


@requires_cuda
@pytest.mark.parametrize("d,dtype", [(576, torch.bfloat16),
                                     (2048, torch.bfloat16),
                                     (1536, torch.float32),
                                     (4100, torch.float32)], ids=str)
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_rmsnorm_kernel_unaligned_view_writes_r(d, dtype, round_before_gain):
    """A view one element past an aligned start takes the wide kernel's
    one-element path (the rows kernel takes 16-byte access only): y and
    r the plain version's bits, the chain of the aligned launch."""
    rows = 9
    buf = torch.randn(rows * d + 1, device="cuda").to(dtype)
    x = buf[1:].view(rows, d)
    assert x.data_ptr() % 16 and x.is_contiguous()
    g = torch.randn(d + 1, device="cuda").to(dtype)[1:]
    y, r = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=round_before_gain,
                           return_r=True)
    py, pr = K6.rmsnorm_plain(x, g, 1e-5, round_before_gain=round_before_gain,
                              return_r=True)
    assert torch.equal(y, py) and torch.equal(r, pr)


@requires_cuda
@pytest.mark.parametrize("rows,d,dtype", [(2048, 576, torch.bfloat16),
                                          (1024, 2048, torch.bfloat16),
                                          (8, 2048, torch.bfloat16),
                                          (7, 1536, torch.float32),
                                          (3, 4100, torch.float32)], ids=str)
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_rmsnorm_bwd_without_saved_r_equals_with_it(rows, d, dtype,
                                                    round_before_gain):
    """Without a saved r the backward's C call forms r with the forward's
    kernel (its r-only mode, on the forward's lanes): dx and dg are the
    bits of the backward handed the forward's r."""
    rng = np.random.default_rng(rows + d)
    x, dy = (_cuda(rng.standard_normal((rows, d)).astype(np.float32)).to(
        dtype) for _ in range(2))
    g = _cuda(rng.standard_normal(d).astype(np.float32)).to(dtype)
    _, r = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=round_before_gain,
                           return_r=True)
    with_r = K6.rmsnorm_bwd_cuda(x, g, dy, 1e-5,
                                 round_before_gain=round_before_gain, r=r)
    without = K6.rmsnorm_bwd_cuda(x, g, dy, 1e-5,
                                  round_before_gain=round_before_gain)
    assert all(torch.equal(a, b) for a, b in zip(with_r, without))


@requires_cuda
def test_rmsnorm_r_of_each_launch_is_its_own():
    """Under grad r comes from a batch of tensors (``_new_r``): more launches
    than a batch holds, each r keeps its own launch's values after the
    later launches, and each equals the plain version's."""
    xs = [torch.randn((3, 4, 576), device="cuda", dtype=torch.bfloat16)
          for _ in range(K6.R_BATCH + 3)]
    g = torch.randn(576, device="cuda", dtype=torch.bfloat16)
    rs = [K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=True,
                          return_r=True)[1] for x in xs]
    torch.cuda.synchronize()
    assert len({r.data_ptr() for r in rs}) == len(rs)
    for x, r in zip(xs, rs):
        _, pr = K6.rmsnorm_plain(x, g, 1e-5, round_before_gain=True,
                                 return_r=True)
        assert r.shape == (3, 4) and torch.equal(r, pr)


@requires_cuda
def test_rmsnorm_c_entry_refuses_lanes_that_do_not_hold_the_row():
    """The C entry validates ``_fwd_layout``'s lanes: a count that is not
    32, 64, 128 or 256, or fewer lanes than hold the row in four chunks
    each, is refused before any launch."""
    from repro_torch.kernels import build

    x = torch.randn((4, 8192), device="cuda", dtype=torch.bfloat16)
    g = torch.randn(8192, device="cuda", dtype=torch.bfloat16)
    y = torch.empty_like(x)
    lib = build.library()
    for lanes in (0, 48, 32, 128):
        rc = lib.repro_rmsnorm(x.data_ptr(), g.data_ptr(), y.data_ptr(), None,
                               4, 8192, lanes, 1e-5, 1, 1,
                               build.stream_of(x))
        assert rc != 0, lanes
    assert K6._fwd_layout(8192, 2) == 256
    rc = lib.repro_rmsnorm(x.data_ptr(), g.data_ptr(), y.data_ptr(), None, 4,
                           8192, 256, 1e-5, 1, 1, build.stream_of(x))
    assert rc == 0
    assert torch.equal(y, K6.rmsnorm_plain(x, g, 1e-5,
                                           round_before_gain=True))


@requires_cuda
def test_rmsnorm_bwd_kernel_odd_operands():
    """A width off the 16-byte path, a strided dy, a 3-d x: the plain
    version's bits; float64 and widths past the kernel's raise."""
    x = torch.randn((2, 5, 50), device="cuda")
    g = torch.randn(50, device="cuda")
    dy = torch.randn((2, 50, 5), device="cuda").transpose(1, 2)
    assert not dy.is_contiguous()
    dx, dg = K6.rmsnorm_bwd_cuda(x, g, dy, round_before_gain=True)
    pdx, pdg = K6.rmsnorm_bwd_plain(x, g, dy, round_before_gain=True)
    assert dx.shape == x.shape
    assert torch.equal(dx, pdx) and torch.equal(dg, pdg)
    # a saved r of x's leading shape, and one strided
    _, r = K6.rmsnorm_cuda(x, g, return_r=True)
    assert r.shape == (2, 5)
    for saved in (r, r.t().contiguous().t()):
        dx2, dg2 = K6.rmsnorm_bwd_cuda(x, g, dy, round_before_gain=True,
                                       r=saved)
        assert torch.equal(dx2, dx) and torch.equal(dg2, dg)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K6.rmsnorm_bwd_cuda(x.double(), g.double(), dy.double())
    with pytest.raises(ValueError, match="takes r as float32"):
        K6.rmsnorm_bwd_cuda(x, g, dy, r=r[:1])
    big = torch.randn((2, K6.BWD_MAX_D + 8), device="cuda")
    with pytest.raises(ValueError, match="D <="):
        K6.rmsnorm_bwd_cuda(big, big[0], big)


@requires_cuda
@pytest.mark.parametrize("d", [12_272, 12_280, K6.BWD_MAX_D])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_at_its_widest(d, dtype):
    """Widths up to BWD_MAX_D, where the wide kernel's shared memory
    passes the 48 KB default (from D = 12,273 on): the plain version's
    bits, with and without a saved r."""
    rng = np.random.default_rng(d)
    x, dy = (_cuda(rng.standard_normal((19, d)).astype(np.float32)).to(
        dtype) for _ in range(2))
    g = _cuda(rng.standard_normal(d).astype(np.float32)).to(dtype)
    _k6_bwd_both_ways(x, g, dy, True)


@requires_cuda
def test_lm_loss_backward_on_the_card_runs_k6_backward():
    """olmoe-smoke (float32) on the (data 2, model 4) grid: lm_loss's
    grads on the card launch K6's backward 2·L + 1 times, reach every
    leaf, and equal the CPU's plain run within 1e-4; two backward runs
    give the same bits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import _leaves
    from repro_torch.train.steps import loss_and_grads

    cfg = get_smoke_config("olmoe-1b-7b")
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    cpu = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = TT._tree_map(lambda t: t.cuda(), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32))
    before = launch_counts()["rmsnorm_bwd"]
    loss, grads = loss_and_grads(card, cfg, dist, {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm_bwd"] == before + 2 * cfg.n_layers + 1
    _, again = loss_and_grads(card, cfg, dist, {"tokens": toks.cuda()})
    want_loss, want = loss_and_grads(cpu, cfg, dist, {"tokens": toks})
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-5, atol=1e-5)
    for got, ref, rep in zip(_leaves(grads), _leaves(want), _leaves(again)):
        assert bool(got.abs().sum() > 0)
        assert torch.equal(got, rep)
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)


@requires_cuda
def test_raw_stream_handle_is_the_current_stream():
    from repro_torch.kernels import build

    x = torch.zeros(4, device="cuda")
    assert build.stream_of(x) == torch.cuda.current_stream(
        x.device).cuda_stream
    side = torch.cuda.Stream(x.device)
    with torch.cuda.stream(side):
        assert build.stream_of(x) == side.cuda_stream
        assert build.stream_of(x) == torch.cuda.current_stream(
            x.device).cuda_stream
    assert build.stream_of(x) == torch.cuda.current_stream(
        x.device).cuda_stream


@requires_cuda
def test_kernels_launched_in_a_side_stream_match_plain():
    """K6 and K5 launch on the current stream: inside a side stream their
    results are the plain versions' once that stream is synchronised, and
    each call counts one launch."""
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((1024, 2048), device="cuda", generator=gen).to(
        torch.bfloat16)
    g = torch.randn(2048, device="cuda", generator=gen).to(torch.bfloat16)
    cols, blocks, x3, y3 = _sparse_sddmm_inputs((8, 8), 128, 3, mb=64)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = launch_counts()
    with torch.cuda.stream(side):
        y = K6.rmsnorm_cuda(x, g, 1e-5, round_before_gain=True)
        vals = K5.bsr_sddmm_cuda(cols, blocks, x3, y3)
    side.synchronize()
    after = launch_counts()
    assert after["rmsnorm"] == before["rmsnorm"] + 1
    assert after["bsr_sddmm"] == before["bsr_sddmm"] + 1
    assert torch.equal(y, K6.rmsnorm_plain(x, g, 1e-5,
                                           round_before_gain=True))
    assert torch.equal(vals, K5.bsr_sddmm_plain(cols, blocks, x3, y3))


@requires_cuda
def test_lm_on_the_card_launches_k6_and_matches_the_cpu():
    """olmoe-smoke (float32): forward and decode_step on the card equal the
    CPU's plain run within 1e-4, and launch K6 2·L + 1 times each."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TT

    cfg = get_smoke_config("olmoe-1b-7b")
    cpu = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = TT._tree_map(lambda t: t.cuda(), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32))
    before = launch_counts()["rmsnorm"]
    got = TT.forward(card, cfg, None, {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm"] == before + 2 * cfg.n_layers + 1
    want = TT.forward(cpu, cfg, None, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cache = TT.init_decode_cache(cfg, 2, 8, device="cuda")
    for j in range(toks.shape[1]):
        before = launch_counts()["rmsnorm"]
        step, cache = TT.decode_step(card, cfg, None, toks[:, j:j + 1].cuda(),
                                     cache)
        torch.cuda.synchronize()
        assert launch_counts()["rmsnorm"] == before + 2 * cfg.n_layers + 1
        torch.testing.assert_close(step[:, 0].cpu(), want[:, j], rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the backward compositions (autograd) on the card
# ---------------------------------------------------------------------------

_WRAPPERS = [(K1, "gather_rows_cuda", "gather_rows_plain"),
             (K1, "gather_rows_scaled_cuda", "gather_rows_scaled_plain"),
             (K2, "scatter_add_rows_cuda", "scatter_add_rows_plain"),
             (K34, "bsr_spmm_cuda", "bsr_spmm_plain"),
             (K5, "bsr_sddmm_cuda", "bsr_sddmm_plain")]


def _plain_on_the_card(monkeypatch):
    """Route every kernel wrapper to its plain version (on the card's
    tensors), so a run walks the plain composition."""
    for mod, cuda, plain in _WRAPPERS:
        fn = getattr(mod, plain)
        monkeypatch.setattr(mod, cuda,
                            lambda *a, bn=None, _fn=fn: _fn(*a))


def _leaf(a):
    return _cuda(np.asarray(a, np.float32)).requires_grad_()


def _backward_cases(n, seed):
    """Each op's forward + backward on card tensors: a function returning
    the output and the gradients (everything its backward computes)."""
    from repro_torch.core import local_backend, sparse
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    csrs = [sparse.random_sparse(96, 80, 0.05 + 0.02 * (p % 3), seed=p)
            for p in range(P)]
    piece = {k: v.cuda() for k, v in local_backend.CooBackend().prepare(
        csrs).items()}
    idx = _cuda(rng.integers(-1, 80, size=(P, 300)).astype(np.int32))
    tgt = rng.integers(-1, 96, size=(P, 200)).astype(np.int32)
    tgt[:, :120] = 5  # a hub row
    perm, meta = (_cuda(a) for a in ops.stack_sorted_scatter(tgt))
    cols, blocks = (_cuda(a) for a in _ell_with_pads(rng))

    def upstream(out):
        """A unit-scale gradient for ``out``, the same on every run."""
        g = np.random.default_rng(seed + 1).standard_normal(tuple(out.shape))
        return _cuda(g.astype(np.float32))

    arrays = {"b": rng.standard_normal((P, 80, n)),
              "c": rng.standard_normal((P, 96, n)),
              "parts": rng.standard_normal((P, 200, n)),
              "x": rng.standard_normal((P, 96, n)),
              "x3": rng.standard_normal((P, 6, 8, n)),
              "y3": rng.standard_normal((P, 7, 8, n))}

    def pack():
        b = _leaf(arrays["b"])
        out = ops.pack_rows_op(b, idx)
        out.backward(upstream(out))
        return out, b.grad

    def aggregate():
        c, parts = _leaf(arrays["c"]), _leaf(arrays["parts"])
        out = ops.scatter_add_rows_exec_op(c * 1.0, parts, perm, meta)
        out.backward(upstream(out))
        return out, c.grad, parts.grad

    def coo():
        b = _leaf(arrays["b"])
        val = piece["val"].clone().requires_grad_()
        out = ops.coo_accumulate_rows_op(
            torch.zeros((P, 96, n), device=b.device), piece["col"], val,
            piece["perm"], piece["meta"], b)
        out.backward(upstream(out))
        return out, b.grad, val.grad

    def coo_sddmm():
        x, y = _leaf(arrays["x"]), _leaf(arrays["b"])
        val = piece["val"].clone().requires_grad_()
        out = local_backend.coo_sddmm_op(dict(piece, val=val), x, y)
        out.backward(upstream(out))
        return out, x.grad, y.grad, val.grad

    def sddmm():
        bl = blocks.clone().requires_grad_()
        x3, y3 = _leaf(arrays["x3"]), _leaf(arrays["y3"])
        out = ops.bsr_sddmm_op(cols, bl, x3, y3)
        out.backward(upstream(out))
        return out, bl.grad, x3.grad, y3.grad

    return {"pack": pack, "aggregate": aggregate, "coo": coo,
            "coo_sddmm": coo_sddmm, "sddmm": sddmm}


def _ell_with_pads(rng, mb=6, t=5, kb=7):
    cols = np.full((P, mb, t), -1, np.int32)
    for p in range(P):
        for i in range(mb):
            k = rng.integers(0, t + 1)
            cols[p, i, :k] = rng.permutation(kb)[:k]
    blocks = rng.standard_normal((P, mb, t, 8, 8)).astype(np.float32)
    blocks *= rng.random(blocks.shape) < 0.4
    blocks[cols < 0] = 0.0
    return cols, blocks


# the kernels each forward launches (the coo SDDMM is plain torch, as the
# reference's) and each backward (K5's: K3 on both layouts + K5)
FORWARD_LAUNCHES = {
    "pack": {"gather_rows": 1},
    "aggregate": {"scatter_add_rows": 1},
    "coo": {"gather_rows_scaled": 1, "scatter_add_rows": 1},
    "coo_sddmm": {},
    "sddmm": {"bsr_sddmm": 1},
}
BACKWARD_LAUNCHES = {
    "pack": {"scatter_add_rows": 1},
    "aggregate": {"gather_rows": 1},
    "coo": {"gather_rows_scaled": 1, "scatter_add_rows": 1},
    "coo_sddmm": {"gather_rows_scaled": 2, "scatter_add_rows": 2},
    "sddmm": {"bsr_spmm": 2, "bsr_sddmm": 1},
}


@requires_cuda
@pytest.mark.parametrize("n", [40, 128, 256])
@pytest.mark.parametrize("case", list(BACKWARD_LAUNCHES))
def test_backward_composition_matches_plain_on_the_card(case, n,
                                                        monkeypatch):
    """Each backward on the card launches the port's kernels (counted) and
    equals its plain composition on the same card tensors: bit for bit
    through K1 / K2 / K5, within 1e-5 through K3 (its tolerance)."""
    run = _backward_cases(n, seed=n)[case]
    got = run()  # first use: builds the maps
    torch.cuda.synchronize()
    before = launch_counts()
    again = run()
    torch.cuda.synchronize()
    after = launch_counts()
    for k in after:
        want = (FORWARD_LAUNCHES[case].get(k, 0)
                + BACKWARD_LAUNCHES[case].get(k, 0))
        assert after[k] - before[k] == want, (k, before, after)
    for a, b in zip(got, again):  # no atomics: run == run
        assert torch.equal(a, b)
    _plain_on_the_card(monkeypatch)
    plain = _backward_cases(n, seed=n)[case]()
    for a, b in zip(got, plain):
        if case == "sddmm":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, b)


@requires_cuda
@pytest.mark.parametrize("n", [40, 128, 256])
@pytest.mark.parametrize("cfg", [dict(schedule=4, overlap=True),
                                 dict(hier=(2, 4), schedule=1, overlap=True),
                                 dict(replicate=2)],
                         ids=["flat", "hier", "replicated"])
def test_handle_grads_on_the_card_match_plain_and_dense(cfg, n,
                                                        monkeypatch):
    """dB of ½‖h(b)‖² through the coo handle on the card: K1 / K2 in the
    backward, the same bits twice and as the plain composition, within
    the executor tolerance of Aᵀ(A b) in float64 (2e-4 + 2e-4·|A|ᵀ|A||b|);
    the backward's collectives carry the forward's rows on every axis."""
    import repro_torch as T
    from repro_torch.core import sparse

    a = sparse.power_law_sparse(512, 512, 6000, 1.2, seed=2)
    h = T.compile_spmm(a, 8, T.SpmmConfig(**cfg))
    b = np.random.default_rng(n).standard_normal((512, n)).astype(np.float32)

    def grad():
        x = _cuda(b).requires_grad_()
        c = h(x)
        c.backward(c.detach())
        torch.cuda.synchronize()
        return x.grad

    g = grad()
    before = launch_counts()
    g2 = grad()
    after = launch_counts()
    assert torch.equal(g, g2)
    for k in ("gather_rows", "gather_rows_scaled", "scatter_add_rows"):
        assert after[k] > before[k], k
    for axis in ("x", "g", "l", "s", "r"):
        assert h.comm.rows(axis, "bwd") == h.comm.rows(axis)
    # the executor tolerance relative to the terms each entry sums
    dense = a.to_dense().astype(np.float64)
    scale = np.abs(dense).T @ (np.abs(dense) @ np.abs(b))
    assert (np.abs(g.cpu().numpy() - dense.T @ (dense @ b))
            <= 2e-4 + 2e-4 * scale).all()
    _plain_on_the_card(monkeypatch)
    assert torch.equal(grad(), g)


@requires_cuda
def test_bsr_sddmm_and_coo_fused_grads_on_the_card():
    """The fused coo call and the bsr SDDMM differentiate on the card
    within rtol 2e-3 / atol 2e-4 of float64; a bsr fused call under grad
    raises."""
    import repro_torch as T
    from repro_torch.core import sparse

    a = sparse.power_law_sparse(512, 512, 6000, 1.2, seed=2)
    h = T.compile_fused(a, 8, T.SpmmConfig(kernel="fused", edge="leaky_relu",
                                           backends=("coo", "bsr")))
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((2, 512, 16)).astype(np.float32)
    b = rng.standard_normal((512, 40)).astype(np.float32)
    xt, yt, bt = (_cuda(v).requires_grad_() for v in (x, y, b))
    c = h(xt, yt, bt)
    c.backward(c.detach())
    ad = a.to_dense().astype(np.float64)
    s = ad * (x.astype(np.float64) @ y.T.astype(np.float64))
    e = np.where(s > 0, s, 0.2 * s)
    cd = e @ b
    de = cd @ b.T * ad * np.where(s > 0, 1.0, 0.2)
    for got, want in ((bt.grad, e.T @ cd), (xt.grad, de @ y),
                      (yt.grad, de.T @ x)):
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3,
                                   atol=2e-4)
    with pytest.raises(NotImplementedError, match="no JVP"):
        h(xt, yt, bt, backend="bsr")
    xt.grad = yt.grad = None
    vals = h(xt, yt, kernel="sddmm", backend="bsr", edge=None)
    (0.5 * sum(v.square().sum() for v in vals.values())).backward()
    w = ad * ad * (x.astype(np.float64) @ y.T.astype(np.float64))
    np.testing.assert_allclose(xt.grad.cpu().numpy(), w @ y, rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(yt.grad.cpu().numpy(), w.T @ x, rtol=2e-3,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# measured autotuning, memory per executable, donation, values refresh
# ---------------------------------------------------------------------------


@requires_cuda
def test_measured_autotune_times_real_launches_and_replays(tmp_path,
                                                            monkeypatch):
    import repro_torch as T
    from repro_torch.core import autotune, sparse

    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "atc"))
    monkeypatch.delenv(autotune.MEASURE_ENV, raising=False)
    a = sparse.power_law_sparse(1024, 1024, 12000, 1.2, seed=2)
    cfg = T.SpmmConfig(backends=("coo", "bsr"), hier="auto", measure=True,
                       n_dense_hint=32)
    events = []
    hook = autotune.register_profile_hook(events.append)
    try:
        before = sum(launch_counts().values())
        h = T.compile_spmm(a, 8, cfg)
        torch.cuda.synchronize()
        assert events and sum(launch_counts().values()) > before
        assert h.decisions["decision_source"] == "measured"
        assert h.decisions["measured_time"] > 0
        n, launched = len(events), sum(launch_counts().values())
        h2 = T.compile_spmm(a, 8, cfg)
        assert len(events) == n  # the cache replay times nothing
        assert sum(launch_counts().values()) == launched
    finally:
        autotune.unregister_profile_hook(hook)
    assert h2.decisions["decision_source"] == "cache"
    assert {k: v for k, v in h2.decisions.items() if k != "decision_source"} \
        == {k: v for k, v in h.decisions.items() if k != "decision_source"}
    b = _cuda(np.random.default_rng(1).standard_normal((1024, 32))
              .astype(np.float32))
    assert torch.equal(h(b), h2(b))
    np.testing.assert_allclose(h(b).cpu().numpy(),
                               a.to_dense() @ b.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


# (matrix, config, width of B). Each body reads B first (partials, pack,
# then the diagonal, whose coo accumulator takes a donated B's storage),
# so donation lowers the first call's allocation wherever its peak falls.
DONATION_CASES = {
    # chip_smoke.py --quick's uniform cell: the peak is in the colp rounds
    "uniform": (lambda sp: sp.random_sparse(16384, 16384, 7 / 16384, seed=0),
                dict(), 128),
    # a power-law matrix: the peak is in the diagonal's products
    "power-law-staged": (
        lambda sp: sp.power_law_sparse(4096, 4096, 40000, 1.2, seed=3),
        dict(schedule=2, overlap=False), 128),
    "hier": (lambda sp: sp.power_law_sparse(4096, 4096, 40000, 1.2, seed=3),
             dict(hier=(2, 4), schedule=1, overlap=True), 128),
    # the reference's own pin (tests/test_autotune.py, buffer donation)
    "reference": (lambda sp: sp.power_law_sparse(64, 64, 400, 1.2, seed=2),
                  dict(backends=("coo",), schedule=4, overlap=False,
                       n_dense_hint=16), 16),
}


@requires_cuda
@pytest.mark.parametrize("case", list(DONATION_CASES))
def test_donation_lowers_memory_and_keeps_bits(case):
    """Donation hands the executor the handle's private copy of B: the
    first call's allocation drops by at most B's bytes, strictly, and C
    keeps its bits."""
    import dataclasses

    import repro_torch as T
    from repro_torch.core import sparse
    from repro_torch.core.api import materialize_payload

    make, cfg, n = DONATION_CASES[case]
    a = make(sparse)
    hd = T.compile_spmm(a, 8, T.SpmmConfig(**cfg))
    payload = hd.save_payload()
    payload["config"] = dataclasses.replace(hd.config, donate=False)
    hu = materialize_payload(payload, 8)
    assert hd.stats()["donated_buffers"] == ("b",)
    assert hu.stats()["donated_buffers"] == ()
    b = np.random.default_rng(4).standard_normal((a.shape[1], n)).astype(
        np.float32)
    cd, cu = hd(b), hu(b)  # first calls, on a host B: the copy is private
    assert torch.equal(cd, cu)
    md = hd.stats()["total_allocation_size"]
    mu = hu.stats()["total_allocation_size"]
    assert md > 0 and mu > 0
    assert md < mu and mu - md <= b.nbytes
    # a caller's tensor on the card is never written nor consumed
    bc = _cuda(b)
    keep = bc.clone()
    assert torch.equal(hd(bc), cd) and torch.equal(bc, keep)
    assert torch.equal(hd(bc), cd)


@requires_cuda
def test_values_refresh_keeps_bits_of_a_cold_compile():
    import dataclasses

    import repro_torch as T
    from repro_torch.core import sparse

    a = sparse.power_law_sparse(1024, 1024, 12000, 1.2, seed=5)
    s = T.SpmmSession.build(a, 8, T.SpmmConfig(backends=("coo", "bsr"),
                                               hier="auto"), p_ladder=(4, 8))
    h = s.handle()
    b = _cuda(np.random.default_rng(6).standard_normal((1024, 48))
              .astype(np.float32))
    h(b), h(b, backend="bsr")
    keys = h.cache_info()["keys"]
    scale = np.random.default_rng(7).uniform(0.5, 1.5, a.nnz)
    a2 = dataclasses.replace(a, data=(a.data * scale).astype(np.float32))
    assert s.maybe_replan(a2) == (0.0, False)
    assert s.handle() is h and h.values_refreshes == 1
    cold = T.compile_spmm(a2, 8, T.SpmmConfig(backends=("coo", "bsr"),
                                              hier="auto"))
    for be in ("coo", "bsr"):
        assert torch.equal(h(b, backend=be), cold(b, backend=be))
    assert h.cache_info()["keys"] == keys


@requires_cuda
def test_wave_server_outputs_stay_on_the_card():
    """Waves on a host B: outputs are tensors on the card, equal to cold
    compiles on the rung they were served on, through a retried wave
    that degrades the ladder."""
    import repro_torch as T
    from repro_torch.core import sparse
    from repro_torch.robustness import Fault, inject

    a = sparse.power_law_sparse(1024, 1024, 12000, 1.2, seed=5)
    cfg = T.SpmmConfig(hier="auto")
    s = T.SpmmSession.build(a, 8, cfg, p_ladder=(4, 8))
    server = T.SpmmWaveServer(s, max_batch=2, backoff=0.0)
    b = np.random.default_rng(8).standard_normal((1024, 32)).astype(
        np.float32)
    reqs = [T.SpmmRequest(rid=i, b=b) for i in range(3)]
    for r in reqs:
        server.submit(r)
    with inject([Fault(kind="wave_error", site="wave", times=2)]):
        server.run()
    st = server.stats
    assert (st.waves, st.served, st.failed_waves, st.retried_waves,
            st.degraded_rungs, st.dropped_waves) == (2, 3, 2, 1, 1, 0)
    assert s.current_P == 4
    cold4 = T.compile_spmm(a, 4, cfg)(b)
    for r in reqs:
        assert r.output.is_cuda and torch.equal(r.output, cold4)
    s.on_resize(8)
    r8 = T.SpmmRequest(rid=3, b=b)
    server.submit(r8)
    server.run()
    assert torch.equal(r8.output, T.compile_spmm(a, 8, cfg)(b))
    assert server.stats.swaps == 2 and server.stats.dropped_waves == 0


@requires_cuda
def test_fleet_cross_size_migration_on_the_card():
    """A bsr tenant migrates between groups of 4 and 2 ranks: the resident
    slabs are resharded by device copies and reassemble to the served B
    and C, and serving at the new P equals a cold compile."""
    import repro_torch as T
    from repro_torch.core import sparse

    a = sparse.random_sparse(2048, 2048, 8 / 2048, seed=1)
    cfg = T.SpmmConfig(backends=("bsr", "coo"))
    fleet = T.SpmmFleet(T.Topology.local(8), (4, 2), config=cfg)
    fleet.admit("t", a, p_ladder=(2, 4))
    dst = 1 - fleet.placements()["t"]
    b = _cuda(np.random.default_rng(9).standard_normal((2048, 64))
              .astype(np.float32))
    fleet.submit("t", b)
    (c_old,) = fleet.serve()["t"]
    tenant = fleet.tenants["t"]
    old_P = tenant.session.current_P
    assert c_old.is_cuda and torch.equal(c_old,
                                         T.compile_spmm(a, old_P, cfg)(b))
    assert fleet.migrate("t", dst)
    move = [e for e in fleet.events if e["action"] == "migrate"][-1]
    assert move["b_rows"] > 0 and move["c_rows"] > 0
    assert all(s.is_cuda for s in tenant.resident_b + tenant.resident_c)
    assert torch.equal(torch.cat(tenant.resident_b), b)
    assert torch.equal(torch.cat(tenant.resident_c), c_old)
    new_P = tenant.session.current_P
    assert new_P != old_P
    fleet.submit("t", b)
    (c_new,) = fleet.serve()["t"]
    assert torch.equal(c_new, T.compile_spmm(a, new_P, cfg)(b))
    assert tenant.server.stats.dropped_waves == 0


@requires_cuda
def test_sorted_scatter_maps_on_the_card_equal_the_host():
    rng = np.random.default_rng(4)
    tgt = rng.integers(-1, 9, (4, 37)).astype(np.int32)
    tgt[1] = -1
    perm, meta = K2.sorted_scatter_maps(_cuda(tgt))
    hp, hm = K2.stack_sorted_scatter(tgt)
    assert np.array_equal(perm.cpu().numpy(), hp)
    assert np.array_equal(meta.cpu().numpy(), hm)


@requires_cuda
def test_expert_parallel_lm_on_the_card_matches_the_cpu():
    """olmoe-smoke (float32) on a (data 2, model 4) grid: the EP forward
    and decode steps on the card equal the CPU's plain run within 1e-4,
    with the same drops; each MoE layer launches K1 and K2 twice; the
    model ranks agree bit for bit and a repeat is bit-identical."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT

    cfg = get_smoke_config("olmoe-1b-7b")
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    cpu = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = TT._tree_map(lambda t: t.cuda(), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 12)).astype(np.int32))
    before = launch_counts()
    with TM.record_dispatch() as rec_card:
        got = TT.forward(card, cfg, dist, {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    after = launch_counts()
    for k in ("gather_rows", "scatter_add_rows"):
        assert after[k] == before[k] + 2 * cfg.n_layers, k
    with TM.record_dispatch() as rec_cpu:
        want = TT.forward(cpu, cfg, dist, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert [int(r["dropped"]) for r in rec_card] == \
        [int(r["dropped"]) for r in rec_cpu]
    assert torch.equal(TT.forward(card, cfg, dist, {"tokens": toks.cuda()}),
                       got)
    x = torch.randn(4, 12, cfg.d_model, device="cuda")
    lp = TT._layer(card["layers"], 0)["moe"]
    ranks = TM._moe_ep(lp, x, cfg, dist, True, all_ranks=True)
    assert all(torch.equal(ranks[m], ranks[0]) for m in range(1, 4))
    cache = TT.init_decode_cache(cfg, 4, 12, device="cuda")
    cache_cpu = TT.init_decode_cache(cfg, 4, 12, device="cpu")
    for j in range(toks.shape[1]):
        step, cache = TT.decode_step(card, cfg, dist,
                                     toks[:, j:j + 1].cuda(), cache)
        ref, cache_cpu = TT.decode_step(cpu, cfg, dist, toks[:, j:j + 1],
                                        cache_cpu)
        torch.testing.assert_close(step.cpu(), ref, rtol=1e-4, atol=1e-4)


@requires_cuda
@pytest.mark.parametrize("changes", [{}, dict(ssm_fused_proj=True),
                                     dict(ssm_version=2, ssm_heads=4)],
                         ids=["v1", "v1_fused", "v2"])
def test_mamba_block_on_the_card_matches_cpu(changes):
    """``mamba_block`` (two chunks, h carried) and one decode step in
    float32 on the card within 1e-4 / 1e-5 of the CPU run."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ssm as TS

    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"), **changes)
    cpu = TS.init_mamba_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32, device="cpu")
    card = {k: v.cuda() for k, v in cpu.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    got = TS.mamba_block(card, x.cuda(), cfg)
    want = TS.mamba_block(cpu, x, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    st = TS.init_ssm_state(cfg, 2, torch.float32, device="cpu")
    st = TS.SSMState(torch.rand_like(st.h), torch.rand_like(st.conv))
    out, new = TS.mamba_block_decode(card, x[:, :1].cuda(), TS.SSMState(
        st.h.cuda(), st.conv.cuda()), cfg)
    ref, ref_new = TS.mamba_block_decode(cpu, x[:, :1], st, cfg)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(new.h.cpu(), ref_new.h, rtol=1e-4, atol=1e-5)


def _attention64(q, k, v, causal):
    """Dense softmax attention in float64 (GQA: kv heads repeated), the
    oracle of ``flash_attention``."""
    q, k, v = (t.double() for t in (q, k, v))
    g = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    logits = (q @ k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    if causal:
        s, sk = q.shape[2], k.shape[2]
        mask = torch.ones((s, sk), dtype=torch.bool,
                          device=q.device).tril(sk - s)
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.softmax(logits, -1) @ v


@requires_cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_chunk", [1024, 256])
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-4), (torch.bfloat16, 1e-2, 1e-2)], ids=str)
def test_flash_attention_on_the_card_matches_float64(causal, dtype, rtol,
                                                     atol, kv_chunk):
    """``flash_attention`` at 1024 × 1024 (two q chunks; GQA 8 / 2 heads)
    on the card: the encoder's non-causal and the decoder's causal path,
    with one kv chunk (the model's) and with four (the online softmax
    rescales m / l / acc between them), within rtol / atol of a float64
    oracle on the same inputs. bf16 rounds the logits and p to bf16, as
    the reference does: a logit near 4 moves by up to 2**-6, so a row of
    few keys is off by up to ~8e-3 (0.0078 at one kv chunk, causal, an
    H100); the float32 cases hold the rescaling to 2e-4."""
    from repro_torch.models.layers import flash_attention

    gen = torch.Generator("cuda").manual_seed(0)
    q = torch.randn((2, 8, 1024, 64), generator=gen, device="cuda")
    k, v = (torch.randn((2, 2, 1024, 64), generator=gen, device="cuda")
            for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, kv_chunk=kv_chunk)
    assert out.is_cuda and out.dtype == dtype and out.shape == q.shape
    want = _attention64(q, k, v, causal)
    torch.testing.assert_close(out.double(), want, rtol=rtol, atol=atol)
