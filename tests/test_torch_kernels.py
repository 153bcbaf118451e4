"""The port's kernel oracles and plain versions against the JAX package's.

The plain torch versions (what the CPU path runs and what each CUDA kernel
is held against on the card) must match the reference's jnp oracles and
its Pallas kernels in interpret mode on ``tests/test_kernels.py``'s
sweeps. The CUDA kernels themselves are tested in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bsr_spmm import (  # noqa: E402
    bsr_spmm_acc_pallas, bsr_spmm_pallas,
)
from repro.kernels.gather_rows import gather_rows_pallas  # noqa: E402
from repro.kernels.scatter_add_rows import (  # noqa: E402
    prepare_sorted_scatter, scatter_add_rows_sorted_pallas,
)
from repro_torch.kernels import bsr_spmm as K34  # noqa: E402
from repro_torch.kernels import gather_rows as K1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import scatter_add_rows as K2  # noqa: E402

BSR_SHAPES = [
    # (mb, t, bm, bk, kb, n, bn)
    (2, 3, 8, 8, 4, 16, 16),
    (3, 2, 16, 8, 5, 32, 16),
    (1, 1, 8, 8, 2, 8, 8),
    (4, 5, 32, 16, 8, 64, 64),
    (2, 4, 8, 32, 4, 128, 128),
]
DTYPES = [(np.float32, torch.float32, 1e-5),
          (jnp.bfloat16, torch.bfloat16, 6e-2)]
# Pallas in interpret mode costs about a second a call on the CPU: it runs
# at one shape of each sweep (the jnp oracles run at every shape)
INTERPRET_BSR = BSR_SHAPES[3]
INTERPRET_GATHER = (64, 32, 20)  # (K, n, S)
INTERPRET_SCATTER = (32, 128, 100)  # (M, n, S)


def _t(x, dtype=None):
    """A jax/numpy array as a torch tensor (through float32 for bf16)."""
    a = np.array(jnp.asarray(x, jnp.float32) if dtype is torch.bfloat16
                 else x)
    t = torch.from_numpy(a)
    return t.to(dtype) if dtype is not None else t


def _bsr_case(shape):
    mb, t, bm, bk, kb, n, bn = shape
    rng = np.random.default_rng(hash(shape) % 2 ** 31)
    cols = rng.integers(-1, kb, size=(mb, t)).astype(np.int32)
    blocks = rng.standard_normal((mb, t, bm, bk)).astype(np.float32)
    blocks[cols < 0] = 0.0
    b = rng.standard_normal((kb * bk, n)).astype(np.float32)
    acc = rng.standard_normal((mb * bm, n)).astype(np.float32)
    return cols, blocks, b, acc


@pytest.mark.parametrize("shape", BSR_SHAPES)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_bsr_plain_matches_oracle_and_interpret(shape, jdt, tdt, tol):
    mb, t, bm, bk, kb, n, bn = shape
    cols, blocks, b, acc = _bsr_case(shape)
    cols_j, blocks_j, b_j = (jnp.asarray(cols), jnp.asarray(blocks, jdt),
                             jnp.asarray(b, jdt))
    wants = [np.asarray(jref.bsr_spmm_ref(cols_j, blocks_j, b_j),
                        np.float32)]
    if shape == INTERPRET_BSR:
        wants.append(np.asarray(bsr_spmm_pallas(cols_j, blocks_j, b_j, bn=bn,
                                                interpret=True), np.float32))
    cols_t, blocks_t, b_t = _t(cols), _t(blocks_j, tdt), _t(b_j, tdt)
    plain = K34.bsr_spmm_plain(cols_t[None], blocks_t[None], b_t[None],
                               mb * bm)[0]
    port_oracle = tref.bsr_spmm_ref(cols_t, blocks_t, b_t)
    for got in (plain, port_oracle):
        assert got.dtype == tdt
        for want in wants:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=tol)

    if tdt is torch.float32:
        # acc + A@B: the reference's oracle form, and its Pallas kernel in
        # interpret mode at one shape
        want = np.asarray(jref.bsr_spmm_ref(cols_j, blocks_j, b_j)) + acc
        if shape == INTERPRET_BSR:
            want = np.asarray(bsr_spmm_acc_pallas(cols_j, blocks_j, b_j,
                                                  jnp.asarray(acc), bn=bn,
                                                  interpret=True))
        acc_t = _t(acc)[None].clone()
        out = K34.bsr_spmm_acc_plain(cols_t[None], blocks_t[None], b_t[None],
                                     acc_t)
        assert out is acc_t  # in place
        np.testing.assert_allclose(out[0].numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", BSR_SHAPES)
def test_bsr_plain_segment_chain_is_bit_identical(shape):
    """Folding t-slots one acc call after another == one whole call."""
    mb, t, bm, bk, kb, n, bn = shape
    cols, blocks, b, _ = (_t(x)[None] for x in _bsr_case(shape))
    whole = K34.bsr_spmm_plain(cols, blocks, b, mb * bm)
    acc = torch.zeros_like(whole)
    for s in range(t):
        K34.bsr_spmm_acc_plain(cols[:, :, s:s + 1], blocks[:, :, s:s + 1], b,
                               acc)
    assert torch.equal(acc, whole)


@pytest.mark.parametrize("K,n,S", [(16, 8, 5), (64, 32, 20), (8, 128, 3),
                                   (128, 256, 64)])
def test_gather_plain_matches_interpret(K, n, S):
    rng = np.random.default_rng(K * 1000 + S)
    b = rng.standard_normal((K, n)).astype(np.float32)
    idx = rng.integers(-1, K, size=S).astype(np.int32)
    want = np.asarray(jref.gather_rows_ref(jnp.asarray(b), jnp.asarray(idx)))
    if (K, n, S) == INTERPRET_GATHER:
        np.testing.assert_array_equal(
            np.asarray(gather_rows_pallas(jnp.asarray(b), jnp.asarray(idx),
                                          interpret=True)), want)
    got = K1.gather_rows_plain(_t(b)[None], _t(idx)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.gather_rows_ref(_t(b), _t(idx)).numpy(),
                                  want)


@pytest.mark.parametrize("M,n,S", [(8, 16, 12), (16, 8, 30), (4, 8, 6),
                                   (32, 128, 100)])
def test_scatter_plain_matches_interpret(M, n, S):
    rng = np.random.default_rng(M * 77 + S)
    c = rng.standard_normal((M, n)).astype(np.float32)
    parts = rng.standard_normal((S, n)).astype(np.float32)
    tgt = rng.integers(-1, M, size=S).astype(np.int32)
    perm, meta = prepare_sorted_scatter(tgt)
    oracle = np.asarray(jref.scatter_add_rows_ref(
        jnp.asarray(c), jnp.asarray(parts), jnp.asarray(tgt)))
    wants = [oracle]
    if (M, n, S) == INTERPRET_SCATTER:
        wants.append(np.asarray(scatter_add_rows_sorted_pallas(
            jnp.asarray(c), jnp.asarray(parts[perm]), jnp.asarray(meta),
            interpret=True)))
    c_t = _t(c)[None].clone()
    out = K2.scatter_add_rows_plain(c_t, _t(parts)[None], _t(perm)[None],
                                    _t(meta)[None])
    assert out is c_t  # in place
    for want in wants:
        np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    got = tref.scatter_add_rows_ref(_t(c), _t(parts), _t(tgt))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


def test_scatter_plain_all_pads_leaves_c():
    c = torch.ones((1, 4, 8))
    perm, meta = prepare_sorted_scatter(np.full(3, -1, np.int32))
    out = K2.scatter_add_rows_plain(c.clone(), torch.full((1, 3, 8), 7.0),
                                    _t(perm)[None], _t(meta)[None])
    assert torch.equal(out, c)


def test_coo_accumulate_matches_reference_scatter():
    rng = np.random.default_rng(1)
    row = rng.integers(0, 6, size=(2, 20)).astype(np.int32)
    col = rng.integers(0, 9, size=(2, 20)).astype(np.int32)
    val = rng.standard_normal((2, 20)).astype(np.float32)
    b = rng.standard_normal((2, 9, 4)).astype(np.float32)
    acc = rng.standard_normal((2, 6, 4)).astype(np.float32)
    from repro.kernels.ops import coo_accumulate_rows_op as ref_op

    want = np.stack([np.asarray(ref_op(jnp.asarray(acc[p]),
                                       jnp.asarray(row[p]),
                                       jnp.asarray(col[p]),
                                       jnp.asarray(val[p]),
                                       jnp.asarray(b[p]))) for p in range(2)])
    from repro_torch.core.local_backend import coo_scatter_maps

    perm, meta = coo_scatter_maps(row, [20, 20])
    acc_t = _t(acc).clone()
    out = ops.coo_accumulate_rows_op(acc_t, _t(col), _t(val), _t(perm),
                                     _t(meta), _t(b))
    assert out is acc_t
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ops_dispatch_cpu_to_plain_without_launches():
    before = ops.launch_counts()
    rng = np.random.default_rng(0)
    b = _t(rng.standard_normal((2, 16, 8)).astype(np.float32))
    idx = _t(rng.integers(-1, 16, (2, 3, 4)).astype(np.int32))
    out = ops.pack_rows_op(b, idx)
    assert out.shape == (2, 3, 4, 8)
    assert torch.equal(out.reshape(2, 12, 8),
                       K1.gather_rows_plain(b, idx.reshape(2, 12)))
    assert ops.launch_counts() == before


def test_ops_reject_other_devices():
    """``on_card`` raises for any device but CUDA and the CPU; a meta
    operand (a dry run's planning stand-in) takes the ops' shape-only
    path instead, which launches nothing, and operands on two devices are
    refused."""
    b = torch.zeros((1, 4, 8), device="meta")
    idx = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.on_card(b, idx)
    before = ops.launch_counts()
    out = ops.pack_rows_op(b, idx)
    assert out.is_meta and tuple(out.shape) == (1, 2, 8)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="different devices"):
        ops.pack_rows_op(torch.zeros((1, 4, 8)), idx)


@pytest.mark.parametrize("M,n,S", [(8, 16, 12), (4, 8, 40)])
def test_scatter_plain_folds_in_slot_order(M, n, S):
    """The plain version seeds each segment from C and adds its slots in
    slot order, one float32 add at a time — the kernel's chain, bit for
    bit, whatever the segment lengths."""
    rng = np.random.default_rng(M + S)
    c = (rng.standard_normal((2, M, n)) * 1e3).astype(np.float32)
    parts = rng.standard_normal((2, S, n)).astype(np.float32)
    tgt = rng.integers(-1, M, size=(2, S)).astype(np.int32)
    prep = [prepare_sorted_scatter(t) for t in tgt]
    perm = np.stack([pm for pm, _ in prep])
    meta = np.stack([mt for _, mt in prep])
    want = c.copy()
    for p in range(2):
        for s in range(int(meta[p, -1])):
            row = want[p, meta[p, s]]
            row[...] = row + parts[p, perm[p, s]]  # float32, slot order
    out = K2.scatter_add_rows_plain(_t(c).clone(), _t(parts), _t(perm),
                                    _t(meta))
    assert torch.equal(out, _t(want))


def _one_nonzero_blocks(bm, bk, seed, mb=5, t=8, kb=6, n=16):
    """ELL pieces with one nonzero per stored block (the main path's fill),
    pad slots in the middle of each row's slots."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, kb, size=(mb, t)).astype(np.int32)
    cols[:, [1, 4]] = -1
    blocks = np.zeros((mb, t, bm, bk), np.float32)
    for i, s in zip(*np.nonzero(cols >= 0)):
        blocks[i, s, rng.integers(bm), rng.integers(bk)] = rng.standard_normal()
    b = rng.standard_normal((kb * bk, n)).astype(np.float32)
    return cols, blocks, b


@pytest.mark.parametrize("block", [(8, 8), (16, 8), (8, 32)], ids=str)
def test_bsr_plain_chain_on_one_nonzero_blocks(block):
    """On blocks with one nonzero each, the plain K4 over the slots one
    call at a time gives the bits of one plain K3 call, and both match the
    reference's oracle."""
    bm, bk = block
    cols, blocks, b = _one_nonzero_blocks(bm, bk, bm + bk)
    mb, t = cols.shape
    want = np.asarray(jref.bsr_spmm_ref(jnp.asarray(cols), jnp.asarray(blocks),
                                        jnp.asarray(b)))
    cols_t, blocks_t, b_t = _t(cols)[None], _t(blocks)[None], _t(b)[None]
    whole = K34.bsr_spmm_plain(cols_t, blocks_t, b_t, mb * bm)
    np.testing.assert_allclose(whole[0].numpy(), want, rtol=1e-5, atol=1e-5)
    acc = torch.zeros_like(whole)
    for s in range(t):
        K34.bsr_spmm_acc_plain(cols_t[:, :, s:s + 1], blocks_t[:, :, s:s + 1],
                               b_t, acc)
    assert torch.equal(acc, whole)


def test_scatter_plain_hub_matches_interpret_bit_for_bit():
    """A hub row (one target with 200 of 240 slots) folds in slot order in
    the plain version exactly as the reference's Pallas kernel does."""
    rng = np.random.default_rng(7)
    M, n, S = 12, 8, 240
    tgt = rng.integers(-1, M, size=S).astype(np.int32)
    tgt[rng.permutation(S)[:200]] = 5
    c = (rng.standard_normal((M, n)) * 1e3).astype(np.float32)
    parts = rng.standard_normal((S, n)).astype(np.float32)
    perm, meta = prepare_sorted_scatter(tgt)
    want = np.asarray(scatter_add_rows_sorted_pallas(
        jnp.asarray(c), jnp.asarray(parts[perm]), jnp.asarray(meta),
        interpret=True))
    out = K2.scatter_add_rows_plain(_t(c)[None].clone(), _t(parts)[None],
                                    _t(perm)[None], _t(meta)[None])
    assert torch.equal(out[0], torch.from_numpy(want))
