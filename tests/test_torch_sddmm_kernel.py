"""K5's plain version and oracle against the JAX package's (CPU).

The same numpy inputs go through the port's ``bsr_sddmm_plain`` and
``kernels.ref.bsr_sddmm_ref``, the reference's ``bsr_sddmm_ref`` at every
shape, and its ``bsr_sddmm_pallas`` in interpret mode at one shape.
Shapes cover F ∈ {1, 16, 33, 128}, an empty piece (t = 0), pad slots and
all-pad block rows; tolerances are ``tests/test_kernels.py``'s (float32
1e-5, bfloat16 6e-2). The CUDA kernel is tested in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.sddmm import (  # noqa: E402
    bsr_sddmm_pallas, bsr_sddmm_ref,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sddmm as K5  # noqa: E402

SHAPES = [
    # (mb, t, bm, bk, kb, F)
    (3, 4, 8, 8, 5, 1),
    (4, 3, 8, 8, 6, 16),
    (2, 5, 8, 8, 4, 33),
    (3, 2, 8, 8, 3, 128),
    (2, 3, 16, 8, 4, 24),
    (4, 0, 8, 8, 3, 16),  # an empty piece
]
INTERPRET_SHAPE = SHAPES[1]
DTYPES = [(np.float32, torch.float32, 1e-5),
          (jnp.bfloat16, torch.bfloat16, 6e-2)]


def _case(shape, seed):
    mb, t, bm, bk, kb, f = shape
    rng = np.random.default_rng(seed)
    cols = rng.integers(-1, kb, size=(mb, t)).astype(np.int32)
    if t:
        cols[0] = -1  # one all-pad block row
    blocks = rng.standard_normal((mb, t, bm, bk)).astype(np.float32)
    blocks[cols < 0] = 0.0
    x3 = rng.standard_normal((mb, bm, f)).astype(np.float32)
    y3 = rng.standard_normal((kb, bk, f)).astype(np.float32)
    return cols, blocks, x3, y3


def _t(x, dtype=None):
    a = np.array(jnp.asarray(x, jnp.float32) if dtype is torch.bfloat16
                 else x)
    t = torch.from_numpy(a)
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_sddmm_plain_matches_reference(shape, jdt, tdt, tol):
    cols, blocks, x3, y3 = _case(shape, sum(shape))
    xj, yj = jnp.asarray(x3, jdt), jnp.asarray(y3, jdt)
    want = np.asarray(bsr_sddmm_ref(jnp.asarray(cols), jnp.asarray(blocks),
                                    xj, yj), np.float32)
    wants = [want]
    if shape == INTERPRET_SHAPE:
        wants.append(np.asarray(bsr_sddmm_pallas(
            jnp.asarray(cols), jnp.asarray(blocks), xj, yj, interpret=True),
            np.float32))
    cols_t, blocks_t = _t(cols), _t(blocks)
    x_t, y_t = _t(xj, tdt), _t(yj, tdt)
    plain = K5.bsr_sddmm_plain(cols_t[None], blocks_t[None], x_t[None],
                               y_t[None])[0]
    assert plain.dtype == torch.float32 and plain.shape == blocks.shape
    oracle = tref.bsr_sddmm_ref(cols_t, blocks_t, x_t, y_t)
    assert oracle.dtype == tdt
    for got in (plain, oracle):
        for w in wants:
            np.testing.assert_allclose(got.float().numpy(), w, rtol=tol,
                                       atol=tol)
    # pad slots sample exact zeros
    assert not plain[torch.from_numpy(cols < 0)].any()


def test_sddmm_plain_stacks_ranks_and_dispatches_without_launches():
    shapes = SHAPES[2]
    per_rank = [_case(shapes, seed) for seed in (1, 2, 3)]
    stacked = [torch.from_numpy(np.stack([c[i] for c in per_rank]))
               for i in range(4)]
    before = ops.launch_counts()
    out = ops.bsr_sddmm_op(*stacked)
    assert ops.launch_counts() == before  # the CPU takes the plain version
    for p, case in enumerate(per_rank):
        want = np.asarray(bsr_sddmm_ref(*(jnp.asarray(v) for v in case)))
        np.testing.assert_allclose(out[p].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    # the port's oracle takes the leading rank axis too
    np.testing.assert_allclose(tref.bsr_sddmm_ref(*stacked).numpy(),
                               out.numpy(), rtol=1e-5, atol=1e-5)


def test_sddmm_shape_errors():
    cols, blocks, x3, y3 = (torch.from_numpy(v)[None]
                            for v in _case(SHAPES[1], 0))
    with pytest.raises(ValueError, match="shapes disagree"):
        K5.bsr_sddmm_plain(cols, blocks, x3[..., :4], y3)
    with pytest.raises(ValueError, match="takes block_cols"):
        K5.bsr_sddmm_plain(cols[0], blocks, x3, y3)
    with pytest.raises(ValueError, match="CUDA"):
        K5.bsr_sddmm_cuda(cols, blocks, x3, y3)


# the main path's kind of input: stored blocks of about one nonzero, some
# denser blocks with stored zeros among their entries, an all-zero stored
# block, and pad slots in the middle of rows; t = 37 crosses the kernel's
# 32-slot column prefetch and its 8-slot groups
SPARSE_SHAPES = [
    # (mb, t, bm, bk, kb, F)
    (3, 37, 8, 8, 6, 16),
    (2, 10, 8, 8, 4, 1),
    (2, 9, 8, 8, 5, 33),
    (2, 12, 8, 8, 3, 128),
    (2, 5, 8, 8, 3, 130),
    (2, 9, 16, 8, 4, 24),
]
SPARSE_INTERPRET_SHAPE = SPARSE_SHAPES[0]


def _sparse_case(shape, seed):
    mb, t, bm, bk, kb, f = shape
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, kb, size=(mb, t)).astype(np.int32)
    cols[:, 1::4] = -1  # pads in the middle of every row
    blocks = np.zeros((mb, t, bm, bk), np.float32)
    i, s = np.meshgrid(np.arange(mb), np.arange(t), indexing="ij")
    r = rng.integers(0, bm, size=(mb, t))
    c = rng.integers(0, bk, size=(mb, t))
    blocks[i, s, r, c] = rng.standard_normal((mb, t)).astype(np.float32)
    dense = rng.standard_normal((mb, t, bm, bk)).astype(np.float32)
    dense *= rng.random((mb, t, bm, bk)) < 0.6  # stored zeros among them
    blocks[:, 3::5] = dense[:, 3::5]
    blocks[:, 2] = 0.0  # a stored block that holds only zeros
    cols[:, 2] = 0
    blocks[cols < 0] = 0.0
    x3 = rng.standard_normal((mb, bm, f)).astype(np.float32)
    y3 = rng.standard_normal((kb, bk, f)).astype(np.float32)
    return cols, blocks, x3, y3


def _old_plain(cols, blocks, x3, y3):
    """The plain version as it stood before stored zeros wrote +0.0: the
    same chain, then ``blocks.float() * acc`` on every valid slot."""
    P, mb, t, bm, bk = blocks.shape
    kb, f = y3.shape[1], y3.shape[3]
    valid = (cols >= 0) & (cols < kb)
    ranks = torch.arange(P)[:, None, None]
    y_g = y3[ranks, torch.where(valid, cols, 0).long()]
    x = x3.double()
    acc = torch.zeros((P, mb, t, bm, bk))
    for k in range(f):
        acc = (x[:, :, None, :, None, k] * y_g[:, :, :, None, :, k].double()
               + acc.double()).float()
    out = blocks.float() * acc
    return torch.where(valid[..., None, None], out, torch.zeros(()))


@pytest.mark.parametrize("shape", SPARSE_SHAPES, ids=str)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_sddmm_plain_on_sparse_blocks_matches_reference(shape, jdt, tdt, tol):
    cols, blocks, x3, y3 = _sparse_case(shape, sum(shape))
    xj, yj = jnp.asarray(x3, jdt), jnp.asarray(y3, jdt)
    wants = [np.asarray(bsr_sddmm_ref(jnp.asarray(cols), jnp.asarray(blocks),
                                      xj, yj), np.float32)]
    if shape == SPARSE_INTERPRET_SHAPE:
        wants.append(np.asarray(bsr_sddmm_pallas(
            jnp.asarray(cols), jnp.asarray(blocks), xj, yj, interpret=True),
            np.float32))
    args = (_t(cols)[None], _t(blocks)[None], _t(xj, tdt)[None],
            _t(yj, tdt)[None])
    plain = K5.bsr_sddmm_plain(*args)
    for w in wants:
        np.testing.assert_allclose(plain[0].numpy(), w, rtol=tol, atol=tol)
    # nonzero entries keep the old expression's bits; every other entry
    # (a stored zero, the all-zero block, a pad) is +0.0
    nz = args[1] != 0
    assert torch.equal(plain[nz], _old_plain(*args)[nz])
    assert not plain[~nz].any() and not plain[~nz].signbit().any()


def test_sddmm_plain_rounds_each_fma_once():
    """A step where rounding x·y + acc to float64 and then to float32
    lands on a float32 tie that the exact sum does not: acc = 64 + 2⁻¹⁷
    (odd last bit), x·y = 2⁻¹⁸ − 2⁻⁶⁴. The kernel's ``__fmaf_rn`` keeps acc;
    two roundings would give 64 + 2⁻¹⁶."""
    acc0 = 64 + 2.0 ** -17
    x3 = torch.tensor([acc0, 2.0 ** -9 * (1 + 2.0 ** -23)]).expand(
        1, 1, 8, 2).contiguous()
    y3 = torch.tensor([1.0, 2.0 ** -9 * (1 - 2.0 ** -23)]).expand(
        1, 1, 8, 2).contiguous()
    cols = torch.zeros((1, 1, 1), dtype=torch.int32)
    blocks = torch.ones((1, 1, 1, 8, 8))
    out = K5.bsr_sddmm_plain(cols, blocks, x3, y3)
    assert torch.equal(out, torch.full_like(out, acc0))
    assert float(torch.tensor(acc0 + 2.0 ** -18 - 2.0 ** -64,
                              dtype=torch.float64).float()) == 64 + 2.0 ** -16
