"""K1's scaled form (the coo gather with its multiply) against the reference, on the CPU.

``gather_rows_scaled_plain`` is what the CPU path runs and what the CUDA
kernel is held against on the card (``tests/test_torch_cuda.py``). It must
give the bits of the reference's coo product ``b[col] * val[:, None]``
cast to the accumulator's dtype, with the reference's gather oracle
supplying the zero rows of pad slots (idx < 0): float32 and bfloat16 b,
negative values, pads (where a negative value gives -0.0), infs and NaNs
in b, and no slots at all. ``ops.coo_accumulate_rows_op`` now takes the
scaled form in one step; on the CPU it gives the bits of the former
gather, multiply and fold.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.local_backend import coo_scatter_maps  # noqa: E402
from repro_torch.kernels import gather_rows as K1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import scatter_add_rows as K2  # noqa: E402

DTYPES = [(np.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _bits(x) -> np.ndarray:
    """A float32 / bfloat16 array's bit patterns, every NaN as one pattern
    (the two packages may give NaNs of another sign or payload)."""
    a = np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x, np.float32))
    bits = a.view(np.uint32).copy()
    bits[np.isnan(a)] = 0x7FC00000
    return bits


def _reference(b, idx, val, jdt):
    """The reference's coo product, per rank: its gather oracle (zero rows
    for idx < 0) times val, cast to the accumulator's (b's) dtype."""
    return np.stack([np.asarray(
        (jref.gather_rows_ref(jnp.asarray(b[p], jdt), jnp.asarray(idx[p]))
         * jnp.asarray(val[p])[:, None]).astype(jdt), np.float32)
        for p in range(b.shape[0])])


def _case(P, K, S, n, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((P, K, n)).astype(np.float32) * 3
    idx = rng.integers(-1, K, size=(P, S)).astype(np.int32)
    val = rng.standard_normal((P, S)).astype(np.float32)
    return b, idx, val, rng


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("P,K,S,n", [(2, 9, 40, 16), (3, 5, 7, 3),
                                     (1, 4, 0, 8), (2, 3, 5, 130)])
def test_scaled_plain_is_the_reference_product_bit_for_bit(jdt, tdt, P, K,
                                                           S, n):
    b, idx, val, rng = _case(P, K, S, n, P * 100 + S + n)
    if S:
        idx[:, 0] = -1
        val[:, 0] = -2.0  # a pad with a negative value: -0.0
        val[:, 1] = 0.0
        val[:, -1] = -abs(val[:, -1])
        b[:, 0, 0] = np.inf
        b[:, 1, -1] = -np.inf
        b[:, 2 % K, n // 2] = np.nan
        idx[:, 1:4] = [0, 1, 2 % K]
    want = _reference(b, idx, val, jdt)
    b_t = torch.from_numpy(np.array(jnp.asarray(b, jdt), np.float32)).to(
        tdt)
    got = K1.gather_rows_scaled_plain(b_t, torch.from_numpy(idx),
                                      torch.from_numpy(val), tdt)
    assert got.dtype == tdt and got.shape == (P, S, n)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if S:
        assert torch.signbit(got[:, 0]).all() and not got[:, 0].any()
        assert not bool(got.isfinite().all())  # the infs and the NaN got in


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coo_accumulate_keeps_the_former_bits(dtype):
    """The seeds and shapes of ``test_coo_accumulate_matches_reference_
    scatter``: one scaled gather and the fold give the bits of the former
    gather (K1 pack), multiply and fold, and launch nothing on the CPU."""
    rng = np.random.default_rng(1)
    row = rng.integers(0, 6, size=(2, 20)).astype(np.int32)
    col = rng.integers(0, 9, size=(2, 20)).astype(np.int32)
    val = torch.from_numpy(rng.standard_normal((2, 20)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 9, 4)).astype(
        np.float32)).to(dtype)
    acc = torch.from_numpy(rng.standard_normal((2, 6, 4)).astype(
        np.float32)).to(dtype)
    perm, meta = (torch.from_numpy(x) for x in coo_scatter_maps(row,
                                                                [20, 20]))
    col = torch.from_numpy(col)
    former = K2.scatter_add_rows_plain(
        acc.clone(), (K1.gather_rows_plain(b, col) * val[..., None]).to(dtype),
        perm, meta)
    before = ops.launch_counts()
    out = ops.coo_accumulate_rows_op(acc.clone(), col, val, perm, meta, b)
    assert ops.launch_counts() == before
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       former.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32))


def test_scaled_plain_takes_the_accumulator_dtype():
    """bfloat16 b into a float32 output: the product is not rounded to
    bfloat16 on the way (torch's promotion: one float32 multiply)."""
    b, idx, val, _ = _case(2, 6, 10, 8, 3)
    b_t = torch.from_numpy(b).to(torch.bfloat16)
    got = K1.gather_rows_scaled_plain(b_t, torch.from_numpy(idx),
                                      torch.from_numpy(val), torch.float32)
    want = (K1.gather_rows_plain(b_t, torch.from_numpy(idx)).float()
            * torch.from_numpy(val)[..., None])
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_coo_op_rejects_mixed_devices():
    b = torch.zeros((1, 4, 8))
    col = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        ops.coo_accumulate_rows_op(torch.zeros((1, 3, 8)), col,
                                   torch.zeros((1, 2)), col, col, b)
