"""LocalComm's collectives equal jax.lax's under shard_map on 8 CPU devices."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.compat import all_to_all, ppermute, shard_map  # noqa: E402
from repro.launch.mesh import make_spmm_mesh  # noqa: E402
from repro_torch.distributed.comm import LocalComm  # noqa: E402

P = 8


def _per_rank(body, x: np.ndarray) -> np.ndarray:
    """Run ``body`` on every device's slice x[p] and stack the results."""
    mesh = make_spmm_mesh(P)
    fn = shard_map(lambda v: body(v[0])[None], mesh=mesh,
                   in_specs=(PartitionSpec("x"),),
                   out_specs=PartitionSpec("x"))
    return np.asarray(fn(jnp.asarray(x)))


def test_all_to_all_is_rank_transpose():
    x = np.random.default_rng(0).standard_normal((P, P, 3, 4)).astype(
        np.float32)
    ref = _per_rank(lambda v: all_to_all(v, "x", 0, 0, tiled=False), x)
    comm = LocalComm(P)
    out = comm.all_to_all(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)
    (op, pairs, rows), = comm.log
    assert op == "all_to_all" and len(pairs) == P * P and rows == P * P * 3


@pytest.mark.parametrize("d", range(P))
def test_shift_ppermute_is_roll(d):
    x = np.random.default_rng(d).standard_normal((P, 5, 2)).astype(np.float32)
    perm = [(q, (q + d) % P) for q in range(P)]
    ref = _per_rank(lambda v: ppermute(v, "x", perm), x)
    comm = LocalComm(P)
    np.testing.assert_array_equal(comm.shift(torch.from_numpy(x), d).numpy(),
                                  ref)
    assert comm.log == [("ppermute", tuple(perm), P * 5)]
    assert comm.rows() == P * 5


def test_partial_ppermute_zero_fills_left_out_receivers():
    x = np.random.default_rng(9).standard_normal((P, 4, 3)).astype(np.float32)
    perm = [(0, 3), (2, 5), (7, 1), (5, 0)]
    ref = _per_rank(lambda v: ppermute(v, "x", perm), x)
    comm = LocalComm(P)
    out = comm.ppermute(torch.from_numpy(x), perm)
    np.testing.assert_array_equal(out.numpy(), ref)
    for dst in set(range(P)) - {d for _, d in perm}:
        assert not out[dst].any()
    comm.reset()
    assert comm.log == [] and comm.rows() == 0


def test_ppermute_rejects_non_permutations():
    comm = LocalComm(P)
    with pytest.raises(ValueError, match="permutation"):
        comm.ppermute(torch.zeros(P, 2, 2), [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="lead with"):
        comm.ppermute(torch.zeros(P - 1, 2, 2), [(0, 1)])
