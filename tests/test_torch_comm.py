"""LocalComm's collectives equal jax.lax's under shard_map on 8 CPU devices.

The flat axis on ``make_spmm_mesh(P)``; the (G, L) grid collectives on
``make_spmm_mesh(P, groups=G)`` (rank p = (p // L, p % L)), and the
reduce-scatter's fixed ascending-l fold; the replica layout's lane
exchange and replica-axis reduce-scatter on the reference's
``Topology.replicated_mesh(c, s)`` (rank p = r·s + g), its fold's fixed
ascending-r chain, and B's c-fold copy.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.compat import (  # noqa: E402
    all_to_all, ppermute, psum_scatter, shard_map,
)
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


GRIDS = [(2, 4), (4, 2)]


def _per_grid_rank(body, x: np.ndarray, G: int) -> np.ndarray:
    """``body`` on every device of the (G, L) mesh, x[p] at device
    (p // L, p % L); results stacked in rank order."""
    L = P // G
    mesh = make_spmm_mesh(P, groups=G)
    gl = PartitionSpec("g", "l")
    fn = shard_map(lambda v: body(v[0, 0])[None, None], mesh=mesh,
                   in_specs=(gl,), out_specs=gl)
    out = np.asarray(fn(jnp.asarray(x.reshape((G, L) + x.shape[1:]))))
    return out.reshape((P,) + out.shape[2:])


@pytest.mark.parametrize("G", [g for g, _ in GRIDS])
def test_group_all_to_all_matches_jax(G):
    x = np.random.default_rng(G).standard_normal((P, G, 3, 4)).astype(
        np.float32)
    ref = _per_grid_rank(lambda v: all_to_all(v, "g", 0, 0, tiled=False), x,
                         G)
    comm = LocalComm(P, groups=G)
    np.testing.assert_array_equal(
        comm.group_all_to_all(torch.from_numpy(x)).numpy(), ref)
    (op, pairs, rows), = comm.log
    L = P // G
    assert op == "all_to_all@g" and rows == P * G * 3
    assert {(s % L, d % L) for s, d in pairs} == {(l, l) for l in range(L)}
    assert comm.rows("g") == rows and comm.rows("l") == comm.rows("x") == 0


@pytest.mark.parametrize("G", [g for g, _ in GRIDS])
def test_group_shift_matches_jax_ppermute(G):
    x = np.random.default_rng(G + 1).standard_normal((P, 5, 2)).astype(
        np.float32)
    comm = LocalComm(P, groups=G)
    for dg in range(G):
        perm = [(g, (g + dg) % G) for g in range(G)]
        ref = _per_grid_rank(lambda v: ppermute(v, "g", perm), x, G)
        np.testing.assert_array_equal(
            comm.group_shift(torch.from_numpy(x), dg).numpy(), ref)
    # the group shift by dg is the global shift by dg·L ranks
    L = P // G
    assert [pairs for _, pairs, _ in comm.log] == [
        tuple((q, (q + dg * L) % P) for q in range(P)) for dg in range(G)]
    assert comm.rows("g") == G * P * 5


@pytest.mark.parametrize("G", [g for g, _ in GRIDS])
@pytest.mark.parametrize("dim", [0, 1])
def test_local_psum_scatter_matches_jax(G, dim):
    """Integer-valued operands, so every order of the sum is exact and the
    comparison with jax's reduce-scatter can be bit for bit."""
    L = P // G
    shape = [(P, 3 * L, 2, 4), (P, 3, 2 * L, 4)][dim]
    x = np.random.default_rng(dim).integers(-50, 50, shape).astype(
        np.float32)
    ref = _per_grid_rank(lambda v: psum_scatter(
        v, "l", scatter_dimension=dim, tiled=True), x, G)
    comm = LocalComm(P, groups=G)
    out = comm.local_psum_scatter(torch.from_numpy(x), dim)
    np.testing.assert_array_equal(out.numpy(), ref)
    (op, pairs, rows), = comm.log
    assert op == "psum_scatter@l" and rows == int(np.prod(shape[:-1]))
    assert {(s // L, d // L) for s, d in pairs} == {(g, g) for g in range(G)}


@pytest.mark.parametrize("G", [g for g, _ in GRIDS])
def test_local_all_gather_matches_jax(G):
    x = np.random.default_rng(G + 7).standard_normal((P, 3, 2)).astype(
        np.float32)
    ref = _per_grid_rank(lambda v: jax.lax.all_gather(
        v, "l", axis=0, tiled=False), x, G)
    comm = LocalComm(P, groups=G)
    out = comm.local_all_gather(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.shape == (P, P // G, 3, 2)
    assert comm.log[0][0] == "all_gather@l" and comm.rows("l") == P * 3


@pytest.mark.parametrize("G", [g for g, _ in GRIDS])
def test_psum_scatter_ascending_fold_is_shape_independent(G):
    """The reduce-scatter sums in one fixed chain, x[(g, 0)] + x[(g, 1)] +
    … + x[(g, L-1)] left to right: the staged executor's reduce-scatter
    of the whole [G, L·m, N] operand and the overlapped executor's one
    per group shift give the same bits, and both equal that chain."""
    L = P // G
    m, n = 5, 3
    x = torch.from_numpy(np.random.default_rng(G).standard_normal(
        (P, G, L * m, n)).astype(np.float32) * 10 ** np.random.default_rng(
        G + 1).uniform(-4, 4, (P, G, L * m, 1)).astype(np.float32))
    comm = LocalComm(P, groups=G)
    staged = comm.local_psum_scatter(x, 1)  # [P, G, m, n]
    v = x.reshape(G, L, G, L * m, n)
    chain = v[:, 0].clone()
    for l in range(1, L):
        chain = chain + v[:, l]
    for dg in range(G):
        per_shift = comm.local_psum_scatter(x[:, dg], 0)  # [P, m, n]
        assert torch.equal(per_shift, staged[:, dg])
        for g in range(G):
            for l in range(L):
                assert torch.equal(per_shift[g * L + l],
                                   chain[g, dg, l * m:(l + 1) * m])
    assert comm.rows("l") == P * G * L * m * 2


def test_grid_rejects_bad_shapes():
    with pytest.raises(ValueError, match="does not divide"):
        LocalComm(P, groups=3)
    comm = LocalComm(P, groups=2)
    with pytest.raises(ValueError, match="group all_to_all"):
        comm.group_all_to_all(torch.zeros(P, 3, 2))
    with pytest.raises(ValueError, match="not divisible"):
        comm.local_psum_scatter(torch.zeros(P, 6, 2), 0)


# ----- the (c, s) replica x shard layout ----------------------------------

REPLICAS = [2, 4]


def _per_replica_rank(body, x: np.ndarray, c: int) -> np.ndarray:
    """``body`` on every rank (r, g) of the reference's (c, s) replicated
    mesh (``Topology.replicated_mesh``), stacked lane-major."""
    from repro.distributed.topology import Topology

    s = P // c
    mesh, ra, ax = Topology.resolve(P).replicated_mesh(c, s)
    rx = PartitionSpec(ra, ax)
    fn = shard_map(lambda v: body(v[0, 0])[None, None], mesh=mesh,
                   in_specs=(rx,), out_specs=rx)
    out = np.asarray(fn(jnp.asarray(x.reshape((c, s) + x.shape[1:]))))
    return out.reshape((P,) + out.shape[2:])


@pytest.mark.parametrize("c", REPLICAS)
def test_lane_shift_matches_jax_lane_perm(c):
    """Every lane on its own shift inside its s ranks, one joint ppermute
    over (replica, shard) as the reference's ``_lane_perm``; lanes outside
    the round receive zeros, and the log counts the sending ranks' rows
    only."""
    s = P // c
    rng = np.random.default_rng(c)
    x = rng.standard_normal((P, 5, 3)).astype(np.float32)
    comm = LocalComm(P, replicas=c)
    rounds = [(tuple(int(v) for v in rng.integers(0, s, c)),
               tuple(range(c))),
              (tuple(1 + r % (s - 1) for r in range(c)), (c - 1,)),
              (tuple(range(c)), (0,) if c == 2 else (1, 3))]
    for shifts, lanes in rounds:
        perm = [(r * s + g, r * s + (g + shifts[r]) % s)
                for r in lanes for g in range(s)]
        ref = _per_replica_rank(lambda v: ppermute(v, ("r", "x"), perm), x,
                                c)
        got = comm.lane_shift(torch.from_numpy(x), shifts, lanes)
        np.testing.assert_array_equal(got.numpy(), ref)
        idle = [r for r in range(c) if r not in lanes]
        assert not got.reshape(c, s, 5, 3)[idle].any()
        op, pairs, rows = comm.log[-1]
        assert op == "ppermute@s" and pairs == tuple(perm)
        assert rows == s * len(lanes) * 5
    assert comm.rows("s") == sum(s * len(l) * 5 for _, l in rounds)
    assert comm.rows("r") == comm.rows("x") == comm.rows("g") == 0


@pytest.mark.parametrize("c", REPLICAS)
def test_replica_psum_scatter_matches_jax(c):
    """Integer-valued operands, so every order of the sum is exact and the
    comparison with jax's tiled reduce-scatter over the replica axis can
    be bit for bit; the result comes in (g, r) order, so its reshape is
    the global row order of the reference's ``P((shard, replica))``."""
    s = P // c
    x = np.random.default_rng(c + 3).integers(-50, 50, (P, 3 * c, 4)).astype(
        np.float32)
    ref = _per_replica_rank(lambda v: psum_scatter(
        v, "r", scatter_dimension=0, tiled=True), x, c)  # [P, 3, 4]
    comm = LocalComm(P, replicas=c)
    out = comm.replica_psum_scatter(torch.from_numpy(x))
    assert out.shape == (s, c, 3, 4)
    for r in range(c):
        for g in range(s):
            np.testing.assert_array_equal(out[g, r].numpy(), ref[r * s + g])
    (op, pairs, rows), = comm.log
    assert op == "psum_scatter@r" and rows == P * 3 * c
    assert {(a % s, b % s) for a, b in pairs} == {(g, g) for g in range(s)}
    assert comm.rows("r") == rows and comm.rows("s") == 0


@pytest.mark.parametrize("c", REPLICAS)
def test_replica_fold_is_one_ascending_chain(c):
    """The replica reduce-scatter sums in one fixed chain x[(0, g)] +
    x[(1, g)] + … + x[(c-1, g)], left to right, whatever the values'
    scales: its bits equal that staged sum."""
    s, m, n = P // c, 2 * c, 3
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.standard_normal((P, m, n)).astype(np.float32)
                         * 10 ** rng.uniform(-4, 4, (P, m, 1)).astype(
                             np.float32))
    out = LocalComm(P, replicas=c).replica_psum_scatter(x)
    v = x.reshape(c, s, m, n)
    chain = v[0].clone()
    for r in range(1, c):
        chain = chain + v[r]
    assert torch.equal(out.reshape(s, m, n), chain)


@pytest.mark.parametrize("c", REPLICAS)
def test_replicate_copies_every_shard_to_every_lane(c):
    s = P // c
    x = torch.arange(s * 6 * 2, dtype=torch.float32).reshape(s, 6, 2)
    comm = LocalComm(P, replicas=c)
    out = comm.replicate(x)
    assert out.shape == (P, 6, 2)
    for r in range(c):
        assert torch.equal(out[r * s:(r + 1) * s], x)
    out[0, 0, 0] = -1.0  # one copy of its own, not a view of x
    assert x[0, 0, 0] == 0.0
    (op, pairs, rows), = comm.log
    assert op == "broadcast@r" and rows == P * 6
    assert set(pairs) == {(g, r * s + g) for r in range(c) for g in range(s)}


def test_replica_layout_rejects_bad_shapes():
    with pytest.raises(ValueError, match="does not divide"):
        LocalComm(P, replicas=3)
    comm = LocalComm(P, replicas=2)
    with pytest.raises(ValueError, match="one shift per lane"):
        comm.lane_shift(torch.zeros(P, 2, 2), (1,), (0,))
    with pytest.raises(ValueError, match="distinct lanes"):
        comm.lane_shift(torch.zeros(P, 2, 2), (1, 1), (0, 0))
    with pytest.raises(ValueError, match="c=2 \\| rows"):
        comm.replica_psum_scatter(torch.zeros(P, 3, 2))
    with pytest.raises(ValueError, match="replicate operand"):
        comm.replicate(torch.zeros(P, 3, 2))
