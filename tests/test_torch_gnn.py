"""The port's GAT inference against ``repro.models.gnn`` (CPU, plain versions).

A 256-node graph on 8 ranks, ``GAT.init``-shaped parameters made with
numpy: the reference's ``gat_forward`` through its fused handle and the
port's through its own (weights carried by ``gat_from_numpy``) agree
within 2e-4 on coo and bsr, and with a float64 dense oracle.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as R  # noqa: E402
from repro.models import gnn as r_gnn  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.models import gnn as t_gnn  # noqa: E402

P = 8
NODES, FEAT, HIDDEN, CLASSES, ATT = 256, 12, 16, 5, 8
TOL = dict(rtol=2e-4, atol=2e-4)


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _params(seed=0, dims=(FEAT, HIDDEN, CLASSES), att=ATT):
    """numpy parameters in ``GAT.init``'s layout and scale."""
    rng = np.random.default_rng(seed)
    out = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        scale = d_in ** -0.5
        out.append({
            "wq": (rng.standard_normal((d_in, att)) * scale).astype(np.float32),
            "wk": (rng.standard_normal((d_in, att)) * scale).astype(np.float32),
            "wv": (rng.standard_normal((d_in, d_out)) * scale).astype(
                np.float32),
            "b": (0.1 * rng.standard_normal(d_out)).astype(np.float32),
        })
    return out


def _graph():
    a = R.random_sparse(NODES, NODES, 0.03, seed=3)
    return r_gnn.normalize_adjacency(a)


def _dense_forward(adj, params, feats):
    a = adj.to_dense().astype(np.float64)
    h = feats.astype(np.float64)
    for i, lp in enumerate(params):
        q, k = h @ lp["wq"], h @ lp["wk"]
        v = h @ lp["wv"] + lp["b"]
        s = a * (q @ k.T)
        h = np.where(s > 0, s, 0.2 * s) @ v
        if i < len(params) - 1:
            h = np.maximum(h, 0)
    return h


def test_normalize_adjacency_equals_reference():
    a = R.random_sparse(NODES, NODES, 0.03, seed=3)
    want = r_gnn.normalize_adjacency(a)
    got = t_gnn.normalize_adjacency(_port_csr(a))
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.mark.parametrize("backend", ["coo", "bsr"])
def test_gat_forward_matches_reference(backend):
    adj = _graph()
    params = _params()
    feats = np.random.default_rng(1).standard_normal(
        (NODES, FEAT)).astype(np.float32)
    backends = tuple(dict.fromkeys(("coo", backend)))
    ref_h = R.compile_fused(adj, P, backends=backends, edge="leaky_relu")
    want = np.asarray(r_gnn.gat_forward(
        [{k: jnp.asarray(v) for k, v in lp.items()} for lp in params],
        jnp.asarray(feats),
        lambda q, k, v: ref_h(q, k, v, backend=backend)))

    h = T.compile_fused(t_gnn.normalize_adjacency(_port_csr(
        R.random_sparse(NODES, NODES, 0.03, seed=3))), P,
        backends=backends, edge="leaky_relu", device="cpu")
    assert h.decisions == ref_h.decisions
    model = t_gnn.gat_from_numpy(params, NODES, device="cpu")
    got = t_gnn.gat_forward(model, torch.from_numpy(feats),
                            lambda q, k, v: h(q, k, v, backend=backend))
    assert got.shape == (NODES, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(),
                               _dense_forward(adj, params, feats), **TOL)
    # the module's forward is the same call
    assert torch.equal(model(torch.from_numpy(feats),
                             lambda q, k, v: h(q, k, v, backend=backend)),
                       got)


def test_gat_from_numpy_shapes():
    params = _params(dims=(FEAT, HIDDEN, HIDDEN, CLASSES))
    model = t_gnn.gat_from_numpy(params, device="cpu")
    assert len(model.layers) == 3 and model.att_dim == ATT
    assert torch.equal(model.layers[1].wv, torch.from_numpy(params[1]["wv"]))
    fresh = t_gnn.GAT(NODES, FEAT, HIDDEN, CLASSES, n_layers=3, att_dim=ATT,
                      device="cpu")
    fresh.load_numpy(params)
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        t_gnn.GAT(NODES, FEAT, HIDDEN, CLASSES, att_dim=4,
                  device="cpu").load_numpy(params[:2])
    with pytest.raises(ValueError, match="parameter dicts"):
        fresh.load_numpy(params[:1])


def test_gat_entry_points_default_to_the_card():
    """Like compile_* and Topology.local, the model's entry points put the
    weights on the card unless the caller asks for the CPU."""
    import inspect

    for fn in (t_gnn.gat_from_numpy, t_gnn.GAT):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
