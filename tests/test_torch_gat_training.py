"""GAT training through the port's fused handle against ``repro`` (CPU).

On ``normalize_adjacency`` of ``power_law_matrix`` at P = 8, a 2-layer
GAT (8 → 16 → 4, att_dim 8) with the same numpy weights in ``GAT.init``'s
layout: every parameter's gradient of ``gat_loss`` from the port's
``backward()`` through its coo fused handle equals the reference's
``jax.grad(gat_loss)`` through its own, and a float64 dense oracle's,
within rtol 2e-3 / atol 2e-4 (``tests/test_sddmm.py``'s GAT tolerance),
on the flat and the hier tier. The bsr SDDMM differentiates through K5's
Function (against the reference's ``jax.grad`` of the same values, same
tolerance); a bsr fused call under grad raises, as the reference's bsr
SpMM phase has no JVP. A few AdamW steps lower the loss and repeat bit
for bit, and the example's ``main()`` trains on ``--device cpu``.
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
from repro_torch.optim import adamw as t_opt  # noqa: E402

P = 8
DIMS, ATT = (8, 16, 4), 8
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _problem(power_law_matrix, seed=3):
    adj = r_gnn.normalize_adjacency(power_law_matrix())
    n = adj.shape[0]
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, DIMS[0])).astype(np.float32)
    labels = rng.integers(0, DIMS[-1], n)
    return adj, feats, labels, t_gnn.gat_params(DIMS, ATT, seed=0)


def _dense_fused(adj):
    a = torch.from_numpy(adj.to_dense().astype(np.float64))

    def fused(q, k, v):
        return torch.nn.functional.leaky_relu(a * (q @ k.T), 0.2) @ v
    return fused


@pytest.mark.parametrize("hier", [None, (2, 4)], ids=["flat", "hier"])
def test_gat_grads_match_reference_and_dense(hier, power_law_matrix):
    adj, feats, labels, params = _problem(power_law_matrix)
    kw = dict(edge="leaky_relu", hier=hier)
    ref = R.compile_fused(adj, P, **kw)
    h = T.compile_fused(_port_csr(adj), P, device="cpu", **kw)
    assert h.decisions == ref.decisions
    rp = [{k: jnp.asarray(v) for k, v in lp.items()} for lp in params]
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: r_gnn.gat_loss(p, jnp.asarray(feats), jnp.asarray(labels),
                                 ref)))(rp)

    model = t_gnn.gat_from_numpy(params, device="cpu")
    loss = t_gnn.gat_loss(model, torch.from_numpy(feats),
                          torch.from_numpy(labels), h)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4,
                               atol=2e-4)
    loss.backward()
    oracle = t_gnn.gat_from_numpy(params, device="cpu").double()
    t_gnn.gat_loss(oracle, torch.from_numpy(feats).double(),
                   torch.from_numpy(labels), _dense_fused(adj)).backward()
    for i, (layer, o_layer) in enumerate(zip(model.layers, oracle.layers)):
        for name in ("wq", "wk", "wv", "b"):
            got = getattr(layer, name).grad
            assert got is not None, f"layer {i} {name}: no grad"
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(want_g[i][name]),
                                       **GRAD_TOL)
            np.testing.assert_allclose(got.numpy(),
                                       getattr(o_layer, name).grad.numpy(),
                                       **GRAD_TOL)


def test_bsr_sddmm_grads_match_reference(power_law_matrix):
    """½ Σ vals² over the pieces (each stored nonzero once): K5's
    Function against the reference's K5 custom_jvp, and against
    ``(A⊙A⊙XYᵀ) Y`` / its transpose in float64."""
    adj, _, _, _ = _problem(power_law_matrix)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((adj.shape[0], ATT)).astype(np.float32)
    y = rng.standard_normal((adj.shape[1], ATT)).astype(np.float32)
    ref = R.compile_sddmm(adj, P, backends=("coo", "bsr"))
    want = jax.jit(jax.grad(lambda a, b: 0.5 * sum(
        jnp.sum(jnp.square(v.astype(jnp.float32)))
        for v in ref(a, b, backend="bsr").values()), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(y))
    h = T.compile_sddmm(_port_csr(adj), P, backends=("coo", "bsr"),
                        device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    vals = h(xt, yt, backend="bsr")
    (0.5 * sum(v.float().square().sum() for v in vals.values())).backward()
    a = adj.to_dense().astype(np.float64)
    s = a * a * (x.astype(np.float64) @ y.T)
    for got, ref_g, dense in ((xt.grad, want[0], s @ y),
                              (yt.grad, want[1], s.T @ x)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_g),
                                   **GRAD_TOL)
        np.testing.assert_allclose(got.numpy(), dense, **GRAD_TOL)


def test_bsr_fused_under_grad_raises(power_law_matrix):
    adj, feats, labels, params = _problem(power_law_matrix)
    h = T.compile_fused(_port_csr(adj), P, backends=("coo", "bsr"),
                        edge="leaky_relu", device="cpu")
    model = t_gnn.gat_from_numpy(params, device="cpu")
    x = torch.from_numpy(feats)
    with pytest.raises(NotImplementedError, match="no JVP"):
        t_gnn.gat_forward(model, x,
                          lambda q, k, v: h(q, k, v, backend="bsr"))
    with torch.no_grad():  # inference serves bsr as before
        out = t_gnn.gat_forward(model, x,
                                lambda q, k, v: h(q, k, v, backend="bsr"))
    np.testing.assert_allclose(out.numpy(), t_gnn.gat_forward(
        model, x, h).detach().numpy(), rtol=2e-4, atol=2e-4)


def test_gat_training_reduces_loss_and_repeats(power_law_matrix):
    adj, feats, labels, params = _problem(power_law_matrix, seed=4)
    h = T.compile_fused(_port_csr(adj), P, edge="leaky_relu", device="cpu")
    x, y = torch.from_numpy(feats), torch.from_numpy(labels)
    cfg = t_opt.AdamWConfig(lr=5e-3, weight_decay=0.0, warmup_steps=0,
                            schedule="constant")

    def run(steps):
        model = t_gnn.gat_from_numpy(params, device="cpu")
        ps = list(model.parameters())
        state, losses = t_opt.adamw_init(ps), []
        for _ in range(steps):
            loss = t_gnn.gat_loss(model, x, y, h)
            loss.backward()
            state, _ = t_opt.adamw_step(cfg, ps, state)
            losses.append(loss.item())
        return ps, losses

    ps, losses = run(5)
    assert losses[-1] < losses[0]
    again, _ = run(5)
    assert all(torch.equal(a, b) for a, b in zip(ps, again))
    # the fused call's backward carried the forward's rows
    loss = t_gnn.gat_loss(t_gnn.gat_from_numpy(params, device="cpu"), x, y,
                          lambda q, k, v: h(q, k, v))
    n_calls = len(params)
    fwd = h.comm.rows()  # the log holds the last call's forward
    loss.backward()
    assert h.comm.rows(None, "bwd") == n_calls * fwd


def test_gat_params_layout():
    params = t_gnn.gat_params((8, 16, 16, 4), 8, seed=1)
    assert [tuple(lp["wv"].shape) for lp in params] == [(8, 16), (16, 16),
                                                         (16, 4)]
    assert all(lp["wq"].shape[1] == 8 and not lp["b"].any()
               for lp in params)
    model = t_gnn.gat_from_numpy(params, device="cpu")
    for got, want in zip(model.to_numpy(), params):
        for name in ("wq", "wk", "wv", "b"):
            np.testing.assert_array_equal(got[name], want[name])


def test_gat_training_example_runs_on_cpu(capsys):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "torch_gat_training.py"
    spec = importlib.util.spec_from_file_location("torch_gat_training", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--epochs", "4", "--nodes", "128",
              "--edges", "1024"])
    out = capsys.readouterr().out
    assert "device cpu" in out and "fused handle: kernel=fused" in out
    assert "final loss" in out
