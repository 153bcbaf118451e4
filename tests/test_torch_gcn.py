"""The port's GCN against ``repro.models.gnn`` (CPU, plain versions).

On ``normalize_adjacency`` of ``power_law_matrix`` at P = 8, a 3-layer
GCN (12 → 16 → 16 → 5) with the same numpy weights in ``GCN.init``'s
layout: the port's ``gcn_forward`` through its handle (``make_spmm_fn``)
and the reference's through its own agree within the executor tolerance
2e-4, and so do ``gcn_loss`` and every parameter's gradient (port's
``backward()`` against the reference's ``jax.grad``; rtol 2e-3 / atol
2e-4, the reference's GAT-gradient tolerance, ``tests/test_sddmm.py``).
Three training steps with AdamW (lr 5e-3, warmup 10, the example's
config) on both sides give parameters within 2e-4 (each step moves a
parameter by at most about lr; float32 in both). The example's
``main()`` trains on ``--device cpu``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as R  # noqa: E402
from repro.models import gnn as r_gnn  # noqa: E402
from repro.optim import adamw as r_opt  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import make_spmm_fn  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.models import gnn as t_gnn  # noqa: E402
from repro_torch.optim import adamw as t_opt  # noqa: E402

P = 8
DIMS = (12, 16, 16, 5)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _problem(power_law_matrix, seed=1):
    adj = r_gnn.normalize_adjacency(power_law_matrix())
    n = adj.shape[0]
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, DIMS[0])).astype(np.float32)
    labels = rng.integers(0, DIMS[-1], n)
    return adj, feats, labels, t_gnn.gcn_params(DIMS, seed=0)


def _handles(adj, **cfg):
    ref = R.compile_spmm(adj, P, R.SpmmConfig(**cfg))
    h = T.compile_spmm(_port_csr(adj), P, T.SpmmConfig(**cfg), device="cpu")
    assert h.decisions == ref.decisions
    return ref, h


def _ref_loss(ref, feats, labels):
    spmm = r_gnn.make_spmm_fn(ref)
    return lambda p: r_gnn.gcn_loss(p, jnp.asarray(feats),
                                    jnp.asarray(labels), spmm)


@pytest.mark.parametrize("cfg", [dict(), dict(schedule=2, overlap=True),
                                 dict(hier=(2, 4))],
                         ids=["auto", "overlapped", "hier"])
def test_gcn_forward_loss_and_grads_match_reference(cfg, power_law_matrix):
    adj, feats, labels, params = _problem(power_law_matrix)
    ref, h = _handles(adj, **cfg)
    rp = [{k: jnp.asarray(v) for k, v in lp.items()} for lp in params]
    want_out = np.asarray(r_gnn.gcn_forward(rp, jnp.asarray(feats),
                                            r_gnn.make_spmm_fn(ref)))
    want_loss, want_g = jax.jit(jax.value_and_grad(
        _ref_loss(ref, feats, labels)))(rp)

    model = t_gnn.gcn_from_numpy(params, adj.shape[0], device="cpu")
    spmm = make_spmm_fn(h)
    x = torch.from_numpy(feats)
    out = t_gnn.gcn_forward(model, x, spmm)
    assert out.shape == (adj.shape[0], DIMS[-1])
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
    dense = adj.to_dense().astype(np.float64)
    np.testing.assert_allclose(
        out.detach().numpy(),
        t_gnn.gcn_forward(model.double(), x.double(),
                          lambda v: torch.from_numpy(dense) @ v
                          ).detach().numpy(), **FWD_TOL)
    model.float()
    loss = t_gnn.gcn_loss(model, x, torch.from_numpy(labels), spmm)
    np.testing.assert_allclose(loss.item(), float(want_loss), **FWD_TOL)
    loss.backward()
    for i, layer in enumerate(model.layers):
        for name in ("w", "b"):
            got = getattr(layer, name).grad
            assert got is not None, f"layer {i} {name}: no grad"
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(want_g[i][name]),
                                       **GRAD_TOL)


def test_three_adamw_steps_match_reference(power_law_matrix):
    adj, feats, labels, params = _problem(power_law_matrix, seed=2)
    ref, h = _handles(adj)
    kw = dict(lr=5e-3, weight_decay=0.0, warmup_steps=10, total_steps=200)
    rcfg, tcfg = r_opt.AdamWConfig(**kw), t_opt.AdamWConfig(**kw)
    rp = [{k: jnp.asarray(v) for k, v in lp.items()} for lp in params]
    rs = r_opt.adamw_init(rp)
    step = jax.jit(jax.value_and_grad(_ref_loss(ref, feats, labels)))

    model = t_gnn.gcn_from_numpy(params, device="cpu")
    ps = list(model.parameters())
    ts = t_opt.adamw_init(ps)
    spmm = make_spmm_fn(h)
    for _ in range(3):
        r_loss, g = step(rp)
        rp, rs, _ = r_opt.adamw_update(rcfg, rp, g, rs)
        loss = t_gnn.gcn_loss(model, torch.from_numpy(feats),
                              torch.from_numpy(labels), spmm)
        np.testing.assert_allclose(loss.item(), float(r_loss), **FWD_TOL)
        loss.backward()
        ts, _ = t_opt.adamw_step(tcfg, ps, ts)
        for got, want in zip(model.to_numpy(), rp):
            for name in ("w", "b"):
                np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                           **FWD_TOL)


def test_gcn_training_reduces_loss_and_repeats(power_law_matrix):
    """``tests/test_gnn_hlo.py``'s loss check through the port's handle,
    and a second run from the same start gives the same bits."""
    adj, feats, labels, params = _problem(power_law_matrix, seed=3)
    h = T.compile_spmm(_port_csr(adj), P, device="cpu")
    spmm = make_spmm_fn(h)
    x, y = torch.from_numpy(feats), torch.from_numpy(labels)
    cfg = t_opt.AdamWConfig(lr=5e-3, weight_decay=0.0, warmup_steps=0,
                            schedule="constant")

    def run(steps):
        model = t_gnn.gcn_from_numpy(params, device="cpu")
        ps = list(model.parameters())
        state, losses = t_opt.adamw_init(ps), []
        for _ in range(steps):
            loss = t_gnn.gcn_loss(model, x, y, spmm)
            loss.backward()
            state, _ = t_opt.adamw_step(cfg, ps, state)
            losses.append(loss.item())
        return ps, losses

    ps, losses = run(5)
    assert losses[-1] < losses[0]
    again, _ = run(5)
    assert all(torch.equal(a, b) for a, b in zip(ps, again))


def test_gcn_from_numpy_round_trip_and_layout():
    params = t_gnn.gcn_params(DIMS, seed=4)
    assert [tuple(lp["w"].shape) for lp in params] == [(12, 16), (16, 16),
                                                        (16, 5)]
    assert all(not lp["b"].any() for lp in params)
    model = t_gnn.gcn_from_numpy(params, device="cpu")
    assert len(model.layers) == 3
    for got, want in zip(model.to_numpy(), params):
        for name in ("w", "b"):
            np.testing.assert_array_equal(got[name], want[name])
    fresh = t_gnn.GCN(64, 12, 16, 5, n_layers=3, device="cpu")
    fresh.load_numpy(params)
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        t_gnn.GCN(64, 12, 8, 5, n_layers=3, device="cpu").load_numpy(params)
    with pytest.raises(ValueError, match="parameter dicts"):
        fresh.load_numpy(params[:2])
    with pytest.raises(ValueError, match="at least one layer"):
        t_gnn.gcn_from_numpy([], device="cpu")
    feats = torch.randn(64, 12)
    assert torch.equal(model(feats, lambda v: v),
                       t_gnn.gcn_forward(model, feats, lambda v: v))


def test_gcn_entry_points_default_to_the_card():
    import inspect

    for fn in (t_gnn.gcn_from_numpy, t_gnn.GCN):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_gnn_training_example_runs_on_cpu(capsys):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "torch_gnn_training.py"
    spec = importlib.util.spec_from_file_location("torch_gnn_training", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--epochs", "4", "--nodes", "128",
              "--edges", "1024"])
    out = capsys.readouterr().out
    assert "device cpu" in out and "prep ratio (Tab. 3 protocol)" in out
    assert "final loss" in out
