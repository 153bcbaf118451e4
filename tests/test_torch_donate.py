"""The donating train step (CPU): the port's counterpart of the
reference's ``jax.jit(step, donate_argnums=(0, 1))``.

* ``adamw_update(..., donate=True)`` writes the new parameters, m, v and
  step counter into the tensors it is given, ``torch.equal`` on every
  leaf to the functional form and to the float32 chain the functional
  form ran before the donating form existed (kept here verbatim), for the
  cosine, linear and constant schedules, with and without clipping, for
  float32 and bfloat16 parameters; and within 1e-6 of the reference's
  ``adamw_update``;
* ``make_train_step(..., donate=True)`` returns the tensors it was given
  (same ``data_ptr``), with the functional step's bits: dense, EP at
  capacity 8.0 on the emulated (2, 4) grid, ``microbatches=2``, dense on
  the grid and ``remat``;
* ``Trainer.fit`` consumes the caller's tree, a resumed run restoring
  into it;
* the dry run's train cell traces the donating step: at a batch small
  enough that the update sets the peak, the traced peak falls by the
  parameters' and moments' bytes from the functional step's.
"""
import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import adamw as R  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed.context import make_context  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import (  # noqa: E402
    ShapeSpec, abstract_opt_state, abstract_params, input_specs,
)
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as T  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
GRID = ("data", "model")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _functional_chain(cfg, params, grads, state):
    """The functional update as the port ran it before its donating form:
    the whole tree clipped first, then each leaf's float32 chain."""
    if cfg.grad_clip > 0:
        grads, gnorm = T.clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = T.global_norm(grads)
    step = state["step"] + 1
    if cfg.schedule == "cosine":
        lr = T.cosine_schedule(cfg, step)
    elif cfg.schedule == "linear":
        lr = T.linear_warmup(cfg, step)
    else:
        lr = torch.tensor(cfg.lr, dtype=torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32),
                          step.float())
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32),
                          step.float())

    def upd(p, g, m, v):
        gf = g.float()
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.float())
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    outs = [upd(*a) for a in zip(T._leaves(params), T._leaves(grads),
                                 T._leaves(state["m"]),
                                 T._leaves(state["v"]))]

    def pick(i):
        return T._rebuild(params, iter([o[i] for o in outs]))

    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, {
        "grad_norm": gnorm, "lr": lr}


def _tree(rng, dtype):
    return {"w": torch.from_numpy(rng.standard_normal((24, 16)).astype(
                np.float32)).to(dtype),
            "layers": [torch.from_numpy(rng.standard_normal(37).astype(
                np.float32)).to(dtype),
                torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(
                    np.float32)).to(dtype)]}


def _clone(tree):
    return T._map(torch.clone, tree)


def _ptrs(*trees):
    return [t.data_ptr() for tree in trees for t in T._leaves(tree)]


def _equal(a, b):
    la, lb = T._leaves(a), T._leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, 0.0, 0.05],
                         ids=["clip1", "noclip", "clip0.05"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_donating_update_equals_functional(schedule, clip, dtype):
    rng = np.random.default_rng(0)
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=6, schedule=schedule,
              grad_clip=clip, weight_decay=0.1)
    cfg = T.AdamWConfig(**kw)
    params = _tree(rng, dtype)
    fp, fs = params, T.adamw_init(params)
    cp, cs = _clone(fp), _clone(fs)
    dp, ds = _clone(fp), _clone(fs)
    held = _ptrs(dp, ds["m"], ds["v"]) + [ds["step"].data_ptr()]
    rp, rs = jax.tree_util.tree_map(lambda t: jnp.asarray(t.float().numpy()),
                                    fp), R.adamw_init(
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.float().numpy()), fp))
    for _ in range(3):
        grads = T._map(lambda p: torch.from_numpy(
            3 * rng.standard_normal(p.shape).astype(np.float32)).to(dtype),
            fp)
        fp, fs, fm = T.adamw_update(cfg, fp, grads, fs)
        cp, cs, cm = _functional_chain(cfg, cp, grads, cs)
        out = T.adamw_update(cfg, dp, grads, ds, donate=True)
        assert out[0] is dp and out[1] is ds
        assert _ptrs(dp, ds["m"], ds["v"]) + [ds["step"].data_ptr()] == held
        assert _equal([fp, fs], [dp, ds]) and _equal([fp, fs], [cp, cs])
        for k in ("grad_norm", "lr"):
            assert torch.equal(out[2][k], fm[k]) and torch.equal(fm[k], cm[k])
        if dtype == torch.float32:
            rp, rs, _ = R.adamw_update(R.AdamWConfig(**kw), rp,
                                       jax.tree_util.tree_map(
                                           lambda t: jnp.asarray(t.numpy()),
                                           grads), rs)
            for g, w in zip(T._leaves([dp, ds["m"], ds["v"]]),
                            jax.tree_util.tree_leaves([rp, rs["m"],
                                                       rs["v"]])):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert int(ds["step"]) == 3


def _step_case(name):
    """(cfg, dist, microbatches) of a donation case."""
    dense = dataclasses.replace(get_smoke_config("qwen2-1.5b"), d_model=64,
                                n_heads=4, n_kv_heads=2)
    moe = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              capacity_factor=8.0)
    grid = make_context(make_mesh((2, 4), GRID))
    return {"dense": (dense, None, 1),
            "ep_capacity8": (moe, grid, 1),
            "microbatches2": (dense, None, 2),
            "dense_grid24": (dense, grid, 1),
            "remat_ep": (dataclasses.replace(moe, remat=True), grid, 1)}[name]


@pytest.mark.parametrize("case", ["dense", "ep_capacity8", "microbatches2",
                                  "dense_grid24", "remat_ep"])
def test_donating_step_returns_its_tensors(case):
    cfg, dist, mb = _step_case(case)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    src = SyntheticLM(cfg.vocab_size, 16, 8, seed=1)
    opt = T.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    fstep = make_train_step(cfg, dist, opt, mb)
    dstep = make_train_step(cfg, dist, opt, mb, donate=True)
    fp, fs = params, T.adamw_init(params)
    dp, ds = _clone(fp), _clone(fs)
    held = _ptrs(dp, ds)
    for i in range(2):
        batch = src.batch(i)
        fp, fs, fm = fstep(fp, fs, batch)
        p, s, m = dstep(dp, ds, batch)
        assert p is dp and s is ds and _ptrs(dp, ds) == held
        assert _equal([fp, fs], [dp, ds]), f"{case} step {i + 1}"
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(fm[k], m[k]), k


def test_fit_consumes_the_callers_tree(tmp_path):
    """``fit``'s result holds the caller's tensors, updated in place to
    the functional step's bits; a resumed ``fit`` restores into the
    tree it is given."""
    cfg = get_smoke_config("smollm-135m")
    opt = T.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    src = SyntheticLM(cfg.vocab_size, 16, 2, seed=0)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want, state = _clone(params), T.adamw_init(params)
    step = make_train_step(cfg, None, opt)
    for i in range(4):
        want, state, _ = step(want, state, src.batch(i))
    leaves = T._leaves(params)
    tcfg = TrainerConfig(total_steps=4, ckpt_every=2, log_every=1,
                         ckpt_dir=str(tmp_path))
    out = Trainer(cfg, opt, tcfg).fit(params, src, resume=False)
    assert out["params"] is params
    assert all(a is b for a, b in zip(T._leaves(out["params"]), leaves))
    assert _equal(params, want) and _equal(out["opt_state"], state)
    # resumed from step 2: the fresh tree given takes the checkpoint's
    # values and ends at the same bits
    (tmp_path / "step_00000004" / "metadata.json").unlink()
    fresh = TT.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    again = Trainer(cfg, opt, tcfg).fit(fresh, src, resume=True)
    assert again["params"] is fresh and again["history"][0]["step"] == 2
    assert _equal(fresh, want)


def _bytes(tree):
    return sum(t.numel() * t.element_size() for t in TD._tensors(tree))


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b",
                                  "olmoe-1b-7b"])
def test_dryrun_traces_the_donating_step(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    shape = ShapeSpec("train_tiny", 8, 1, "train")
    seen = []
    plain = TD.make_train_step

    def recorded(*a, **kw):
        seen.append(kw.get("donate", False))
        return plain(*a, **kw)

    monkeypatch.setattr(TD, "make_train_step", recorded)
    rec = TD.account(cfg, shape, make_mesh((1, 1), GRID), probes=False)
    assert seen == [True]
    po = _bytes(abstract_params(cfg)) + _bytes(abstract_opt_state(cfg))
    assert rec["memory"]["alias_size_in_bytes"] == po
    dist = make_context(TD._trace_mesh(make_mesh((1, 1), GRID)))
    peaks = {}
    for donate in (False, True):
        res = TD.trace_step(plain(cfg, dist, T.AdamWConfig(), donate=donate),
                            abstract_params(cfg), abstract_opt_state(cfg),
                            input_specs(cfg, shape))
        peaks[donate] = res["peak"]
        if donate:
            assert res["temp"] == rec["memory"]["temp_size_in_bytes"]
    # the functional step holds its new params and moments at its top
    assert math.isclose(peaks[False] - peaks[True], po, rel_tol=0.05)
