"""The hybrid, encdec, vlm and audio families against ``repro.models.
transformer`` (CPU, plain versions).

Four smoke configs: zamba2 (hybrid: 2 groups of 2 Mamba2 blocks, each
followed by the one shared attention block), seamless (encdec: 2
encoder + 2 decoder layers, 16 frames), llava (vlm: 8 patches before the
tokens) and an ``audio`` config (llava's smoke with family "audio" and
frontend "audio" in both packages). Weights come from the reference's
``init_params`` through ``transformer_from_numpy``; inputs from numpy
seeds. Each holds:

* forward logits within 2e-4;
* ``lm_loss`` and its grads within rtol 2e-3 / atol 2e-4 of
  ``jax.value_and_grad``, every leaf (``shared_attn``, ``encoder`` and
  ``adapter`` included);
* one ``make_train_step`` against the reference's (and ``microbatches=2``
  on the vlm);
* three ``decode_step``s against the reference's (the encdec with the
  same ``enc_out``);
* decode == forward within 2e-3 (the hybrid; the encdec with ``enc_out``
  from ``_encode``);
* the batcher's tokens equal to the reference batcher's over three waves
  (the encdec's without cross-attention: the reference's batcher passes
  no ``enc_out``);
* forward on an emulated (data 2, model 2) grid equal to ``dist=None``;
* the families on a one-process fleet's grid equal the emulated grid
  (two processes: ``tests/test_torch_families_fleet.py``).

And the reference's pins for these archs (``tests/test_models.py``'s
smoke forward / train step / decode).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim.adamw import AdamWConfig as RAdamW  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.serving import scheduler as RSC  # noqa: E402
from repro.train.steps import make_train_step as ref_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.context import make_context  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init  # noqa: E402,E501
from repro_torch.serving import scheduler as TSC  # noqa: E402
from repro_torch.train.steps import loss_and_grads, make_train_step  # noqa: E402,E501

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["zamba2-2.7b", "seamless-m4t-medium", "llava-next-mistral-7b",
         "audio"]
LOGITS = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=2e-3, atol=2e-4)
DECODE = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cfgs(arch):
    """(reference cfg, port cfg); "audio" is llava's smoke config with
    the audio family and frontend."""
    if arch == "audio":
        change = dict(family="audio", frontend="audio", name="audio-smoke")
        return (dataclasses.replace(ref_smoke("llava-next-mistral-7b"),
                                    **change),
                dataclasses.replace(get_smoke_config("llava-next-mistral-7b"),
                                    **change))
    return ref_smoke(arch), get_smoke_config(arch)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_MODELS = {}


def _model(arch):
    """(rcfg, reference params, tcfg, port params), built once a file."""
    if arch not in _MODELS:
        rcfg, tcfg = _cfgs(arch)
        params = RT.init_params(jax.random.PRNGKey(0), rcfg)
        _MODELS[arch] = (rcfg, params, tcfg, TT.transformer_from_numpy(
            _np(params), tcfg, device="cpu"))
    return _MODELS[arch]


def _batch(cfg, b=B, s=S, seed=1):
    """numpy tokens [b, s] and the family's frame / patch embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    emb = rng.standard_normal((b, cfg.frontend_len, cfg.d_model)
                              ).astype(np.float32)
    if cfg.family == "encdec":
        out["enc_embeds"] = emb
    elif cfg.frontend is not None:
        out["prefix_embeds"] = emb
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_leaves(port_tree, ref_tree, what, **tol):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)  # sorted dict keys
    got = _leaves(port_tree)
    assert len(got) == len(ref_leaves), what
    for i, (g, r) in enumerate(zip(got, ref_leaves)):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(r, np.float32),
                                   err_msg=f"{what} leaf {i}", **tol)


def _prefix(cfg):
    return cfg.frontend_len if cfg.frontend and cfg.family != "encdec" else 0


# ---------------------------------------------------------------------------
# the trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    rcfg, tcfg = _cfgs(arch)
    want = RT.init_params(jax.random.PRNGKey(0), rcfg)
    got = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    paths = lambda t: sorted(  # noqa: E731
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(t)[0])
    assert paths(_np(want)) == paths({k: _np_shapes(v) for k, v in
                                      got.items()})
    for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[1] == str(w.dtype)
    if tcfg.frontend is not None:  # the adapter's scale d ** -0.5
        std = float(got["adapter"].std())
        assert abs(std - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5


def _np_shapes(tree):
    if isinstance(tree, dict):
        return {k: _np_shapes(v) for k, v in tree.items()}
    return np.zeros(tuple(tree.shape), np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_has_the_reference_fields(arch):
    rcfg, tcfg = _cfgs(arch)
    want = RT.init_decode_cache(rcfg, 3, 10)
    got = TT.init_decode_cache(tcfg, 3, 10, device="cpu")
    for f in ("k", "v", "ssm_h", "ssm_conv", "shared_k", "shared_v",
              "cross_k", "cross_v"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert tuple(g.shape) == w.shape, f
            assert str(g.dtype).split(".")[1] == str(w.dtype), f
            assert not bool(g.any()), f
    assert got.cross_k is None and got.length == 0


# ---------------------------------------------------------------------------
# forward, loss, grads, train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    rcfg, params, tcfg, tp = _model(arch)
    batch = _batch(rcfg)
    want = RT.forward(params, rcfg, None, _j(batch))
    got = TT.forward(tp, tcfg, None, _t(batch))
    assert got.shape == (B, _prefix(tcfg) + S, tcfg.vocab_size) == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax_value_and_grad(arch):
    rcfg, params, tcfg, tp = _model(arch)
    batch = _batch(rcfg)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rcfg, None, b)))(params, _j(batch))
    loss, grads = loss_and_grads(tp, tcfg, None, _t(batch))
    np.testing.assert_allclose(float(loss), float(want), **GRAD)
    _close_leaves(grads, wgrads, f"{arch} grads", **GRAD)
    for key in ("shared_attn", "encoder", "adapter"):
        if key in grads:  # the new leaves take part in the gradient
            assert all(bool(g.abs().sum() > 0) for g in _leaves(grads[key]))


@pytest.mark.parametrize("arch,microbatches", [
    (a, 1) for a in ARCHS] + [("llava-next-mistral-7b", 2)])
def test_train_step_matches_reference(arch, microbatches):
    rcfg, params, tcfg, tp = _model(arch)
    batch = _batch(rcfg, b=4)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    step = jax.jit(ref_train_step(rcfg, None, RAdamW(**opt),
                                  microbatches=microbatches))
    new_p, new_s, m = step(params, ref_adamw_init(params), _j(batch))
    tstep = make_train_step(tcfg, None, AdamWConfig(**opt),
                            microbatches=microbatches)
    pt, st, mt = tstep(tp, adamw_init(tp), batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mt[k]), float(m[k]), rtol=1e-4,
                                   err_msg=k)
    # as tests/test_torch_lm_train.py: the grads' tolerance where the
    # reference's first moment is clear of it, else within 2·lr
    lr = float(m["lr"])
    for i, (got, want, mom) in enumerate(zip(
            _leaves(pt), jax.tree_util.tree_leaves(new_p),
            jax.tree_util.tree_leaves(new_s["m"]))):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        firm = np.abs(np.asarray(mom)) > 10 * GRAD["atol"] * (1 - 0.9)
        np.testing.assert_allclose(got[firm], want[firm],
                                   err_msg=f"{arch} params leaf {i}", **GRAD)
        assert np.all(np.abs(got - want)[~firm] <= 2 * lr + 1e-6)
    _close_leaves(st["m"], new_s["m"], f"{arch} m", rtol=2e-3, atol=1e-6)
    assert int(st["step"]) == 1


def test_vlm_microbatches_match_one_batch():
    """``microbatches=2`` slices every key (tokens and prefix_embeds): the
    loss and the update equal one batch's within float32 rounding."""
    _, _, tcfg, tp = _model("llava-next-mistral-7b")
    batch = _batch(tcfg, b=4)
    opt = AdamWConfig(lr=1e-3)
    p1, _, m1 = make_train_step(tcfg, None, opt)(tp, adamw_init(tp), batch)
    p2, _, m2 = make_train_step(tcfg, None, opt, microbatches=2)(
        tp, adamw_init(tp), batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-4)
    # each half alone is another loss: the slices differ
    half = {k: v[:2] for k, v in batch.items()}
    _, _, mh = make_train_step(tcfg, None, opt)(tp, adamw_init(tp), half)
    assert float(mh["loss"]) != float(m1["loss"])


def test_hybrid_shared_block_grad_sums_its_uses():
    """zamba2's shared block is one set of weights applied once a group:
    its gradient is the sum of the groups' (two groups here), and remat
    (each SSM block under ``torch.utils.checkpoint``, the shared block
    outside) gives the same gradients."""
    _, _, tcfg, tp = _model("zamba2-2.7b")
    batch = _t(_batch(tcfg))
    _, grads = loss_and_grads(tp, tcfg, None, batch)
    _, rgrads = loss_and_grads(tp, dataclasses.replace(tcfg, remat=True),
                               None, batch)
    for g, r in zip(_leaves(grads), _leaves(rgrads)):
        torch.testing.assert_close(r, g, rtol=1e-6, atol=1e-7)
    # one group alone (attn_every = n_layers) uses the block once: its
    # gradient differs from the two-use one
    one = dataclasses.replace(tcfg, n_layers=tcfg.attn_every)
    p1 = {**tp, "layers": TT._tree_map(lambda t: t[:one.n_layers],
                                       tp["layers"])}
    _, g1 = loss_and_grads(p1, one, None, batch)
    w = "wq"
    assert not torch.allclose(g1["shared_attn"]["attn"][w],
                              grads["shared_attn"]["attn"][w])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _enc_out(rcfg, params, tcfg, tp, batch):
    """The encoder's output of ``batch``: (the reference's, the port's)."""
    if rcfg.family != "encdec":
        return None, None
    want = RT._scan_layers(
        params["encoder"]["layers"],
        jnp.asarray(batch["enc_embeds"]) @ params["adapter"], rcfg, None,
        "enc")
    want = RT.rms_norm(want, params["encoder"]["norm"], rcfg.norm_eps)
    got = TT._encode(tp, tcfg, None, torch.from_numpy(batch["enc_embeds"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    rcfg, params, tcfg, tp = _model(arch)
    batch = _batch(rcfg, s=3)
    w_enc, t_enc = _enc_out(rcfg, params, tcfg, tp, batch)
    rc = RT.init_decode_cache(rcfg, B, 8)
    tc = TT.init_decode_cache(tcfg, B, 8, device="cpu")
    stores = [getattr(tc, f) for f in ("k", "ssm_h", "shared_k")]
    toks = batch["tokens"]
    with torch.no_grad():
        for i in range(toks.shape[1]):
            want, rc = RT.decode_step(params, rcfg, None,
                                      jnp.asarray(toks[:, i:i + 1]), rc,
                                      w_enc)
            got, tc = TT.decode_step(tp, tcfg, None,
                                     torch.from_numpy(toks[:, i:i + 1]), tc,
                                     t_enc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **LOGITS)
    assert tc.length == int(rc.length) == toks.shape[1]
    # the cache's tensors were written in place, and hold the reference's
    for f, store in zip(("k", "ssm_h", "shared_k"), stores):
        if store is not None:
            assert getattr(tc, f) is store
            np.testing.assert_allclose(store.numpy(),
                                       np.asarray(getattr(rc, f)), **LOGITS)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "seamless-m4t-medium"])
def test_decode_equals_forward(arch):
    rcfg, params, tcfg, tp = _model(arch)
    batch = _batch(rcfg)
    full = TT.forward(tp, tcfg, None, _t(batch))
    _, enc = _enc_out(rcfg, params, tcfg, tp, batch)
    cache = TT.init_decode_cache(tcfg, B, S, device="cpu")
    outs = []
    with torch.no_grad():
        for i in range(S):
            lg, cache = TT.decode_step(
                tp, tcfg, None, torch.from_numpy(batch["tokens"][:, i:i + 1]),
                cache, enc_out=enc)
            outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **DECODE)


def test_encdec_decode_without_enc_out_skips_cross_attention():
    """``enc_out=None`` runs the decoder blocks without their cross
    attention (the reference's ``decode_step`` and batcher): equal to a
    copy of the model whose ``cross`` output projection is zero."""
    _, _, tcfg, tp = _model("seamless-m4t-medium")
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    zero = TT._tree_map(lambda t: t, tp)
    zero["layers"] = {**tp["layers"], "cross": {
        **tp["layers"]["cross"],
        "wo": torch.zeros_like(tp["layers"]["cross"]["wo"])}}
    enc = torch.randn(B, tcfg.frontend_len, tcfg.d_model,
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, _ = TT.decode_step(tp, tcfg, None, tok,
                              TT.init_decode_cache(tcfg, B, 4, "cpu"))
        b, _ = TT.decode_step(zero, tcfg, None, tok,
                              TT.init_decode_cache(tcfg, B, 4, "cpu"), enc)
        c, _ = TT.decode_step(tp, tcfg, None, tok,
                              TT.init_decode_cache(tcfg, B, 4, "cpu"), enc)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_tokens_equal_reference(arch):
    rcfg, params, tcfg, tp = _model(arch)
    lengths, new = [3, 6, 4, 5, 2, 7, 5], 4

    def requests(mod):
        rng = np.random.default_rng(1)
        return [mod.Request(rid=i, prompt=rng.integers(
            0, rcfg.vocab_size, n).astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lengths)]

    outs = []
    for mod, b in ((RSC, RSC.ContinuousBatcher(rcfg, params, 3, 16)),
                   (TSC, TSC.ContinuousBatcher(tcfg, tp, 3, 16))):
        reqs = requests(mod)
        for r in reqs:
            b.submit(r)
        stats = b.run()
        outs.append(([r.output for r in reqs], stats.served,
                     stats.generated_tokens))
    assert outs[1] == outs[0]
    assert outs[1][1] == len(lengths)  # three waves of at most 3 slots


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_the_emulated_grid_equals_unsharded(arch):
    _, _, tcfg, tp = _model(arch)
    batch = _t(_batch(tcfg))
    dist = make_context(make_mesh((2, 2), ("data", "model")))
    want = TT.forward(tp, tcfg, None, batch)
    got = TT.forward(tp, tcfg, dist, batch)
    assert torch.equal(got, want)
    # shard's checks see the encoder output / the concatenated prefix:
    # an odd batch is refused as the reference's constraint refuses it
    odd = _t(_batch(tcfg, b=3))
    with pytest.raises(ValueError, match="not divisible"):
        TT.forward(tp, tcfg, dist, odd)


@pytest.mark.parametrize("arch", ARCHS)
def test_new_leaves_are_whole_on_a_grid(arch):
    """``shared_attn``, ``encoder`` and ``adapter`` are whole leaves: no
    model-rank split, every data group's counting process a source."""
    _, _, tcfg, tp = _model(arch)
    dist = make_context(make_mesh((2, 2), ("data", "model")))
    assert dist.leaf_shards(tp, tcfg) == [None] * len(_leaves(tp))
    assert all(per == [[0]] for per in dist.grad_sources(tp, tcfg))


def test_new_families_on_a_fleet_raise_naming_item_15():
    """On a fleet's grid (a one-process gloo group here, holding every
    rank) each of the four families runs forward, lm_loss and decode_step
    — ROADMAP item 15's refusal is gone — and equals the emulated grid
    bit for bit; the dense family still runs there."""
    code = r"""
import socket, sys, dataclasses, torch, torch.distributed as dist
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=1, rank=0)
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.context import make_context
from repro_torch.launch.mesh import EmulatedMesh, make_mesh
from repro_torch.models import transformer as TT
d = make_context(EmulatedMesh((2, 2), ("data", "model"), span=(0, 4)))
e = make_context(make_mesh((2, 2), ("data", "model")))
assert d.is_fleet
llava = get_smoke_config("llava-next-mistral-7b")
cfgs = [get_smoke_config(a) for a in ("zamba2-2.7b", "seamless-m4t-medium")]
cfgs += [llava, dataclasses.replace(llava, family="audio", frontend="audio")]
tok = torch.zeros((2, 3), dtype=torch.int32)
n = 0
for cfg in cfgs:
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    emb = torch.randn((2, cfg.frontend_len, cfg.d_model),
                      generator=torch.Generator().manual_seed(1))
    b = {"tokens": tok}
    if cfg.family == "encdec":
        b["enc_embeds"] = emb
    elif cfg.frontend is not None:
        b["prefix_embeds"] = emb
    enc = TT._encode(p, cfg, e, emb) if cfg.family == "encdec" else None
    with torch.no_grad():
        for fn in (lambda x: TT.forward(p, cfg, x, b),
                   lambda x: TT.lm_loss(p, cfg, x, b),
                   lambda x: TT.decode_step(
                       p, cfg, x, tok[:, :1],
                       TT.init_decode_cache(cfg, 2, 4, "cpu"), enc)[0]):
            assert torch.equal(fn(d), fn(e)), cfg.name
            n += 1
dense = get_smoke_config("smollm-135m")
p = TT.init_params(dense, torch.Generator().manual_seed(0), "cpu")
assert TT.forward(p, dense, d, {"tokens": tok}).shape[-1] == dense.vocab_size
dist.destroy_process_group()
print(n)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "12"


def test_dist_must_be_a_context():
    _, _, tcfg, tp = _model("zamba2-2.7b")
    with pytest.raises(TypeError, match="DistContext"):
        TT.forward(tp, tcfg, object(), {"tokens": torch.zeros(1, 1)})


# ---------------------------------------------------------------------------
# the reference's own pins (tests/test_models.py) for these archs
# ---------------------------------------------------------------------------


def _pin_batch(cfg):
    """tests/test_models.py's batch (B 2, S 16), from numpy."""
    return _batch(cfg, b=2, s=16, seed=7)


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_reference_pin_smoke_forward(arch):
    _, _, tcfg, tp = _model(arch)
    logits = TT.forward(tp, tcfg, None, _t(_pin_batch(tcfg)))
    assert logits.shape == (2, 16 + _prefix(tcfg), tcfg.vocab_size)
    assert not torch.isnan(logits).any()


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_reference_pin_smoke_train_step(arch):
    _, _, tcfg, tp = _model(arch)
    step = make_train_step(tcfg, None, AdamWConfig(lr=1e-3))
    new_p, new_s, m = step(tp, adamw_init(tp), _pin_batch(tcfg))
    assert np.isfinite(float(m["loss"])) and \
        np.isfinite(float(m["grad_norm"]))
    assert int(new_s["step"]) == 1
    delta = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(_leaves(new_p), _leaves(tp)))
    assert delta > 0


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_reference_pin_smoke_decode(arch):
    _, _, tcfg, tp = _model(arch)
    cache = TT.init_decode_cache(tcfg, 2, 32, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    enc = (torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, tcfg.frontend_len, tcfg.d_model)).astype(np.float32))
        if tcfg.family == "encdec" else None)
    with torch.no_grad():
        lg1, cache = TT.decode_step(tp, tcfg, None, tok, cache, enc)
        lg2, cache = TT.decode_step(tp, tcfg, None, tok, cache, enc)
    assert lg1.shape == (2, 1, tcfg.vocab_size)
    assert not torch.isnan(lg2).any()
    assert cache.length == 2
