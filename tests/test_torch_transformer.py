"""The port's transformer against ``repro.models`` (CPU, plain versions).

Weights come from the reference's ``init_params`` and are carried over by
``transformer_from_numpy``; inputs come from numpy seeds. The layers
(``rope``, ``attention`` at s = 16 and at s = 1024, where it takes the
flash path, ``attention_decode``, ``mlp``) and the whole model
(``forward`` and ``decode_step`` token by token) agree with the JAX
package in float32 within 1e-4 on every smoke config of the dense and
moe families. A bfloat16 olmoe-smoke agrees within 2e-2 (rtol and atol:
~5 bf16 ulps at |logits| ~0.5; the two frameworks round the bf16
products and sums at different places).
"""
import dataclasses
import inspect
import subprocess
import sys
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM_ARCHS = ["smollm-135m", "qwen2-1.5b", "granite-20b", "deepseek-67b",
            "olmoe-1b-7b", "dbrx-132b"]  # the dense and moe families
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _attn_params(rng, d, h, kvh, hd, bias):
    shapes = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd),
              "wo": (h * hd, d)}
    if bias:
        shapes.update(bq=(h * hd,), bk=(kvh * hd,), bv=(kvh * hd,))
    return {k: (rng.standard_normal(s) * d ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.fixture(scope="module")
def models():
    """Reference params, jitted reference functions and the port's params,
    per smoke config (built once)."""
    out = {}
    for arch in LM_ARCHS:
        cfg = jax_smoke(arch)
        params = RT.init_params(jax.random.PRNGKey(0), cfg)
        fwd = jax.jit(lambda p, t, cfg=cfg: RT.forward(p, cfg, None,
                                                       {"tokens": t}))
        dec = jax.jit(lambda p, t, c, cfg=cfg: RT.decode_step(p, cfg, None,
                                                              t, c))
        tcfg = get_smoke_config(arch)
        out[arch] = (cfg, params, fwd, dec, tcfg,
                     TT.transformer_from_numpy(_np_tree(params), tcfg,
                                               device="cpu"))
    return out


def test_configs_equal_reference():
    from repro.configs import ARCHS as R_ARCHS, get_config as r_get

    assert ARCHS == R_ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(r_get(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch))
        assert get_config(arch).params_count() == r_get(arch).params_count()


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(3, 10)[None, :]
    want = np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("s,h,kvh,bias", [(16, 4, 4, False), (16, 4, 2, True),
                                          (1024, 4, 2, False)],
                         ids=["s16", "s16-gqa-bias", "s1024-flash"])
def test_attention_matches_reference(s, h, kvh, bias):
    rng = np.random.default_rng(s + h + kvh)
    d, hd = 32, 8
    jp, tp = _both(_attn_params(rng, d, h, kvh, hd, bias))
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    want = np.asarray(RL.attention(jp, jnp.asarray(x), h, kvh))
    got = TL.attention(tp, torch.from_numpy(x), h, kvh)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    if s >= 1024:  # the flash path equals the plain softmax path too
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, s, hd)).astype(
            np.float32)) for _ in range(3))
        plain = torch.softmax(
            (q @ k.transpose(-1, -2) / hd ** 0.5).masked_fill(
                ~torch.ones(s, s, dtype=torch.bool).tril(), -torch.inf),
            -1) @ v
        torch.testing.assert_close(TL.flash_attention(q, k, v), plain, **F32)


def test_cross_attention_matches_reference():
    rng = np.random.default_rng(5)
    jp, tp = _both(_attn_params(rng, 32, 4, 2, 8, False))
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    enc = rng.standard_normal((2, 9, 32)).astype(np.float32)
    want = np.asarray(RL.attention(jp, jnp.asarray(x), 4, 2, causal=False,
                                   kv_input=jnp.asarray(enc)))
    got = TL.attention(tp, torch.from_numpy(x), 4, 2, causal=False,
                       kv_input=torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_attention_decode_matches_reference():
    rng = np.random.default_rng(3)
    d, h, kvh, hd, smax, b = 32, 4, 2, 8, 12, 2
    jp, tp = _both(_attn_params(rng, d, h, kvh, hd, True))
    k0 = rng.standard_normal((b, kvh, smax, hd)).astype(np.float32)
    v0 = rng.standard_normal((b, kvh, smax, hd)).astype(np.float32)
    jc = RL.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(5, jnp.int32))
    tc = TL.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()), 5)
    for _ in range(3):
        x = rng.standard_normal((b, 1, d)).astype(np.float32)
        want, jc = RL.attention_decode(jp, jnp.asarray(x), jc, h, kvh)
        got, tc = TL.attention_decode(tp, torch.from_numpy(x), tc, h, kvh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **F32)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **F32)
        assert tc.length == int(jc.length)
    # without seq_shard a dist plays no part, as in the reference
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    want, jc = RL.attention_decode(jp, jnp.asarray(x), jc, h, kvh,
                                   dist=object())
    got, tc = TL.attention_decode(tp, torch.from_numpy(x), tc, h, kvh,
                                  dist=object())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **F32)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(4)
    p = {"w1": rng.standard_normal((16, 40)), "w2": rng.standard_normal((40, 16)),
         "w3": rng.standard_normal((16, 40))}
    p = {k: (v * 0.25).astype(np.float32) for k, v in p.items()}
    jp, tp = _both(p)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want = np.asarray(RL.mlp(jp, jnp.asarray(x), kind))
    got = TL.mlp(tp, torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_decode_match_reference(arch, models):
    cfg, params, fwd, dec, tcfg, tp = models[arch]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(
        np.int32)
    want = np.asarray(fwd(params, jnp.asarray(toks)))
    before = ops.launch_counts()
    got = TT.forward(tp, tcfg, None, {"tokens": torch.from_numpy(toks)})
    assert ops.launch_counts() == before  # CPU: the plain versions
    assert got.shape == (2, 9, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    jc = RT.init_decode_cache(cfg, 2, 12)
    tc = TT.init_decode_cache(tcfg, 2, 12, device="cpu")
    for j in range(toks.shape[1]):
        lj, jc = dec(params, jnp.asarray(toks[:, j:j + 1]), jc)
        lt, tc = TT.decode_step(tp, tcfg, None,
                                torch.from_numpy(toks[:, j:j + 1]), tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
        np.testing.assert_allclose(lt.numpy()[:, 0], want[:, j], **F32)
    assert tc.length == toks.shape[1] == int(jc.length)


def test_bf16_olmoe_smoke_matches_reference():
    cfg = dataclasses.replace(jax_smoke("olmoe-1b-7b"), dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                               dtype="bfloat16")
    params = RT.init_params(jax.random.PRNGKey(1), cfg)
    tp = TT.transformer_from_numpy(_np_tree(params), tcfg, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6)).astype(
        np.int32)
    want = np.asarray(RT.forward(params, cfg, None,
                                 {"tokens": jnp.asarray(toks)}), np.float32)
    got = TT.forward(tp, tcfg, None, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
    jc = RT.init_decode_cache(cfg, 2, 8)
    tc = TT.init_decode_cache(tcfg, 2, 8, device="cpu")
    dec = jax.jit(lambda p, t, c: RT.decode_step(p, cfg, None, t, c))
    for j in range(toks.shape[1]):
        lj, jc = dec(params, jnp.asarray(toks[:, j:j + 1]), jc)
        lt, tc = TT.decode_step(tp, tcfg, None,
                                torch.from_numpy(toks[:, j:j + 1]), tc)
        np.testing.assert_allclose(lt.float().numpy(),
                                   np.asarray(lj, np.float32), **BF16)


def test_transformer_from_numpy_carries_bf16_bits():
    cfg = dataclasses.replace(jax_smoke("smollm-135m"), dtype="bfloat16")
    params = _np_tree(RT.init_params(jax.random.PRNGKey(2), cfg))
    tp = TT.transformer_from_numpy(params, get_smoke_config("smollm-135m"),
                                   device="cpu")
    want = params["layers"]["attn"]["wq"]
    got = tp["layers"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          want.view(np.uint16))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-1.5b"])
def test_init_params_has_reference_shapes_and_dtypes(arch):
    """The port's own init: the reference tree's names, shapes, dtypes and
    (within 25%) scales; the same generator seed gives the same weights."""
    want = _np_tree(RT.init_params(jax.random.PRNGKey(0), jax_smoke(arch)))
    got = TT.init_params(get_smoke_config(arch),
                         torch.Generator().manual_seed(0), device="cpu")

    def walk(w, t):
        assert isinstance(t, dict) == isinstance(w, dict)
        if isinstance(w, dict):
            assert sorted(t) == sorted(w)
            for k in w:
                walk(w[k], t[k])
            return
        assert tuple(t.shape) == w.shape
        assert str(t.dtype).split(".")[-1] == w.dtype.name
        if w.size > 1:
            assert abs(float(t.float().std()) - float(w.std())) <= \
                0.25 * float(w.std())

    walk(want, got)
    again = TT.init_params(get_smoke_config(arch),
                           torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["attn"]["wq"],
                       got["layers"]["attn"]["wq"])


def test_unported_families_and_dist_raise():
    """The hybrid, encdec, vlm and audio families are no longer refused on
    a fleet's grid (they run there: tests/test_torch_families_fleet.py);
    a ``dist`` that is not a DistContext still raises. On one device and
    on the emulated grid every family runs."""
    from types import SimpleNamespace

    from repro_torch.distributed.context import DistContext

    fleet = DistContext(mesh=SimpleNamespace(is_fleet=True),
                        batch_axes=("data",))
    assert not hasattr(TT, "NOT_ON_A_FLEET")
    llava = get_smoke_config("llava-next-mistral-7b")
    audio = dataclasses.replace(llava, family="audio", frontend="audio")
    for cfg in [get_smoke_config(a) for a in ("zamba2-2.7b",
                                              "seamless-m4t-medium")] + \
            [llava, audio]:
        cache = TT.init_decode_cache(cfg, 1, 4, device="cpu")
        assert cache.k is not None or cache.ssm_h is not None
        TT._check(cfg, fleet)  # the fleet's refusal is gone
    cfg = get_smoke_config("smollm-135m")
    # a DistContext runs (tests/test_torch_dist_context.py); anything
    # else is refused
    with pytest.raises(TypeError, match="DistContext"):
        TT.forward({}, cfg, object(), {"tokens": torch.zeros(1, 1)})


def test_entry_points_default_to_the_card():
    for fn in (TT.init_params, TT.init_decode_cache, TT.transformer_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_lm_modules_import_no_jax():
    code = ("import sys, repro_torch.models.transformer, repro_torch.models.moe,"
            " repro_torch.serving.scheduler, repro_torch.configs;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'shiro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
