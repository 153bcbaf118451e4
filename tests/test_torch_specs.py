"""``repro_torch.launch.specs`` and the training launcher's per-family
batches against the reference (CPU).

* For all 10 archs × 4 shapes: ``input_specs``, ``abstract_params``,
  ``abstract_opt_state`` and ``abstract_cache`` equal the reference's
  ``jax.eval_shape`` shapes and dtypes leaf for leaf, built on the
  ``meta`` device (nothing allocated); ``cell_status`` equals the
  reference's (``tests/test_gnn_hlo.py``'s pins among them).
* ``launch/train.py --arch seamless-m4t-medium`` and ``--arch
  llava-next-mistral-7b`` on the CPU: each batch carries the reference
  launcher's embeddings (``default_rng(step)``), and a 4-step run resumed
  from its step-2 checkpoint ends ``torch.equal`` to the uninterrupted one.
"""
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim.adamw import _leaves  # noqa: E402

CACHE_FIELDS = ("k", "v", "ssm_h", "ssm_conv", "shared_k", "shared_v",
                "cross_k", "cross_v")


def _same(got: torch.Tensor, want, what: str) -> None:
    assert got.is_meta, f"{what}: allocated on {got.device}"
    assert tuple(got.shape) == tuple(want.shape), what
    assert str(got.dtype).split(".")[1] == str(want.dtype), what


def _same_trees(got, want, what: str) -> None:
    w = jax.tree_util.tree_leaves(want)
    g = _leaves(got)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        _same(a, b, f"{what} leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(RS.SHAPES))
def test_specs_and_abstract_trees_equal_reference(arch, shape):
    rcfg, tcfg = ref_config(arch), get_config(arch)
    rs, ts = RS.SHAPES[shape], TS.SHAPES[shape]
    assert ts == TS.ShapeSpec(rs.name, rs.seq_len, rs.global_batch, rs.mode)
    assert TS.cell_status(tcfg, ts) == RS.cell_status(rcfg, rs)
    want, got = RS.input_specs(rcfg, rs), TS.input_specs(tcfg, ts)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k], f"{arch} {shape} input {k}")
    if rs.mode == "train":
        _same_trees(TS.abstract_opt_state(tcfg),
                    RS.abstract_opt_state(rcfg), f"{arch} opt state")
    elif rs.mode == "prefill":
        _same_trees(TS.abstract_params(tcfg), RS.abstract_params(rcfg),
                    f"{arch} params")
    else:  # dryrun's cache: seq + 16 positions
        b, s = rs.global_batch, rs.seq_len
        wc, gc = RS.abstract_cache(rcfg, b, s + 16), \
            TS.abstract_cache(tcfg, b, s + 16)
        for f in CACHE_FIELDS:
            w, g = getattr(wc, f), getattr(gc, f)
            assert (w is None) == (g is None), f"{arch} cache {f}"
            if w is not None:
                _same(g, w, f"{arch} {shape} cache {f}")


def test_cell_status_pins():
    """tests/test_gnn_hlo.py::test_cell_status_long_context_rules through
    the port's ``cell_status``."""
    S = TS.SHAPES
    assert TS.cell_status(get_config("falcon-mamba-7b"),
                          S["long_500k"]) == "run"
    assert TS.cell_status(get_config("zamba2-2.7b"), S["long_500k"]) == "run"
    assert "SKIP" in TS.cell_status(get_config("deepseek-67b"),
                                    S["long_500k"])
    assert "SKIP" in TS.cell_status(get_config("llava-next-mistral-7b"),
                                    S["long_500k"])
    assert TS.cell_status(get_config("seamless-m4t-medium"),
                          S["decode_32k"]) == "run"


@pytest.mark.parametrize("arch,key", [("seamless-m4t-medium", "enc_embeds"),
                                      ("llava-next-mistral-7b",
                                       "prefix_embeds")])
def test_launcher_family_batches_and_resume(arch, key, tmp_path, caplog):
    cfg = get_smoke_config(arch)
    src = launch_train.FamilyInputs(SyntheticLM(cfg.vocab_size, 16, 4), cfg,
                                    4)
    for step in (0, 3):
        b = src.batch(step)
        want = np.random.default_rng(step).standard_normal(
            (4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        np.testing.assert_array_equal(b[key], want)
        np.testing.assert_array_equal(
            b["tokens"], SyntheticLM(cfg.vocab_size, 16, 4).batch(step)
            ["tokens"])
        assert set(b) == {"tokens", key}
        half = src.batch(step, shard=1, n_shards=2)
        np.testing.assert_array_equal(half[key], want[2:])
    run = ["--arch", arch, "--device", "cpu", "--batch", "4", "--seq", "16",
           "--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
           str(tmp_path / "run")]
    whole = launch_train.main(run)
    ckpt = CheckpointManager(str(tmp_path / "run"))
    assert ckpt.all_steps() == [2, 4]
    shutil.rmtree(ckpt._step_dir(4))
    with caplog.at_level("INFO", logger="repro_torch.trainer"):
        resumed = launch_train.main(run)
    assert "resumed from step 2" in caplog.text
    assert resumed["last_step"] == whole["last_step"] == 4
    for a, b in zip(_leaves(resumed["params"]), _leaves(whole["params"])):
        assert torch.equal(a, b)
    # the adapter the embeddings pass through trained
    init = launch_train.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    assert not torch.equal(whole["params"]["adapter"], init["adapter"])
