"""The port's Trainer, data pipeline and training launcher against
``repro`` (CPU).

* ``Trainer.fit`` on smollm-smoke with the reference's weights and
  batches: the same history (steps, losses within 1e-4) and last
  parameters as the reference's Trainer (within 1e-4 after eight AdamW
  steps of lr ≤ 1e-3; 1.1e-5 apart on this input), checkpoints at
  the same steps; resume continues the step counter; a SIGTERM mid-run
  saves and stops at the next step; the straggler watchdog's warmup rule
  and events;
* ``SyntheticLM`` / ``MemmapTokens`` / ``make_batches``: bit-identical
  batches for each (seed, step, shard);
* ``python -m repro_torch.launch.train --device cpu``: three smoke steps
  with the reference's printout, and a run cut at a checkpoint resumes
  to the bits of an uninterrupted one.
"""
import os
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.data import pipeline as RP  # noqa: E402
from repro.models.transformer import init_params as ref_init  # noqa: E402
from repro.optim.adamw import AdamWConfig as RAdamW  # noqa: E402
from repro.train.trainer import Trainer as RTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as RTrainerConfig  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, _leaves  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _batches(cfg, b=2, s=16, mod=TP):
    data = mod.SyntheticLM(cfg.vocab_size, s, b)
    return mod.make_batches(data)


def _port_trainer(tmp_path, steps=8, ckpt_every=4, **kw):
    cfg = get_smoke_config("smollm-135m")
    opt = AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=1)
    tcfg = TR.TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                            ckpt_dir=str(tmp_path), log_every=2,
                            straggler_warmup=2, **kw)
    return cfg, TR.Trainer(cfg, opt, tcfg)


def test_trainer_matches_reference(tmp_path):
    rcfg = ref_smoke("smollm-135m")
    params = ref_init(jax.random.PRNGKey(0), rcfg)
    host = jax.tree_util.tree_map(np.asarray, params)  # fit donates params
    ropt = RAdamW(lr=1e-3, total_steps=8, warmup_steps=1)
    rtr = RTrainer(rcfg, ropt, RTrainerConfig(
        total_steps=8, ckpt_every=4, ckpt_dir=str(tmp_path / "ref"),
        log_every=2, straggler_warmup=2))
    rout = rtr.fit(params, _batches(rcfg, mod=RP), resume=False)
    cfg, tr = _port_trainer(tmp_path / "port")
    tparams = TT.transformer_from_numpy(host, cfg, device="cpu")
    out = tr.fit(tparams, _batches(cfg), resume=False)
    assert out["last_step"] == rout["last_step"] == 8
    assert [h["step"] for h in out["history"]] == \
        [h["step"] for h in rout["history"]] == [0, 2, 4, 6]
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in rout["history"]],
                               rtol=1e-4)
    for a, b in zip(_leaves(out["params"]),
                    jax.tree_util.tree_leaves(rout["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    assert tr.ckpt.all_steps() == rtr.ckpt.all_steps() == [4, 8]
    assert int(out["opt_state"]["step"]) == 8


def test_trainer_resume_continues_the_step_counter(tmp_path):
    cfg, tr = _port_trainer(tmp_path, steps=4, ckpt_every=2)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tr.fit(params, _batches(cfg), resume=False)
    assert tr.ckpt.latest_step() == 4
    cfg2, tr2 = _port_trainer(tmp_path, steps=8, ckpt_every=4)
    out = tr2.fit(TT.init_params(cfg2, torch.Generator().manual_seed(9),
                                 "cpu"), _batches(cfg2), resume=True)
    assert out["last_step"] == 8
    assert int(out["opt_state"]["step"]) >= 8
    assert out["history"][0]["step"] == 4  # no step before the checkpoint


def test_preemption_signal_saves_and_stops(tmp_path):
    """SIGTERM during step 2 (from inside the batch stream): the trainer
    saves at step 3 and stops there; the handlers are restored after."""
    cfg, tr = _port_trainer(tmp_path, steps=8, ckpt_every=100)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    source = _batches(cfg)

    def batches():
        for i, b in enumerate(source):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    before = signal.getsignal(signal.SIGTERM)
    out = tr.fit(params, batches(), resume=False)
    assert out["last_step"] == 3
    assert tr.ckpt.all_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) is before
    restored = tr.ckpt.restore(3, {"params": out["params"],
                                   "opt": out["opt_state"]})
    assert int(restored["opt"]["step"]) == 3


def test_straggler_watchdog(tmp_path):
    """The reference's rule: the EMA starts at step warmup − 1; from step
    warmup on, a step slower than factor × EMA is an event."""
    import time

    cfg, tr = _port_trainer(tmp_path, steps=10, ckpt_every=100,
                            straggler_factor=3.0)
    slow = {6: 0.25}

    def fake_step(params, state, batch, _n=[0]):
        time.sleep(slow.get(_n[0], 0.02))
        _n[0] += 1
        return params, state, {"loss": torch.tensor(1.0)}

    tr.step_fn = fake_step
    params = {"w": torch.zeros(2)}
    out = tr.fit(params, iter(lambda: {}, None), resume=False)
    assert [e["step"] for e in out["straggler_events"]] == [6]
    ev = out["straggler_events"][0]
    assert ev["dt"] > 3.0 * ev["ema"]


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (3, 5, 1, 2), (3, 6, 0, 2), (7, 123, 3, 4)])
def test_synthetic_batches_bit_identical(seed, step, shard, n_shards):
    ref = RP.SyntheticLM(50304, 32, 8, seed=seed)
    port = TP.SyntheticLM(50304, 32, 8, seed=seed)
    a = ref.batch(step, shard, n_shards)["tokens"]
    b = port.batch(step, shard, n_shards)["tokens"]
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def test_memmap_and_make_batches_bit_identical(tmp_path):
    path = str(tmp_path / "corpus.bin")
    toks = np.random.default_rng(0).integers(0, 5000, 4096).astype(np.int32)
    TP.MemmapTokens.write_corpus(path, toks)
    assert np.array_equal(np.fromfile(path, np.int32), toks)
    ref = RP.MemmapTokens(path, vocab_size=2048, seq_len=16, global_batch=4)
    port = TP.MemmapTokens(path, vocab_size=2048, seq_len=16, global_batch=4)
    for step in range(3):
        np.testing.assert_array_equal(port.batch(step, 1, 2)["tokens"],
                                      ref.batch(step, 1, 2)["tokens"])
    rit = RP.make_batches(RP.SyntheticLM(100, 8, 4), start_step=3, shard=1,
                          n_shards=2)
    pit = TP.make_batches(TP.SyntheticLM(100, 8, 4), start_step=3, shard=1,
                          n_shards=2)
    for _ in range(3):
        np.testing.assert_array_equal(next(pit)["tokens"],
                                      next(rit)["tokens"])


def test_launch_train_on_the_cpu(tmp_path, capsys, caplog):
    """Three smoke steps through the launcher, with the reference's
    printout; then a 4-step run with checkpoints at 2 and 4, its step-4
    checkpoint deleted, resumed from step 2 to 4: the resumed run ends
    with the first run's parameters, bit for bit."""
    import shutil

    base = ["--arch", "smollm-135m", "--device", "cpu", "--batch", "2",
            "--seq", "16"]
    out = launch_train.main(base + ["--steps", "3", "--ckpt-dir",
                                    str(tmp_path / "a")])
    assert out["last_step"] == 3
    assert next(iter(out["params"].values())).device.type == "cpu"
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("finished at step 3; final loss ") and \
        line.endswith("stragglers observed: 0")
    run = base + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
                  str(tmp_path / "b")]
    whole = launch_train.main(run)
    ckpt = CheckpointManager(str(tmp_path / "b"))
    assert ckpt.all_steps() == [2, 4]
    shutil.rmtree(ckpt._step_dir(4))
    with caplog.at_level("INFO", logger="repro_torch.trainer"):
        resumed = launch_train.main(run)
    assert "resumed from step 2" in caplog.text
    assert resumed["last_step"] == whole["last_step"] == 4
    for a, b in zip(_leaves(resumed["params"]), _leaves(whole["params"])):
        assert torch.equal(a, b)
