"""``Trainer`` on a fleet's grid (CPU, gloo): one unsharded checkpoint,
resume, restore onto another grid, and a stop agreed across processes.

One module-scoped fleet per layout (``launch_local(n, w, device="cpu")``)
runs ``tests/_torch_mp_trainer_worker.py``, every case in one launch:

* (data 1, model 8) over 2 processes × 4 ranks: the model axis crosses
  the processes and the experts are split;
* (data 2, model 4) over 2 × 4: each data group inside one process.

Cases: the qwen2 smoke dense model at d_model 64, 4 heads, 2 kv heads
and the olmoe smoke EP model at capacity 8.0, each trained 4 steps with a
checkpoint every 2 from the reference's initial weights. The fleet's
steps and checkpoints are held to the emulated grid of the same shape
(``torch.equal`` on (1, 8), within ``test_torch_lm_fleet_train``'s
``TWIN_TOL`` on (2, 4)); the checkpoint's keys, shapes and dtypes to a
one-device ``Trainer``'s and the reference ``Trainer``'s; the first loss
within 5e-3 of the reference's unsharded step. The (1, 8) fleet runs
first: its checkpoint is what the (2, 4) fleet restores.
"""
import dataclasses
import json
import signal
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_trainer_worker as W  # noqa: E402
from test_torch_lm_fleet_train import TWIN_TOL  # noqa: E402

FLEET_TIMEOUT = 240.0
# layout -> (processes, ranks per process, grid); launched in this order
FLEETS = {"data1_model8-2x4": (2, 4, (1, 8)),
          "data2_model4-2x4": (2, 4, (2, 4))}
EXACT = ("data1_model8-2x4",)  # one data group: the emulated order
REF_TOL = 5e-3
CASES = list(W.CASES)


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each case's reference initial params, and one step of the
    reference ``Trainer``: its loss and its checkpoint's keys."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jax_smoke
    from repro.data import pipeline as RP
    from repro.models.transformer import init_params
    from repro.optim.adamw import AdamWConfig
    from repro.train.trainer import Trainer, TrainerConfig

    root = tmp_path_factory.mktemp("ref_trainer")
    arrays, losses, keys = {}, {}, {}
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        for name, (arch, changes) in W.CASES.items():
            cfg = dataclasses.replace(jax_smoke(arch), **changes)
            params = init_params(jax.random.PRNGKey(0), cfg)
            arrays.update(_flatten(params, f"{name}/params"))  # fit donates
            tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainerConfig(
                total_steps=1, ckpt_every=1, log_every=1,
                ckpt_dir=str(root / name)))
            out = tr.fit(params, RP.make_batches(RP.SyntheticLM(
                cfg.vocab_size, W.SEQ, W.BATCH)), resume=False)
            losses[name] = out["history"][0]["loss"]
            meta = json.loads((root / name / "step_00000001" /
                               "metadata.json").read_text())
            keys[name] = meta["keys"]
    finally:
        for s, h in handlers.items():  # the reference's fit keeps its own
            signal.signal(s, h)
    return arrays, losses, keys


@pytest.fixture(scope="module")
def fleets(reference, tmp_path_factory):
    from repro_torch.launch.multiprocess import launch_local

    out = tmp_path_factory.mktemp("trainer_fleet")
    np.savez(out / "cases.npz", **reference[0])
    res = {}
    for layout, (nproc, local, shape) in FLEETS.items():
        rc = launch_local(nproc, local, timeout=FLEET_TIMEOUT, device="cpu",
                          argv=[sys.executable,
                                str(HERE / "_torch_mp_trainer_worker.py"),
                                str(out), layout, "x".join(map(str, shape)),
                                str(out / "data1_model8-2x4")])
        assert rc == 0, f"the {layout} fleet failed (exit {rc})"
        res[layout] = [json.loads(
            (out / f"{layout}.rank{r}.json").read_text())
            for r in range(nproc)]
    return res


def _each(fleets, layout, case):
    return [r["cases"][case] for r in fleets[layout]]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_fleet_steps_equal_emulated_twin(fleets, layout, case):
    runs = _each(fleets, layout, case)
    for q, run in enumerate(runs):
        assert run["last_step"] == W.STEPS
        assert len(run["steps"]) == W.STEPS
        for i, st in enumerate(run["steps"]):
            where = f"{layout} {case} process {q} step {i + 1}"
            (e_loss, f_loss), (e_norm, f_norm) = st["loss"], st["grad_norm"]
            if layout in EXACT:
                assert st["loss_equal"] and st["norm_equal"], where
                assert st["params_equal"], where
            else:
                assert abs(f_loss - e_loss) <= TWIN_TOL["loss"] * abs(e_loss)
                assert abs(f_norm - e_norm) <= TWIN_TOL["grad_norm"] * e_norm
                assert st["param_max_err"] <= TWIN_TOL["param"], where
    # every process reports the same global loss and norm
    for i in range(W.STEPS):
        assert len({(r["steps"][i]["loss"][1], r["steps"][i]["grad_norm"][1])
                    for r in runs}) == 1


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_fleet_fit_consumes_its_tree(fleets, layout, case):
    """Every process's ``fit`` returns the tree it was given, its
    tensors holding the final parameters."""
    assert all(run["consumed"] for run in _each(fleets, layout, case))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_first_loss_within_5e3_of_reference(fleets, reference, layout,
                                            case):
    want = reference[1][case]
    for run in _each(fleets, layout, case):
        assert abs(run["steps"][0]["loss"][1] - want) < REF_TOL


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_checkpoint_written_once_by_the_lead(fleets, layout, case):
    lead, *others = _each(fleets, layout, case)
    want = list(range(W.EVERY, W.STEPS + 1, W.EVERY))
    assert lead["all_steps"] == want and lead["tmp_left"] == []
    # each step saved once by every process, written by the lead alone
    assert lead["saves"] == lead["writes"] == len(want)
    for run in others:
        assert run["saves"] == len(want) and run["writes"] == 0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_checkpoint_keys_equal_one_device_and_reference(fleets, reference,
                                                         layout, case):
    """Path keys, global shapes and dtypes: the fleet's unsharded tree is
    what a one-device Trainer and the reference's Trainer write."""
    lead = _each(fleets, layout, case)[0]
    assert lead["keys"] == lead["one_device_keys"] == reference[2][case]
    cfg = W.case_config(case)
    if cfg.family == "moe":  # the experts at their global count
        assert lead["keys"]["params/layers/moe/w1"]["shape"][1] == \
            cfg.n_experts


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_checkpoint_equals_emulated_twin(fleets, layout, case):
    lead = _each(fleets, layout, case)[0]
    for step, ck in lead["checkpoints"].items():
        assert ck["keys_equal"], step
        if layout in EXACT:
            assert ck["equal"], f"{layout} {case} step {step}"
        else:
            assert ck["max_err"] <= TWIN_TOL["param"], (step, ck)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_resume_after_deleting_the_last_checkpoint(fleets, layout, case):
    for run in _each(fleets, layout, case):
        assert run["resume"]["first_step"] == W.EVERY
        assert run["resume"]["equal"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_restore_onto_another_grid(fleets, layout, case):
    """(1, 8): a one-device checkpoint continued on the fleet, and the
    fleet's checkpoint continued on one device (the lead); (2, 4): the
    (1, 8) fleet's checkpoint. Each against a plain continuation of that
    grid from the same checkpoint."""
    runs = _each(fleets, layout, case)
    want = ({"one_device->fleet", "fleet->one_device"} if layout in EXACT
            else {"data1_model8->fleet"})
    assert set(runs[0]["cross"]) == want
    for run in runs:
        for what, got in run["cross"].items():
            if layout in EXACT:
                assert got["equal"], what
            else:
                assert got["max_err"] <= TWIN_TOL["param"], (what, got)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(FLEETS))
def test_shape_mismatch_raises_on_every_process(fleets, layout, case):
    for run in _each(fleets, layout, case):
        assert "stored shape" in run["shape_mismatch"]


@pytest.mark.parametrize("variant", list(W.PREEMPTS))
@pytest.mark.parametrize("layout", list(FLEETS))
def test_sigterm_on_one_process_stops_every_process(fleets, layout,
                                                    variant):
    """Process 1 takes SIGTERM with step 2's batch (``batch``), or inside
    step 1's fold of the stop flag or just after it (``in_fold``,
    ``after_fold``: the request is folded with step 2): every process
    stops after step 2, with one complete checkpoint of step 3 (the
    launch exits 0: every process returned)."""
    runs = _each(fleets, layout, W.PREEMPT_CASE)
    at = W.PREEMPTS[variant][2] + 1
    for run in runs:
        pre = run["preempt"][variant]
        assert pre["last_step"] == at and pre["saves"] == 1
        assert pre["handler_restored"]
    assert runs[0]["preempt"][variant]["all_steps"] == [at]
    assert runs[0]["preempt"][variant]["tmp_left"] == []
