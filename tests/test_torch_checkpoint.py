"""The port's checkpoint manager against ``repro.checkpoint.manager`` (CPU).

It saves the GCN parameters and the AdamW state of a few training steps:
the round trip is exact, the stored keys, shapes, dtypes and arrays equal
the reference's for the same tree, retain-k keeps the newest, a leftover
``.tmp`` is never a checkpoint, a shape mismatch or a torn file is
caught before any array is used, and an empty directory restores
nothing.
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RManager  # noqa: E402,E501
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    atomic_dir, bundle_manifest, verify_bundle,
)
from repro_torch.models.gnn import gcn_from_numpy, gcn_params  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig, adamw_init, adamw_step,
)
from repro_torch.robustness import Fault, inject  # noqa: E402


def _trained_tree(steps: int = 3, seed: int = 0):
    """GCN 16 -> 32 -> 8 parameters and AdamW state after ``steps``."""
    model = gcn_from_numpy(gcn_params((16, 32, 8), seed=seed), device="cpu")
    params = list(model.parameters())
    state = adamw_init(params)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen)
        state, _ = adamw_step(cfg, params, state)
    return {"params": [p.detach().clone() for p in params], "opt": state}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(t) for t in tree)
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_roundtrip_gcn_params_and_adamw_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _trained_tree()
    assert int(tree["opt"]["step"]) == 3
    mgr.save(5, tree, extra={"epoch": 5})
    assert mgr.latest_step() == 5
    got = mgr.restore(5, _zeros_like(tree))
    assert len(_leaves(got)) == len(_leaves(tree)) == 4 * 3 + 1
    for want, have in zip(_leaves(tree), _leaves(got)):
        assert have.dtype == want.dtype and torch.equal(have, want)
    assert got["opt"]["step"].dtype == torch.int32
    meta = json.loads((tmp_path / "step_00000005" / "metadata.json")
                      .read_text())
    assert meta["extra"] == {"epoch": 5}
    # numpy and scalar leaves come back as their own types
    mixed = {"w": np.arange(6, dtype=np.float64).reshape(2, 3), "n": 7,
             "h": torch.arange(4, dtype=torch.bfloat16) / 3}
    mgr.save(6, mixed)
    back = mgr.restore(6, {"w": np.zeros((2, 3)), "n": 0,
                           "h": torch.zeros(4, dtype=torch.bfloat16)})
    assert back["n"] == 7 and isinstance(back["n"], int)
    np.testing.assert_array_equal(back["w"], mixed["w"])
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"],
                                                             mixed["h"])


def test_stored_arrays_equal_the_references(tmp_path):
    tree = _trained_tree(steps=2, seed=1)
    host = {"params": [p.numpy() for p in tree["params"]],
            "opt": {"m": [m.numpy() for m in tree["opt"]["m"]],
                    "v": [v.numpy() for v in tree["opt"]["v"]],
                    "step": tree["opt"]["step"].numpy()}}
    CheckpointManager(str(tmp_path / "port")).save(1, tree)
    RManager(str(tmp_path / "ref")).save(1, host)
    metas, arrays = [], []
    for which in ("port", "ref"):
        d = tmp_path / which / "step_00000001"
        metas.append(json.loads((d / "metadata.json").read_text())["keys"])
        arrays.append(dict(np.load(d / "arrays.npz")))
    assert metas[0] == metas[1]
    assert sorted(arrays[0]) == sorted(arrays[1])
    for k in arrays[0]:
        np.testing.assert_array_equal(arrays[0][k], arrays[1][k])
    # and each package restores the other's file
    got = CheckpointManager(str(tmp_path / "ref")).restore(
        1, _zeros_like(tree))
    for want, have in zip(_leaves(tree), _leaves(got)):
        assert torch.equal(have, want)


def test_retain_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=2)
    tree = _trained_tree(steps=1)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_atomic_no_partial(tmp_path):
    """A leftover .tmp dir from a crash is never visible as a checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() is None
    mgr.save(3, _trained_tree(steps=1))
    assert mgr.latest_step() == 3
    assert not (tmp_path / "step_00000003.tmp").exists()


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _trained_tree(steps=1)
    mgr.save(1, tree)
    bad = _zeros_like(tree)
    bad["params"][0] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="stored shape"):
        mgr.restore(1, bad)
    with pytest.raises(KeyError, match="missing key"):
        mgr.restore(1, {"nope": torch.zeros(1)})
    with inject([Fault(kind="torn_checkpoint", site="atomic_dir",
                       file="arrays", mode="truncate")]) as plan:
        mgr.save(2, tree)
    assert plan.fired("torn_checkpoint") == 1
    with pytest.raises(ValueError, match=r"arrays\.npz.*truncated"):
        mgr.restore(2, _zeros_like(tree))
    mgr.save(3, tree)  # an untorn save round-trips through the same check
    for want, have in zip(_leaves(tree),
                          _leaves(mgr.restore(3, _zeros_like(tree)))):
        assert torch.equal(have, want)


def test_restore_latest_empty_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest({"x": torch.zeros(3)}) == (None, None)
    mgr.save(4, {"x": torch.arange(3.0)})
    step, got = mgr.restore_latest({"x": torch.zeros(3)}, device="cpu")
    assert step == 4 and torch.equal(got["x"], torch.arange(3.0))


def test_manifest_names_damage(tmp_path):
    with atomic_dir(str(tmp_path / "b")) as tmp:
        for name, data in (("a.bin", b"x" * 10), ("b.bin", b"y" * 3)):
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
        manifest = bundle_manifest(tmp)
    d = str(tmp_path / "b")
    verify_bundle(d, manifest, source="t")
    verify_bundle(d, None, source="t")  # no manifest: nothing to check
    with open(os.path.join(d, "b.bin"), "wb") as f:
        f.write(b"z" * 3)
    with pytest.raises(ValueError, match="'b.bin' fails its sha256"):
        verify_bundle(d, manifest, source="t")
    os.remove(os.path.join(d, "a.bin"))
    with pytest.raises(ValueError, match="'a.bin' is missing"):
        verify_bundle(d, manifest, source="t")
