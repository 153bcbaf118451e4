"""Fault-tolerant checkpointing: atomic bundles with per-file manifests.

Port of ``repro/checkpoint/manager.py``. ``atomic_dir`` (with its
``torn_checkpoint`` fire site), ``file_digest``, ``bundle_manifest`` and
``verify_bundle`` are the reference's. ``CheckpointManager`` saves a
"tree" — a tensor, a numpy array, or nested dicts / lists / tuples of
them (dict keys in sorted order, as ``optim.adamw`` walks them):

* **atomic**: writes go to ``step_XXXXXXXX.tmp/`` then a single
  ``rename``; a crash mid-write can never corrupt the latest checkpoint;
* **retain-k**: old checkpoints are garbage-collected, newest kept;
* **auto-resume**: ``latest_step`` finds the newest complete checkpoint;
* **device-free**: arrays are stored on the host with the tree flattened
  to path keys, and ``restore(step, like, device=...)`` places them on
  any device;
* **unsharded on a fleet** (``CheckpointManager(..., dist=)`` over a
  fleet's grid, ``Topology.multiprocess(mesh=...)``): ``save(..., shards=
  dist.leaf_splits(tree, cfg))`` has one writer, the lead (process 0):
  every sharded leaf (the MoE experts, params and moments) is gathered
  to it over the model ranks (``DistContext.gather_to_lead``), every
  whole leaf is its own copy, and it writes each leaf at its global
  shape — the file a one-device run of the same model writes. The lead
  alone stages, publishes and garbage-collects; every process then waits
  at a barrier, so none returns before the checkpoint is published.
  ``shards`` is keyed by the leaves' paths and must name every leaf;
  on a fleet it is required;
* **restore onto any grid** (the reference's ``shardings=``): every
  process verifies the bundle, reads the global arrays, checks each
  stored shape against the leaf's global shape and keeps its own chunks
  of each sharded leaf (its model ranks' experts, in ascending rank: a
  run, or not where its span cuts across data groups) — on one device,
  the emulated grid or a fleet of another layout alike;
* **self-describing**: metadata.json carries step, paths, shapes, dtypes
  and the per-file digests, all checked before an array is touched.

Storage is one ``np.savez`` file per checkpoint, its sha256 taken from
the bytes as ``np.savez`` writes them (``_HashingFile``); bfloat16
tensors are stored through a 16-bit integer view and restored bit for
bit. ``timings`` keeps each save's and restore's host seconds and bytes:
a save's gathers, host copies, write and sha256 (part of the write); a
restore's sha256 and read.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["CheckpointManager", "atomic_dir", "file_digest",
           "bundle_manifest", "verify_bundle"]


@contextlib.contextmanager
def atomic_dir(final: str) -> Iterator[str]:
    """Write a directory atomically: stage in ``<final>.tmp``, publish by
    a single ``rename``.

    The invariant every bundle in the repo leans on (checkpoints here,
    plan-ladder bundles in ``core.session``): readers only ever see
    absent or complete directories — a crash mid-write leaves a ``.tmp``
    that the next writer clears, never a half-written artifact under the
    published name. The staged path is yielded; on exception it is left
    for post-mortem and the published name is untouched.
    """
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    yield tmp
    from ..robustness import faults

    # chaos hook: a scheduled torn_checkpoint fault truncates one staged
    # file right before publication — the one window the rename trick
    # cannot defend (a torn COPY into the stage, not a torn publish).
    # Per-file digest manifests (bundle_manifest/verify_bundle) exist to
    # catch exactly this at load time.
    faults.maybe_tear_dir("atomic_dir", tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def file_digest(path: str, chunk: int = 1 << 20) -> str:
    """Streaming sha256 of one file (bundles can exceed memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def bundle_manifest(directory: str,
                    exclude: tuple = ()) -> Dict[str, Dict[str, Any]]:
    """Per-file ``{name: {"bytes", "sha256"}}`` manifest of a staged
    bundle — written into the bundle's own metadata so a torn or
    truncated file is detected at LOAD time with its name, instead of
    surfacing as an unpickling/npz error naming nothing."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(os.listdir(directory)):
        full = os.path.join(directory, name)
        if name in exclude or not os.path.isfile(full):
            continue
        out[name] = {"bytes": os.path.getsize(full),
                     "sha256": file_digest(full)}
    return out


def verify_bundle(directory: str, manifest: Optional[Dict[str, Any]],
                  source: str) -> None:
    """Check every manifest entry before any file is parsed.

    Raises ``ValueError`` naming the damaged file and the mismatch kind
    (missing / size / digest) — the actionable form of "this bundle is
    torn; re-copy or re-save it". A ``None`` manifest (bundle predates
    digests) verifies nothing, keeping old bundles loadable.
    """
    if not manifest:
        return
    for name, want in manifest.items():
        full = os.path.join(directory, name)
        if not os.path.exists(full):
            raise ValueError(
                f"{source}: bundle file {name!r} is missing — the bundle "
                f"is incomplete (torn copy or partial delete); re-fetch "
                f"or re-save it.")
        size = os.path.getsize(full)
        if int(want.get("bytes", size)) != size:
            raise ValueError(
                f"{source}: bundle file {name!r} is truncated "
                f"({size} bytes, manifest says {want['bytes']}); the "
                f"copy was torn mid-write — re-fetch or re-save the "
                f"bundle.")
        digest = want.get("sha256")
        if digest and file_digest(full) != digest:
            raise ValueError(
                f"{source}: bundle file {name!r} fails its sha256 check "
                f"(content corrupted in transit or on disk); re-fetch "
                f"or re-save the bundle.")


def _flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path key: leaf} over dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten_with_paths(t, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class _HashingFile:
    """The file ``np.savez`` writes to, hashed as it is written. It
    cannot seek, so zipfile writes each member front to back (its sizes
    in a data descriptor after it, as on any stream) and the bytes that
    pass are the file's; ``np.load`` reads it as any savez file.
    ``manifest`` is the entry ``bundle_manifest`` would read back."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._sha = hashlib.sha256()
        self.nbytes = 0
        self.sha256_s = 0.0

    def write(self, data) -> int:
        n = self._f.write(data)
        t0 = time.perf_counter()
        self._sha.update(data)
        self.sha256_s += time.perf_counter() - t0
        self.nbytes += n
        return n

    def tell(self) -> int:
        return self.nbytes

    def seek(self, *args):
        raise OSError("written front to back")

    def read(self, *args):  # np.savez takes an object with read() as a file
        raise OSError("write only")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def manifest(self) -> Dict[str, Any]:
        return {"bytes": self.nbytes, "sha256": self._sha.hexdigest()}


def _rebuild(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, leaves, f"{prefix}{i}/")
                          for i, t in enumerate(like))
    return leaves[prefix[:-1]]


class CheckpointManager:
    def __init__(self, directory: str, retain: int = 3, dist=None):
        self.dir = directory
        self.retain = retain
        # a fleet's context (one device and the emulated grid need none)
        self.dist = dist if dist is not None and dist.is_fleet else None
        self.lead = self.dist is None or self.dist.comm.proc == 0
        self.timings: List[Dict[str, Any]] = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                full = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(full, "metadata.json")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _split(self, flat: Dict[str, Any],
               shards: Optional[Mapping[str, Any]]) -> List[Any]:
        """Each leaf's (dim, M) split on a fleet, else None. On a fleet
        ``shards`` must name exactly the leaves of the tree."""
        if self.dist is None:
            return [None] * len(flat)
        if shards is None:
            raise ValueError(
                "a fleet's checkpoint needs shards= (DistContext."
                "leaf_splits of the tree): without it a sharded leaf would "
                "be taken as whole")
        if list(shards) != list(flat):
            missing = sorted(set(flat) - set(shards))
            extra = sorted(set(shards) - set(flat))
            raise ValueError(
                f"shards= does not name the tree's leaves in order "
                f"(missing {missing[:3]}, unknown {extra[:3]})")
        return list(shards.values())

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             shards: Optional[Mapping[str, Any]] = None) -> str:
        """Atomic save: tmp dir + fsync + rename. On a fleet every
        process calls it with its own ``tree`` and the leaves' splits
        (``shards``, as ``DistContext.leaf_splits`` gives them); the lead
        writes the unsharded tree."""
        flat = _flatten_with_paths(tree)
        splits = self._split(flat, shards)
        final = self._step_dir(step)
        t_save = time.perf_counter()
        rec = {"op": "save", "step": step, "gather_s": 0.0, "host_s": 0.0,
               "write_s": 0.0, "sha256_s": 0.0, "bytes": 0}
        arrays: Dict[str, np.ndarray] = {}
        keys: Dict[str, Dict[str, Any]] = {}
        for (key, leaf), split in zip(flat.items(), splits):
            t0 = time.perf_counter()
            if split is not None:  # a collective every process makes
                leaf = self.dist.gather_to_lead(leaf, split[0])
            t1 = time.perf_counter()
            if self.lead:
                arrays[key], dt = _to_host(leaf)
                keys[key] = {"shape": list(arrays[key].shape), "dtype": dt}
            rec["gather_s"] += t1 - t0
            rec["host_s"] += time.perf_counter() - t1
        if self.lead:
            with atomic_dir(final) as tmp:
                t0 = time.perf_counter()
                out = _HashingFile(os.path.join(tmp, "arrays.npz"))
                try:
                    np.savez(out, **arrays)
                finally:
                    out.close()
                rec.update(write_s=time.perf_counter() - t0,
                           sha256_s=out.sha256_s, bytes=out.nbytes)
                meta = {
                    "step": step,
                    "time": time.time(),
                    "keys": keys,
                    # per-file digests: restore() verifies these BEFORE
                    # np.load touches anything, so a torn copy of the
                    # checkpoint fails naming the file, not mid-parse
                    "files": {"arrays.npz": out.manifest()},
                    "extra": extra or {},
                }
                with open(os.path.join(tmp, "metadata.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
            self._gc()
        if self.dist is not None:
            self.dist.comm.barrier()
        rec["seconds"] = time.perf_counter() - t_save
        self.timings.append(rec)
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.retain] if self.retain > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, like: Any,
                device: Optional[Union[str, torch.device]] = None,
                shards: Optional[Mapping[str, Any]] = None,
                inplace: bool = False) -> Any:
        """Restore into the structure of ``like``.

        Each leaf comes back as ``like``'s leaf type and dtype: a tensor
        on ``device`` (default: the ``like`` tensor's own device), a
        numpy array, or a Python scalar. Stored shapes are checked
        against the metadata and against each leaf's global shape:
        ``like``'s own, or on a fleet for a leaf ``shards`` splits (dim,
        M) its shape with this process's model ranks' share of dim made
        whole; such a leaf keeps this process's model ranks' chunks along
        dim (``DistContext.local_span.models``). ``inplace``
        copies each array into ``like``'s tensor (every leaf a tensor)
        and returns ``like``.
        """
        d = self._step_dir(step)
        flat = _flatten_with_paths(like)
        splits = self._split(flat, shards)
        rec = {"op": "restore", "step": step}
        t0 = time.perf_counter()
        with open(os.path.join(d, "metadata.json")) as f:
            meta = json.load(f)
        verify_bundle(d, meta.get("files"), source=f"checkpoint {d}")
        t1 = time.perf_counter()
        data = np.load(os.path.join(d, "arrays.npz"))
        leaves: Dict[str, Any] = {}
        for (key, leaf), split in zip(flat.items(), splits):
            if key not in data:
                raise KeyError(f"checkpoint {d} missing key {key}")
            arr = data[key]
            want = meta["keys"][key]
            if list(arr.shape) != want["shape"]:
                raise ValueError(f"corrupt checkpoint: {key} shape mismatch")
            shape = list(np.shape(leaf))
            if split is not None:
                dim, M = split
                models = self.dist.local_span.models
                shape[dim] = shape[dim] * M // len(models)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(
                    f"{key}: stored shape {arr.shape} != expected "
                    f"{tuple(shape)}")
            if split is not None:  # this process's model ranks' chunks
                e = arr.shape[dim] // M
                keep = np.concatenate([np.arange(m * e, (m + 1) * e)
                                       for m in models])
                arr = np.ascontiguousarray(np.take(arr, keep, axis=dim))
            if isinstance(leaf, torch.Tensor):
                t = torch.from_numpy(arr)
                if want["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                if inplace:
                    leaf.copy_(t)
                    continue
                leaves[key] = t.to(leaf.device if device is None else device,
                                   leaf.dtype)
            elif isinstance(leaf, np.ndarray):
                leaves[key] = arr.astype(leaf.dtype)
            else:
                leaves[key] = type(leaf)(arr)
        now = time.perf_counter()
        rec.update(sha256_s=t1 - t0, read_s=now - t1, seconds=now - t0,
                   bytes=sum(f["bytes"] for f in
                             (meta.get("files") or {}).values()))
        self.timings.append(rec)
        return like if inplace else _rebuild(like, leaves)

    def restore_latest(self, like: Any,
                       device: Optional[Union[str, torch.device]] = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device)
