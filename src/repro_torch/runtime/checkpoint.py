"""Atomic, asynchronous, keep-N checkpoints of the port's state trees.

Port of ``repro/runtime/checkpoint.py``, with the same on-disk layout, so a
directory of numpy leaves written by either package restores through the
other:

  * **Layout**: one directory per step, ``step_%010d``, holding one ``.npy``
    file per leaf, named by the leaf's path with ``/`` written as ``__``,
    and ``manifest.json`` with ``step``, ``extra`` (the caller's JSON
    payload) and ``leaves`` (``{path: {file, dtype, shape}}``).
  * **Trees**: a dataclass (such as ``SummaryState``), a dict, a list or a
    tuple, nested in any way; its leaves are torch tensors, numpy arrays or
    scalars, or Python numbers. A dataclass field's path is its name, a
    dict entry's its key, a sequence item's its index. (The reference's
    dataclasses flatten by position, so its ``SummaryState`` leaves are
    ``0``, ``1``, ...: a state tree is not shared between the packages,
    a dict of arrays is.)
  * **Atomicity**: a step is written into ``<dir>/.tmp-<step>`` and
    ``os.replace``-d to ``step_<n>`` only after an fsync'd ``COMMIT``
    marker is in place. A writer killed mid-step leaves a ``.tmp-``
    directory, which restore ignores and the next save garbage-collects.
  * **Async**: ``save_async`` snapshots the tree on the caller's thread, one
    ``.cpu()`` copy a leaf, so no CUDA tensor (and no tensor the caller may
    change afterwards) reaches the writer; serialization and fsync happen on
    one background writer thread. ``wait()`` joins the queued writes and
    raises a writer's error; saves are serialized, which keeps the keep-N
    garbage collection simple.
  * **Restore**: each leaf is read as numpy and converted to the template
    leaf's kind and dtype: a tensor on the template leaf's device (or
    ``device``), a numpy array, or a Python number.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

COMMIT = "COMMIT"


def _children(tree) -> list[tuple[str, Any]] | None:
    """``(path component, child)`` of an inner node; None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten(tree, prefix: tuple[str, ...] = ()) -> dict[str, Any]:
    """``{path: leaf}``; None is an empty subtree, as in a JAX pytree."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {"/".join(prefix) or "_root": tree}
    out: dict[str, Any] = {}
    for k, child in kids:
        out.update(_flatten(child, prefix + (k,)))
    return out


def _rebuild(template, leaves: dict[str, Any], prefix: tuple[str, ...] = ()):
    """``template``'s structure with each leaf taken from ``leaves``."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return leaves["/".join(prefix) or "_root"]
    new = {k: _rebuild(child, leaves, prefix + (k,)) for k, child in kids}
    if isinstance(template, dict):
        return {k: new[str(k)] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(new[str(i)] for i in range(len(template)))
    return dataclasses.replace(template, **new)


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory (one ``.cpu()`` copy for a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _like(arr: np.ndarray, leaf, device) -> Any:
    """``arr`` as the kind, dtype and device of the template ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=device or leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return arr.astype(leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr.item())
    return arr


class CheckpointManager:
    """keep-N checkpoint directory manager with an async writer thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._err: list[BaseException] = []
        # per-step accounting: {"snapshot_wall_s", "write_wall_s", "bytes"};
        # the snapshot is what the caller's loop pays for an async save, the
        # write and its bytes happen on the writer thread
        self.save_stats: dict[int, dict] = {}
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: dict | None = None) -> None:
        """Synchronous save (snapshot, write and commit on the caller's thread)."""
        snap = self._snapshot_timed(step, tree)
        self._write(step, snap, extra or {})

    def save_async(self, step: int, tree, extra: dict | None = None) -> None:
        """Snapshot now, serialize on the writer thread."""
        self._raise_pending()
        snap = self._snapshot_timed(step, tree)
        self._q.put((step, snap, extra or {}))

    def wait(self) -> None:
        """Block until every queued save has committed; raise a writer error."""
        self._q.join()
        self._raise_pending()

    def _snapshot_timed(self, step: int, tree) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        snap = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self.save_stats[step] = {"snapshot_wall_s": time.perf_counter() - t0,
                                 "write_wall_s": None, "bytes": None}
        return snap

    def _writer(self) -> None:
        while True:
            step, snap, extra = self._q.get()
            try:
                self._write(step, snap, extra)
            except BaseException as e:  # raised on the next save_async or wait
                self._err.append(e)
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err:
            raise self._err.pop(0)

    def _write(self, step: int, snap: dict[str, np.ndarray], extra: dict) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for key, arr in snap.items():
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][key] = {"file": fn, "dtype": str(arr.dtype),
                                       "shape": list(arr.shape)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, COMMIT), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        st = self.save_stats.setdefault(step, {"snapshot_wall_s": None})
        st["write_wall_s"] = time.perf_counter() - t0
        st["bytes"] = self.step_bytes(step)
        self._gc()

    def step_bytes(self, step: int) -> int:
        """On-disk size of a committed step (0 if absent or uncommitted)."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        if not os.path.exists(os.path.join(d, COMMIT)):
            return 0
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)
        for name in os.listdir(self.dir):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if name.startswith("step_") and os.path.exists(os.path.join(full, COMMIT)):
                out.append(int(name[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None,
                device: str | torch.device | None = None):
        """Restore into the structure of ``template``; returns
        ``(tree, step, extra)``.

        Each leaf takes the template leaf's kind and dtype; a tensor goes to
        ``device``, or to the template leaf's device when it is None. A leaf
        missing from the checkpoint raises ``KeyError``, a shape that differs
        from the template's ``ValueError``, no committed step
        ``FileNotFoundError``.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        restored: dict[str, Any] = {}
        for key, leaf in _flatten(template).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint {d} missing leaf {key!r}")
            arr = np.load(os.path.join(d, meta["file"]))
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                                 f"template {want}")
            restored[key] = _like(arr, leaf, device)
        return _rebuild(template, restored), manifest["step"], manifest.get("extra", {})
