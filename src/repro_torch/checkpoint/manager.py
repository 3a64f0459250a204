"""Checksummed, async checkpointing with auto-resume, in the on-disk
layout of ``repro.checkpoint.manager``, so a checkpoint written by
either package restores into the other:

  <dir>/step_000100/
    tree.json            # structure + per-leaf key/shape/dtype
    shard_00000.npz      # leaves by path-joined key ("params/conv/0/w")
    MANIFEST.json        # per-file sha256; written LAST

A checkpoint is valid iff MANIFEST.json exists and every checksum
matches: a process killed mid-write leaves no MANIFEST, so
``latest_valid_step`` skips it (torn-write safety). ``tree.json``'s
``treedef`` holds this package's own description of the structure;
neither package's ``restore`` reads it (the manifest's sha256 covers
it). ``AsyncCheckpointer`` writes on a background thread from a host
copy taken before ``save`` returns.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as ptree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(x) -> np.ndarray:
    """A host copy of ``x`` that no later in-place update can reach."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _treedef(tree) -> str:
    """The structure of ``tree`` with its leaves as ``*``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(v)}" for k, v in sorted(tree.items())) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write(directory: str, step: int, leaves: list[tuple[str, np.ndarray]],
           treedef: str, host_id: int) -> str:
    ckpt = os.path.join(directory, f"step_{step:08d}")
    tmp = ckpt + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    meta = {
        "step": step,
        "treedef": treedef,
        "leaves": [{"key": k, "shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in leaves],
    }
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(meta, f)
    np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **dict(leaves))
    manifest = {
        "step": step,
        "files": {name: _sha256(os.path.join(tmp, name))
                  for name in os.listdir(tmp) if name != "MANIFEST.json"},
    }
    # Manifest last, then an atomic rename: torn writes stay invisible.
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.rename(tmp, ckpt)
    return ckpt


def _host_leaves(tree) -> list[tuple[str, np.ndarray]]:
    return [(_key(path), _to_numpy(v)) for path, v in ptree.leaves_with_path(tree)]


def save(directory: str, step: int, tree, *, host_id: int = 0) -> str:
    """Blocking save of a tree of tensors (or arrays). Returns the
    checkpoint path."""
    return _write(directory, step, _host_leaves(tree), _treedef(tree), host_id)


def is_valid(ckpt: str) -> bool:
    mpath = os.path.join(ckpt, "MANIFEST.json")
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for name, digest in manifest["files"].items():
            if _sha256(os.path.join(ckpt, name)) != digest:
                return False
        return True
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def _step_entries(directory: str) -> list[tuple[int, str]]:
    """``(step, dirname)`` of every ``step_<digits>`` entry, by step.
    Other names (``step_abc``, ``.tmp`` staging dirs, stray files) are
    skipped: they must never crash the recovery path."""
    out = []
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        tail = name[len("step_"):]
        if tail.isdigit():
            out.append((int(tail), name))
    return sorted(out)


def latest_valid_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    for step, name in reversed(_step_entries(directory)):
        if is_valid(os.path.join(directory, name)):
            return step
    return None


def restore(directory: str, step: int, like):
    """Restore into the structure of ``like``: each leaf a tensor on the
    device of ``like``'s leaf (the CPU where that leaf is no tensor)."""
    ckpt = os.path.join(directory, f"step_{step:08d}")
    data: dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(ckpt)):
        if name.startswith("shard_"):
            with np.load(os.path.join(ckpt, name)) as z:
                data.update({k: z[k] for k in z.files})
    keys = [_key(path) for path, _ in ptree.leaves_with_path(like)]
    missing = [k for k in keys if k not in data]
    if missing:
        unexpected = [k for k in sorted(data) if k not in set(keys)]
        raise ValueError(
            f"checkpoint {ckpt} does not match the restore structure: "
            f"missing leaf keys {missing}; unexpected leaf keys in the "
            f"checkpoint {unexpected}. Pass a `like` tree with the same "
            f"structure the checkpoint was saved with (keys are "
            f"path-joined, e.g. 'params/conv/0/w').")

    def load(path, leaf):
        t = torch.from_numpy(np.array(data[_key(path)], copy=True))
        return t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t

    return ptree.map_with_path(load, like)


def retain(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    for _, name in _step_entries(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


class AsyncCheckpointer:
    """Writes checkpoints on a background thread.

    ``save`` takes a host copy of every leaf before it returns (the only
    synchronous part: a tensor updated in place afterwards cannot reach
    the file) and queues it; the writer thread does npz + sha256.
    ``wait()`` drains the queue (call before exit or restore)."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._errors: list[BaseException] = []
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, leaves, treedef = item
            try:
                _write(self.directory, step, leaves, treedef, 0)
                retain(self.directory, self.keep)
            except Exception as e:  # surfaced by wait() and close()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def save(self, step: int, tree) -> None:
        if self._closed:
            # The writer thread has exited; a queued snapshot would never
            # be written.
            raise RuntimeError(
                "AsyncCheckpointer.save() after close(): the writer "
                "thread has exited and this snapshot would never be "
                "written. Create a new AsyncCheckpointer (or call save() "
                "before close()).")
        self._q.put((step, _host_leaves(tree), _treedef(tree)))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._q.join()
        if self._errors:
            raise self._errors[0]
