"""Checkpoint manager: atomic, async, keep-k.

The port of the JAX package's ``checkpoint/manager.py``, on state trees of
tensors (dataclasses, tuples, lists and dicts of tensors).  Layout, one
directory per step, atomically renamed into place:

    <root>/ckpt_00001230/
        arrays.npz          flat {path -> array} of the state tree
        meta.json           step, extra state (a stream's cursor, ...)

Tensors pass through NumPy: ``save`` copies every leaf to the host before
it returns, so a caller may fold the next chunk into the same tensors in
place while an asynchronous write is still running.  ``restore`` takes a
*template* tree and puts each array on its template leaf's device, in its
dtype.  Every byte of a checkpoint goes through one write seam,
``_write``, which ``ft.inject.enospc_after`` replaces to fill the disk.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

#: a staging dir older than this is reaped even if its pid LOOKS alive: an
#: in-flight _write is seconds old, so a "live" owner this stale is a
#: recycled pid, not a peer mid-write.
STALE_TMP_S = 3600.0


def _write(f, data: bytes) -> None:
    """The single seam every checkpoint byte is written through."""
    f.write(data)


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) pairs of a state tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(tree):
        for fld in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, fld.name), f"{path}.{fld.name}")
    else:
        raise TypeError(f"not a state tree leaf: {type(tree).__name__}")


def _rebuild(tree: Any, leaves) -> Any:
    """``tree`` with its tensors replaced, in ``_leaves`` order."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return type(tree)(**{f.name: _rebuild(getattr(tree, f.name), leaves)
                         for f in dataclasses.fields(tree)})


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    """Host copies of every leaf, taken now."""
    return {p: t.detach().to("cpu", copy=True).numpy()
            for p, t in _leaves(tree)}


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray]) -> Any:
    out = []
    for path, leaf in _leaves(template):
        if path not in flat:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = flat[path]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {path}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        out.append(torch.as_tensor(arr).to(device=leaf.device,
                                           dtype=leaf.dtype))
    return _rebuild(template, iter(out))


class CheckpointManager:
    def __init__(self, root: str, keep_last: int = 3,
                 async_save: bool = True):
        self.root = root
        self.keep_last = keep_last
        self.async_save = async_save
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._closed = False
        os.makedirs(root, exist_ok=True)
        self._gc_orphans()

    @classmethod
    def for_run(cls, root: str, fingerprint: str,
                keep_last: int = 3, async_save: bool = True
                ) -> "CheckpointManager":
        """A manager scoped to ONE run under a shared ``root``: runs with
        different fingerprints get their own subdirectories, so their step
        counters and keep-k GC never touch each other's snapshots; the same
        fingerprint finds its own snapshots again."""
        return cls(os.path.join(root, f"run_{fingerprint[:16]}"),
                   keep_last=keep_last, async_save=async_save)

    @staticmethod
    def _pid_alive(pid_s: str) -> bool:
        """Liveness of a pid string from a staging-dir name; anything
        unparseable or out of range has no live owner."""
        try:
            pid = int(pid_s)
        except ValueError:
            return False
        if pid <= 0:
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False        # owner is gone: orphaned
        except PermissionError:
            return True         # pid exists under another uid: assume live
        except (OverflowError, ValueError):
            return False        # absurd pid: no live owner claim
        return True

    def _gc_orphans(self) -> None:
        """Remove ``.tmp_ckpt_*`` staging directories (a crash during a
        write) and ``ckpt_*.old.*`` backups (a crash during the commit
        swap) whose writer is dead, or whose "live" writer is older than
        ``STALE_TMP_S`` (a recycled pid)."""
        for name in os.listdir(self.root):
            staging = name.startswith(".tmp_ckpt_")
            backup = name.startswith("ckpt_") and ".old." in name
            if not (staging or backup):
                continue
            path = os.path.join(self.root, name)
            if self._pid_alive(name.rpartition(".")[2]):
                try:
                    age = time.time() - os.path.getmtime(path)
                except OSError:
                    continue    # raced with its owner's rename/cleanup
                if age < STALE_TMP_S:
                    continue    # a live peer's in-flight write
            shutil.rmtree(path, ignore_errors=True)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        """Flush the pending async write and shut the executor down."""
        if self._closed:
            return
        try:
            self.wait()
        finally:
            self._closed = True
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- save -------------------------------------------------------------
    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra: Dict[str, Any]) -> str:
        # pid-suffixed staging name: a concurrent manager sharing this root
        # can tell a live peer's in-flight write from a crashed one's.
        tmp = os.path.join(self.root, f".tmp_ckpt_{step:08d}.{os.getpid()}")
        final = os.path.join(self.root, f"ckpt_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            buf = io.BytesIO()
            np.savez(buf, **flat)
            meta = json.dumps({"step": step, "extra": extra}).encode()
            for name, data in (("arrays.npz", buf.getvalue()),
                               ("meta.json", meta)):
                with open(os.path.join(tmp, name), "wb") as f:
                    _write(f, data)
                    f.flush()
                    os.fsync(f.fileno())
        except BaseException:
            # ENOSPC / partial write: the staging dir goes, ``final`` was
            # never touched, so the previous checkpoint stays loadable.
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        # commit by swap, never delete-then-rename: a death between the
        # renames leaves the old snapshot in a pid-suffixed backup.
        backup = None
        if os.path.exists(final):
            backup = f"{final}.old.{os.getpid()}"
            if os.path.exists(backup):
                shutil.rmtree(backup)
            os.rename(final, backup)
        os.rename(tmp, final)           # atomic commit
        if backup is not None:
            shutil.rmtree(backup, ignore_errors=True)
        self._gc()
        return final

    def save(self, step: int, state: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot ``state`` to host memory now; write it asynchronously
        (``async_save``) or before returning."""
        flat = _flatten(state)
        extra = extra or {}
        self.wait()
        if self.async_save:
            self._pending = self._pool.submit(self._write, step, flat, extra)
        else:
            self._write(step, flat, extra)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    # -- restore ----------------------------------------------------------
    def steps(self) -> List[int]:
        """Committed steps; entries that merely look like checkpoints
        (stray files, ``ckpt_old``, commit backups) are skipped."""
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("ckpt_"):
                continue
            suffix = name[len("ckpt_"):]
            if not suffix.isdigit():
                continue
            if not os.path.isdir(os.path.join(self.root, name)):
                continue
            out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _dir(self, step: Optional[int]) -> str:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return os.path.join(self.root, f"ckpt_{step:08d}")

    def meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The ``extra`` dict of a checkpoint (default: the latest) without
        loading its arrays, so a resume checks its cursor first."""
        with open(os.path.join(self._dir(step), "meta.json")) as f:
            return json.load(f)["extra"]

    def restore(self, template: Any, step: Optional[int] = None
                ) -> tuple[Any, Dict[str, Any]]:
        """Restore into ``template``'s structure, each leaf on its
        template leaf's device and in its dtype."""
        d = self._dir(step)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return _unflatten_into(template, flat), meta["extra"]

    # -- gc ---------------------------------------------------------------
    def _gc(self) -> None:
        for s in self.steps()[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.root, f"ckpt_{s:08d}"),
                          ignore_errors=True)
