"""Checkpointing: atomic step directories, async writer, retention, resume,
as the reference's ``checkpoint/manager.py``, over the port's trees of
tensors, with the reference's on-disk layout::

    <root>/step_000123/
        MANIFEST.json        # tree structure, shapes, dtypes, data state
        arrays.npz           # flattened leaves (np arrays)
    <root>/step_000123.tmp/  # write staging — renamed atomically on commit

Restore picks the newest COMMITTED step (a crash mid-write leaves only a
``.tmp`` directory, which is ignored and garbage-collected).  The async
writer runs on a daemon thread with a bounded queue of one in-flight
snapshot — the train loop never blocks on I/O unless two checkpoints are
requested back-to-back.  The writer brings tensors to the host; the train
step replaces its tensors rather than writing into them, so a queued
snapshot stays as it was saved.  Restoring into a ``target`` puts each
leaf on its target leaf's device.

bf16 has no NumPy dtype here, so a bf16 leaf is written as its 16-bit
pattern (``uint16``) with the dtype name ``"bfloat16"`` in the manifest, as
the reference writes it.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import queue
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import DataState


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """A leaf as a NumPy array to store, and the dtype name to record."""

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    a = np.asarray(x)
    return a, a.dtype.name


def _to_tensor(a: np.ndarray, name: str, like=None) -> torch.Tensor:
    """The stored array as a tensor of its recorded dtype, on ``like``'s
    device when a target leaf is given (else on the CPU)."""

    if name == "bfloat16":
        t = torch.from_numpy(np.require(a, requirements="C").view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.require(a, requirements="C"))
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def _example(like) -> Any:
    """``like``'s structure with every leaf None, as JSON containers."""

    if isinstance(like, dict):
        return {k: _example(v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_example(v) for v in like]
    return None


@dataclasses.dataclass
class Snapshot:
    step: int
    tree: Any
    data_state: Optional[DataState] = None


class CheckpointManager:
    def __init__(
        self,
        root: str | pathlib.Path,
        *,
        keep: int = 3,
        async_writes: bool = True,
    ) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async = async_writes
        self._queue: "queue.Queue[Optional[Snapshot]]" = queue.Queue(maxsize=1)
        self._errors: List[BaseException] = []
        self._worker: Optional[threading.Thread] = None
        if async_writes:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        self._gc_tmp()

    # ------------------------------------------------------------------ #
    def save(self, snap: Snapshot) -> None:
        if self._async:
            self._raise_pending()
            self._queue.put(snap)  # blocks only if one write is in flight
        else:
            self._write(snap)

    def wait(self) -> None:
        """Block until all queued writes are committed (tests / shutdown)."""

        if self._async:
            self._queue.join()
        self._raise_pending()

    def restore(self, target: Any = None) -> Optional[Snapshot]:
        """Newest committed snapshot, or None.

        ``target``: example tree defining the structure to restore into,
        and each leaf's device — REQUIRED when the tree contains
        NamedTuples (like AdamWState); plain nested dicts and lists restore
        without it, onto the CPU."""

        steps = self.committed_steps()
        if not steps:
            return None
        return self.restore_step(steps[-1], target)

    def restore_step(self, step: int, target: Any = None) -> Snapshot:
        d = self.root / f"step_{step:09d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        dtypes = manifest.get("dtypes")
        like = target if target is not None else json.loads(manifest["treedef_example"])
        likes = tree_lib.leaves(like)
        if len(likes) != manifest["num_leaves"]:
            raise ValueError(
                f"step {step} holds {manifest['num_leaves']} leaves, the target "
                f"{len(likes)}"
            )
        with np.load(d / "arrays.npz") as z:
            leaves = []
            for i, lk in enumerate(likes):
                a = z[f"leaf_{i}"]
                leaves.append(_to_tensor(a, dtypes[i] if dtypes else a.dtype.name, lk))
        ds = manifest.get("data_state")
        return Snapshot(
            step=manifest["step"],
            tree=tree_lib.unflatten(like, leaves),
            data_state=DataState(**ds) if ds else None,
        )

    def committed_steps(self) -> List[int]:
        out = []
        for d in self.root.iterdir():
            if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp"):
                if (d / "MANIFEST.json").exists():
                    out.append(int(d.name.split("_")[1]))
        return sorted(out)

    # ------------------------------------------------------------------ #
    def _drain(self) -> None:
        while True:
            snap = self._queue.get()
            if snap is None:
                self._queue.task_done()
                return
            try:
                self._write(snap)
            except BaseException as e:  # noqa: BLE001 — raised by save / wait
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def _write(self, snap: Snapshot) -> None:
        final = self.root / f"step_{snap.step:09d}"
        tmp = self.root / f"step_{snap.step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        encoded = [_to_numpy(x) for x in tree_lib.leaves(snap.tree)]
        np.savez(
            tmp / "arrays.npz",
            **{f"leaf_{i}": a for i, (a, _) in enumerate(encoded)},
        )
        manifest = {
            "step": snap.step,
            "num_leaves": len(encoded),
            "dtypes": [name for _, name in encoded],
            "treedef_example": json.dumps(_example(snap.tree)),
            "data_state": dataclasses.asdict(snap.data_state)
            if snap.data_state
            else None,
        }
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._retain()

    def _retain(self) -> None:
        steps = self.committed_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    def _gc_tmp(self) -> None:
        for d in self.root.glob("step_*.tmp"):
            shutil.rmtree(d, ignore_errors=True)

    def _raise_pending(self) -> None:
        if self._errors:
            raise self._errors.pop(0)

    def close(self) -> None:
        if self._async and self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=10)
