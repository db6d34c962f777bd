"""Asynchronous checkpointing of ``(step, TrainState)``, as in
``repro.checkpoint.checkpointer`` (single process, one shard).

* ``save()`` copies every tensor to host memory before it returns, then
  writes on a background thread: the train loop never waits on the disk,
  and later steps cannot change what is being written. ``wait()`` joins
  before the next save and at shutdown, and re-raises a writer's error.
* Writes go to ``step_<N>.tmp/`` and are renamed to ``step_<N>/``, so a
  crash mid-write never corrupts the latest checkpoint.
* The newest ``keep`` checkpoints are kept.
* ``restore(like)`` rebuilds ``like``'s structure, each tensor on the
  device and in the dtype of ``like``'s tensor at the same place.

The layout is the reference's: ``shard_000.npz`` with ``leaf_<i>`` arrays
in tree order, and a ``manifest.json``.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_like


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Any) -> None:
        """Snapshot ``tree``'s tensors to host memory, then write them."""
        self.wait()
        host = [np.array(t.detach().cpu()) for t in tree_leaves(tree)]

        def write():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "shard_000.npz",
                         **{f"leaf_{i}": a for i, a in enumerate(host)})
                manifest = {
                    "step": step,
                    "num_leaves": len(host),
                    "dtypes": [str(a.dtype) for a in host],
                    "shapes": [list(a.shape) for a in host],
                }
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            except Exception as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def steps(self):
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like: Any) -> Any:
        """The latest checkpoint in the structure of ``like``."""
        self.wait()
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        with np.load(self.dir / f"step_{step:08d}" / "shard_000.npz") as data:
            refs = tree_leaves(like)
            if len(data.files) != len(refs):
                raise ValueError(f"checkpoint {step} has {len(data.files)} "
                                 f"tensors, the tree {len(refs)}")
            leaves = [torch.from_numpy(data[f"leaf_{i}"]).to(
                device=r.device, dtype=r.dtype) for i, r in enumerate(refs)]
        return tree_like(like, leaves)
