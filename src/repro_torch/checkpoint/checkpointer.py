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

On a mesh of ranks (``Checkpointer(..., mesh=)``, ``save(..., shardings=)``
/ ``restore(..., shardings=)``, the port's counterpart of the reference's
``restore(..., shardings=)``): every rank takes part in gathering each leaf
whole from its shards under its spec, rank 0 alone writes, ``wait()``
ends in a barrier of every rank, and ``restore`` slices each whole leaf to
this rank's shard. The files hold whole leaves either way, so a
checkpoint moves between meshes of any shape and one device.

The layout is the reference's: ``shard_000.npz`` with ``leaf_<i>`` arrays
in tree order, and a ``manifest.json``. numpy has no bfloat16, so a bf16
tensor is stored as its raw 16-bit pattern (an ``int16`` array) and the
manifest records ``"bfloat16"`` for it; ``restore`` views the bits back,
so a bf16 tree round-trips bit for bit. Every other dtype is stored as
numpy gives it, the files the same as before.
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

from repro_torch.launch import partitioning as PT
from repro_torch.optim.adamw import tree_leaves, tree_like


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy can hold it: bf16 as its bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.array(t)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _specs(shardings) -> list:
    """Specs in leaf order from a list or tree of specs or shardings."""
    return [getattr(x, "spec", x) for x in PT.flat_leaves(shardings)]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def save(self, step: int, tree: Any, shardings=None) -> None:
        """Snapshot ``tree``'s tensors to host memory, then write them. With
        ``shardings`` (specs of ``tree``'s leaves, on this ``mesh``) every
        rank must call it: each leaf is gathered whole first."""
        self.wait()
        leaves = tree_leaves(tree)
        if shardings is not None:
            leaves = [PT.gather_whole(t, sp, self.mesh) if self.mesh else t
                      for t, sp in zip(leaves, _specs(shardings))]
        if not self._writer:
            return
        host = [_to_host(t) for t in leaves]
        dtypes = ["bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)
                  for t, a in zip(leaves, host)]

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
                    "dtypes": dtypes,
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
        if self.mesh is not None:
            import torch.distributed as tdist
            tdist.barrier()

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

    def restore(self, like: Any, shardings=None) -> Any:
        """The latest checkpoint in the structure of ``like``; with
        ``shardings`` each leaf sliced to this rank's shard of its spec."""
        self.wait()
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        dtypes = json.loads((path / "manifest.json").read_text())["dtypes"]
        with np.load(path / "shard_000.npz") as data:
            refs = tree_leaves(like)
            if len(data.files) != len(refs):
                raise ValueError(f"checkpoint {step} has {len(data.files)} "
                                 f"tensors, the tree {len(refs)}")
            specs = (_specs(shardings) if shardings is not None
                     else [None] * len(refs))
            leaves = []
            for i, (r, dt, sp) in enumerate(zip(refs, dtypes, specs)):
                t = _from_host(data[f"leaf_{i}"], dt)
                if sp is not None and self.mesh is not None:
                    t = PT.local_shard(t, sp, self.mesh)
                leaves.append(t.to(device=r.device, dtype=r.dtype,
                                   copy=True))
        return tree_like(like, leaves)
