"""The data-parallel group of the port, and the launcher that starts its
ranks: the data-only part of ``repro.launch.mesh``.

Where the reference builds a 1-D ``("data",)`` device mesh for
``shard_map``, the port has one process per data-parallel rank, joined by
``torch.distributed``. ``make_data_mesh(dp)`` returns this process's
``DataGroup``: ``dp``, its rank, the graph shards it runs (``L = P / dp``
of them, contiguous in shard order: rank ``r`` runs shards ``[r * L,
(r + 1) * L)``), its device, and its process group (none at ``dp = 1``).
``DataGroup.all_gather`` concatenates every rank's ``[L, ...]`` tensor
into ``[P, ...]`` in shard order; the executors' only collective.

The backend follows the ranks' devices, chosen explicitly: ``nccl`` when
every rank has its own card, ``gloo`` otherwise (the CPU, or several ranks
on one card; on a card the group copies each operand to the host and the
result back, as gloo needs). A failed collective raises.

``launch_ranks(fn, dp, device, kwargs)`` runs ``fn(**kwargs)`` on ``dp``
ranks (``torch.multiprocessing``, spawned), joined through a file
rendezvous in a fresh temporary directory: rank ``r`` runs on ``cuda:r``
where there are ``dp`` cards, on the one card otherwise, or on the CPU.
It returns rank 0's result; the drivers' ``--dp`` goes through it, so one
command serves or trains on all ranks.

``plan_elastic_mesh`` is the reference's planner. ``data_only=True``:
after failures every survivor is a rank and the logical shards refold
(``shards_per_rank = P // dp``). Otherwise the LM plans: a ``("data",
"model")`` (or ``("pod", "data", "model")``) shape that keeps the
model-parallel degree and shrinks the data axis. Nothing in the port runs
a model axis above 1 yet (``ROADMAP.md`` §1, the mesh / partitioning
item): the LM training driver refuses such a plan.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Optional, Tuple

import torch
import torch.distributed as tdist


def rank_device(rank: int, dp: int, device=None) -> torch.device:
    """Where rank ``rank`` of ``dp`` runs: ``cuda:rank`` when there are
    ``dp`` cards, else the one card ``device`` names; a CPU device stays
    the CPU. ``None`` means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if torch.cuda.device_count() >= dp > 1:
        return torch.device("cuda", rank)
    return torch.device("cuda", dev.index or 0)


def choose_backend(dp: int, device=None) -> str:
    """``nccl`` when every one of the ``dp`` ranks has its own card,
    ``gloo`` otherwise."""
    devs = {rank_device(r, dp, device) for r in range(dp)}
    if all(d.type == "cuda" for d in devs) and len(devs) == dp:
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True, eq=False)
class DataGroup:
    """This process's place in the data-parallel group."""

    dp: int
    rank: int
    device: torch.device
    backend: Optional[str] = None     # None at dp = 1
    pg: object = None                 # the torch.distributed group

    @property
    def key(self) -> tuple:
        """Joins the executors' keys: what the group makes of a step."""
        return (self.dp, self.rank, str(self.device), self.backend)

    def num_local(self, num_shards: int) -> int:
        """Logical shards per rank (elastic folding): ``L = P / dp``."""
        if num_shards % self.dp:
            raise ValueError(
                f"{num_shards} shards cannot fold onto {self.dp} ranks "
                f"(need num_shards % dp == 0)")
        return num_shards // self.dp

    def shards(self, num_shards: int) -> Tuple[int, ...]:
        """The shards this rank runs, in shard order."""
        n = self.num_local(num_shards)
        return tuple(range(self.rank * n, (self.rank + 1) * n))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``[L, ...]`` ``t`` concatenated in rank (= shard)
        order: ``[P, ...]`` on ``t``'s device. At ``dp = 1`` it is ``t``."""
        if self.dp == 1:
            return t
        src = t.contiguous()
        if self.backend == "gloo" and src.device.type == "cuda":
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(self.dp)]
        tdist.all_gather(out, src, group=self.pg)
        return torch.cat(out).to(t.device)


def make_data_mesh(num_devices: Optional[int] = None,
                   device=None) -> DataGroup:
    """This process's ``DataGroup`` over ``num_devices`` ranks (``None``:
    the world size, 1 without ``torch.distributed``). At ``dp = 1`` there
    is no process group; at ``dp > 1`` ``torch.distributed`` must be
    initialized with world size ``dp`` (``launch_ranks`` does it).
    ``device`` is this rank's device (``None``: ``rank_device``)."""
    ready = in_ranks()
    world = tdist.get_world_size() if ready else 1
    dp = world if num_devices is None else int(num_devices)
    if dp <= 0:
        raise ValueError("data group needs at least one rank")
    if dp == 1:
        return DataGroup(dp=1, rank=0, device=torch.device(
            "cuda" if device is None else device))
    if not ready or world != dp:
        raise ValueError(
            f"dp={dp} needs torch.distributed initialized with world size "
            f"{dp} (got {world if ready else 'none'}); the drivers start "
            f"their ranks through launch.mesh.launch_ranks")
    rank = tdist.get_rank()
    dev = rank_device(rank, dp) if device is None else torch.device(device)
    return DataGroup(dp=dp, rank=rank, device=dev,
                     backend=tdist.get_backend(), pg=tdist.group.WORLD)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    used_devices: int
    dropped_devices: int

    @property
    def dp_degree(self) -> int:
        mp = self.shape[-1] if self.axes[-1] == "model" else 1
        return self.used_devices // mp


def plan_elastic_mesh(surviving: int, model_parallel: int = 16,
                      pods: int = 1, data_only: bool = False) -> ElasticPlan:
    """Largest usable mesh after failures, as the reference plans it.

    ``data_only=True``: a 1-D ``("data",)`` group of every survivor (the
    logical graph shards refold onto them). Otherwise the model-parallel
    degree is preserved (a TP group that loses one device loses its shard
    of every weight) and the data axis shrinks to ``surviving //
    model_parallel``; the remaining devices idle. The trailing ``"model"``
    axis stays even at ``model_parallel=1``. Fewer survivors than one TP
    group raise ``ValueError``."""
    if data_only:
        if model_parallel != 1 or pods > 1:
            raise ValueError("data_only plans have no model/pod axes")
        if surviving < 1:
            raise ValueError(f"no surviving device ({surviving}); cannot "
                             f"form a data group")
        return ElasticPlan(shape=(surviving,), axes=("data",),
                           used_devices=surviving, dropped_devices=0)
    if surviving < model_parallel:
        raise ValueError(
            f"fewer surviving devices ({surviving}) than one TP group "
            f"({model_parallel}); cannot form a mesh")
    dp = surviving // model_parallel
    used = dp * model_parallel
    if pods > 1 and dp % pods == 0:
        shape = (pods, dp // pods, model_parallel)
        axes = ("pod", "data", "model")
    else:
        shape = (dp, model_parallel)
        axes = ("data", "model")
    return ElasticPlan(shape=shape, axes=axes, used_devices=used,
                       dropped_devices=surviving - used)


def in_ranks() -> bool:
    """True inside the ranks ``launch_ranks`` started (``torch.distributed``
    initialized)."""
    return tdist.is_available() and tdist.is_initialized()


# ---------------------------------------------------------------------------
# the ranks of one command
# ---------------------------------------------------------------------------
def _quiet(*_a, **_k):
    pass


def _rank_main(rank, fn, dp, device, init, out_dir, kwargs, timeout_s):
    dev = rank_device(rank, dp, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend=choose_backend(dp, device), init_method=init,
        world_size=dp, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(**kwargs, device=str(dev),
                 log=print if rank == 0 else _quiet)
        if rank == 0:
            with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()


def launch_ranks(fn, dp: int, device=None, kwargs=None,
                 timeout_s: float = 1800.0):
    """``fn(**kwargs, device=<rank's device>, log=<print on rank 0>)`` on
    ``dp`` spawned ranks joined by ``torch.distributed`` (the backend from
    ``choose_backend``, a file rendezvous in a fresh temporary directory).
    Returns rank 0's result (it must pickle). A rank that raises fails
    the call; ranks still running after ``timeout_s`` are terminated and
    the call raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    if dp < 2:
        raise ValueError("launch_ranks starts 2 or more ranks")
    out_dir = tempfile.mkdtemp(prefix="repro_torch-ranks-")
    try:
        init = "file://" + os.path.join(out_dir, "rendezvous")
        ctx = mp.spawn(_rank_main, args=(fn, dp, device, init, out_dir,
                                         dict(kwargs or {}), timeout_s),
                       nprocs=dp, join=False)
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{dp} ranks still running after "
                                   f"{timeout_s:g} s")
        with open(os.path.join(out_dir, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
