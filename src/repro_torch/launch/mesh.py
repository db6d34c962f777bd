"""The port's meshes of ranks, and the launcher that starts them (the
port's counterpart of ``repro.launch.mesh``).

Where the reference builds a device mesh for ``jit`` / ``shard_map``, the
port has one process per rank, joined by ``torch.distributed``.

* ``make_mesh(shape, axes)`` is the port's ``jax.make_mesh``: this
  process's ``RankMesh`` over ``prod(shape)`` ranks, laid out row-major
  with the last axis (``"model"``) fastest, as ``jax.make_mesh`` lays out
  devices (rank = ``d * tp + m`` on ``("data", "model")``). It carries the
  axis sizes, this rank's coordinate, its device and one process group per
  set of axes (the ranks that share every other coordinate), and the
  collectives the LM run time uses: ``all_reduce`` (sum or max),
  ``all_gather``, ``all_to_all``, and the autograd-aware pairs, each
  backward the forward's transpose: ``copy_to`` (Megatron's f; gradient
  all-reduced), ``reduce_from`` (g: a sum in fp32, or in the model dtype
  on v-D's wire; identity backward), ``gather_from`` (gradient
  reduce-scattered: for consumers whose gradients are partial),
  ``gather_replicated`` (gradient sliced: for replicated consumers),
  ``slice_to`` (this rank's piece; gradient all-gathered),
  ``reduce_scatter_from`` (gradient all-gathered) and ``exchange`` (an
  all-to-all; gradient the reverse all-to-all); for the pipeline over
  ``pod``, ``send_recv`` (a ring shift along one axis, gloo ``isend`` /
  ``irecv``) and ``broadcast`` (one position's tensor to every rank of an
  axis). A reduce-scatter is an
  all-reduce of which the rank keeps its piece (gloo's reduce-scatter is
  not used). The rules of ``launch/partitioning.py`` read only its
  ``axis_names`` and ``shape``.
  A mesh of one rank needs no process group.
* ``make_production_mesh(multi_pod)`` gives the reference's ``(16, 16)``
  and ``(2, 16, 16)`` shapes as a ``MeshShape``, touching no device.
* ``make_data_mesh(dp)`` returns this process's ``DataGroup`` (the RGNN
  data parallelism of ``dist/``): ``dp``, its rank, the graph shards it
  runs (``L = P / dp`` of them, contiguous in shard order: rank ``r`` runs
  shards ``[r * L, (r + 1) * L)``), its device, and its process group
  (none at ``dp = 1``). ``DataGroup.all_gather`` concatenates every rank's
  ``[L, ...]`` tensor into ``[P, ...]`` in shard order; the executors'
  only collective.

The backend follows the ranks' devices, chosen explicitly: ``nccl`` when
every rank has its own card, ``gloo`` otherwise (the CPU, or several ranks
on one card; on a card each operand is copied to pinned host memory and
the result back, as gloo needs; the ranks of one launch talk over the
loopback). NCCL is unverified: the port has run on one card only. A
failed collective raises.

``launch_ranks(fn, n, device, kwargs)`` runs ``fn(**kwargs)`` on ``n``
ranks (``torch.multiprocessing``, spawned), joined through a file
rendezvous in a fresh temporary directory: rank ``r`` runs on ``cuda:r``
where there are ``n`` cards, on the one card otherwise, or on the CPU.
It returns rank 0's result; the drivers' ``--dp`` / ``--model-parallel``
go through it, so one command serves or trains on all ranks. The ranks
split the host's cores between them (intra-op threads).

``plan_elastic_mesh`` is the reference's planner. ``data_only=True``:
after failures every survivor is a rank and the logical shards refold
(``shards_per_rank = P // dp``). Otherwise the LM plans: a ``("data",
"model")`` (or ``("pod", "data", "model")``) shape that keeps the
model-parallel degree and shrinks the data axis.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import itertools
import time
from typing import Dict, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# the LM's mesh of ranks
# ---------------------------------------------------------------------------
def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _host(t: torch.Tensor, backend: Optional[str]) -> torch.Tensor:
    """The operand as the backend takes it, in storage of its own: gloo on
    a card stages it through pinned host memory."""
    if backend == "gloo" and t.device.type == "cuda":
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)
    return t.clone(memory_format=torch.contiguous_format)


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """This process's place in a mesh of ranks: ``axis_names`` and
    ``shape`` (as the rules read them), its ``rank``, its ``coord`` on
    every axis, its ``device``, the backend, and one process group per set
    of axes (keyed by the axes in mesh order; none on one rank)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: Optional[str] = None
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return _prod(self.sizes)

    @property
    def coord(self) -> Dict[str, int]:
        out, r = {}, self.rank
        for a, n in reversed(tuple(zip(self.axis_names, self.sizes))):
            out[a] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group_size(self, axes) -> int:
        return _prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's position among the ranks of ``axes`` (row-major)."""
        i, c = 0, self.coord
        for a in self._axes(axes):
            i = i * self.shape[a] + c[a]
        return i

    # ------------------------------------------------------------ collectives
    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"):
        """``t`` reduced (``"sum"`` / ``"max"``) over the ranks of
        ``axes``; a new tensor on ``t``'s device (``t`` itself on one
        rank)."""
        axes = self._axes(axes)
        if self.group_size(axes) == 1:
            return t
        buf = _host(t.detach(), self.backend)
        tdist.all_reduce(buf, op={"sum": tdist.ReduceOp.SUM,
                                  "max": tdist.ReduceOp.MAX}[op],
                         group=self.groups[axes])
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axes, dim: int):
        """Every rank of ``axes``' ``t`` concatenated along ``dim`` in
        their order."""
        axes = self._axes(axes)
        n = self.group_size(axes)
        if n == 1:
            return t
        src = _host(t.detach(), self.backend)
        out = [torch.empty_like(src) for _ in range(n)]
        tdist.all_gather(out, src, group=self.groups[axes])
        return torch.cat(out, dim=dim).to(t.device)

    def local(self, t: torch.Tensor, axes, dim: int):
        """This rank's piece of ``t`` split over ``axes`` along ``dim``."""
        n = self.group_size(axes)
        if n == 1:
            return t
        k = t.shape[dim] // n
        return t.narrow(dim, self.index(axes) * k, k)

    def all_to_all(self, t: torch.Tensor, axes):
        """``t``'s dimension 0 in equal chunks, chunk ``j`` sent to the
        rank at position ``j`` of ``axes``: the chunks received, in the
        senders' order (``t`` itself on one rank)."""
        axes = self._axes(axes)
        if self.group_size(axes) == 1:
            return t
        src = _host(t.detach(), self.backend)
        out = torch.empty_like(src)
        tdist.all_to_all_single(out, src, group=self.groups[axes])
        return out.to(t.device)

    def rank_at(self, axis: str, position: int) -> int:
        """The global rank that shares this rank's coordinates but sits at
        ``position`` on ``axis``."""
        coord = dict(self.coord, **{axis: position % self.shape[axis]})
        r = 0
        for a, n in zip(self.axis_names, self.sizes):
            r = r * n + coord[a]
        return r

    def send_recv(self, t: torch.Tensor, axis: str, shift: int = 1):
        """``t`` sent to the rank ``shift`` places on along ``axis`` (a
        ring); what the rank ``shift`` places back sent, on ``t``'s device
        (``t`` itself on one rank)."""
        n = self.group_size(axis)
        if n == 1:
            return t
        i = self.coord[axis]
        src = _host(t.detach(), self.backend)
        out = torch.empty_like(src)
        group = self.groups[(axis,)]
        reqs = [tdist.isend(src, self.rank_at(axis, i + shift), group=group),
                tdist.irecv(out, self.rank_at(axis, i - shift), group=group)]
        for r in reqs:
            r.wait()
        return out.to(t.device)

    def broadcast(self, t: torch.Tensor, axis: str, position: int):
        """The tensor of the rank at ``position`` on ``axis``, on every rank
        of that axis (``t``'s shape and dtype; ``t`` itself on one rank)."""
        if self.group_size(axis) == 1:
            return t
        buf = _host(t.detach(), self.backend)
        tdist.broadcast(buf, self.rank_at(axis, position),
                        group=self.groups[(axis,)])
        return buf.to(t.device)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int):
        """The sum of ``t`` over ``axes``, this rank's piece along
        ``dim`` (an all-reduce, then the piece)."""
        if self.group_size(axes) == 1:
            return t
        return self.local(self.all_reduce(t, axes), axes, dim).contiguous()

    def copy_to(self, x: torch.Tensor, axes):
        """Identity forward; the gradient summed over ``axes`` (in fp32,
        cast back)."""
        if self.group_size(axes) == 1 or not x.requires_grad:
            return x
        return _CopyTo.apply(x, self, axes)

    def reduce_from(self, x: torch.Tensor, axes, dtype=None,
                    wire=torch.float32):
        """The sum over ``axes`` in ``wire``'s dtype (fp32 by default),
        cast to ``dtype`` (default ``x``'s); identity backward."""
        dtype = dtype or x.dtype
        if self.group_size(axes) == 1:
            return x.to(dtype)
        return _ReduceFrom.apply(x.to(wire), self, axes).to(dtype)

    def reduce_scatter_from(self, x: torch.Tensor, axes, dim: int,
                            dtype=None, wire=torch.float32):
        """``reduce_from``'s sum, this rank's piece along ``dim``; the
        gradient all-gathered."""
        dtype = dtype or x.dtype
        if self.group_size(axes) == 1:
            return x.to(dtype)
        return _ReduceScatter.apply(x.to(wire), self, axes, dim).to(dtype)

    def gather_from(self, x: torch.Tensor, axes, dim: int):
        """All-gather along ``dim``; the gradient reduce-scattered back
        (every rank's consumer contributes part of it)."""
        if self.group_size(axes) == 1:
            return x
        return _GatherFrom.apply(x, self, axes, dim)

    def gather_replicated(self, x: torch.Tensor, axes, dim: int):
        """All-gather along ``dim``; the gradient sliced back (every rank
        holds the same whole gradient)."""
        if self.group_size(axes) == 1:
            return x
        return _GatherReplicated.apply(x, self, axes, dim)

    def slice_to(self, x: torch.Tensor, axes, dim: int):
        """This rank's piece of ``x`` along ``dim`` (storage of its own);
        the gradient all-gathered."""
        if self.group_size(axes) == 1:
            return x
        return _SliceTo.apply(x, self, axes, dim)

    def exchange(self, x: torch.Tensor, axes):
        """``all_to_all`` under autograd: the gradient goes back by the
        reverse all-to-all (the same exchange)."""
        if self.group_size(axes) == 1:
            return x
        return _Exchange.apply(x, self, axes)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.float(), ctx.axes).to(g.dtype), None, \
            None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axes, ctx.dim), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g.float(), ctx.axes, ctx.dim).to(
            g.dtype), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.local(g, ctx.axes, ctx.dim).contiguous(), None, \
            None, None


class _SliceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.local(x, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axes, ctx.dim), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axes), None, None


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> RankMesh:
    """This process's ``RankMesh`` over ``shape`` / ``axes`` (the port's
    ``jax.make_mesh``). One rank needs no ``torch.distributed``; more need
    it initialized with world size ``prod(shape)`` (``launch_ranks`` does
    it), and every rank must call this in the same order (it makes the
    process groups). ``device`` is this rank's device (``None``:
    ``rank_device``)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    n = _prod(shape)
    if n == 1:
        return RankMesh(axes, shape, 0, torch.device(
            "cuda" if device is None else device))
    ready = in_ranks()
    world = tdist.get_world_size() if ready else None
    if world != n:
        raise ValueError(
            f"mesh shape {shape} needs torch.distributed initialized with "
            f"world size {n} (got {world or 'none'}); the drivers start "
            f"their ranks through launch.mesh.launch_ranks")
    rank = tdist.get_rank()
    dev = rank_device(rank, n) if device is None else torch.device(device)
    coords = [dict(zip(axes, c)) for c in itertools.product(
        *(range(k) for k in shape))]       # row-major: coords[r] is rank r's
    groups = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, k):
            rest = [a for a in axes if a not in sub]
            classes: Dict[tuple, list] = {}
            for r, c in enumerate(coords):
                classes.setdefault(tuple(c[a] for a in rest), []).append(r)
            for ranks in classes.values():    # every rank makes every group
                pg = tdist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[sub] = pg
    return RankMesh(axes, shape, rank, dev, tdist.get_backend(), groups)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production shapes, as axis names and sizes only:
    ``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")``."""
    from repro_torch.launch.partitioning import MeshShape
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


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


def _rank_main(rank, fn, n, device, init, out_dir, kwargs, timeout_s):
    if os.path.exists("/sys/class/net/lo"):
        # every rank runs on this host: gloo's pairs over the loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # the ranks share this host's cores (a lower setting stays)
    torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                     len(os.sched_getaffinity(0)) // n)))
    dev = rank_device(rank, n, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend=choose_backend(n, device), init_method=init,
        world_size=n, rank=rank,
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


def launch_ranks(fn, n: int, device=None, kwargs=None,
                 timeout_s: float = 1800.0):
    """``fn(**kwargs, device=<rank's device>, log=<print on rank 0>)`` on
    ``n`` spawned ranks joined by ``torch.distributed`` (the backend from
    ``choose_backend``, a file rendezvous in a fresh temporary directory).
    Returns rank 0's result (it must pickle). A rank that raises fails
    the call; ranks still running after ``timeout_s`` are terminated and
    the call raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    if n < 2:
        raise ValueError("launch_ranks starts 2 or more ranks")
    out_dir = tempfile.mkdtemp(prefix="repro_torch-ranks-")
    try:
        init = "file://" + os.path.join(out_dir, "rendezvous")
        ctx = mp.spawn(_rank_main, args=(fn, n, device, init, out_dir,
                                         dict(kwargs or {}), timeout_s),
                       nprocs=n, join=False)
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{n} ranks still running after "
                                   f"{timeout_s:g} s")
        with open(os.path.join(out_dir, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
