"""Sharding rules: params (TP + size-gated FSDP), optimizer state (ZeRO-1),
activations (logical names), batches and KV caches, per architecture and
per shape cell (the port's copy of ``repro.launch.partitioning``), and the
port's run-time decision for every leaf.

Strategy (the reference's):
  * TP over "model": attention heads / FFN hidden / vocab / SSM inner
    channels / MoE experts (EP when E % tp == 0, expert-internal TP
    otherwise). Archs whose head counts don't divide TP fall back per-tensor
    (e.g. Gemma H=8 -> shard head_dim; KV heads < tp -> replicate KV, the
    standard Megatron GQA duplication).
  * FSDP over "data" for any parameter above a size threshold; ZeRO-1 =
    same rule with a ~1 MiB threshold applied to the f32 Adam moments.
  * Batch over ("pod","data") when divisible; the B=1 decode cell shards
    the KV cache over sequence instead (context parallelism).

The rules are pure functions of axis names and sizes: ``mesh`` is anything
with ``axis_names`` and a ``shape`` mapping (``MeshShape``, or the
``RankMesh`` of ``launch/mesh.py``), so they run with no process group.
A spec is the port's ``PartitionSpec``: one entry a dimension, each an
axis name, a tuple of names or ``None`` (a one-name tuple is stored as the
name, as JAX stores it). Path strings are built as the reference's
``_tree_specs`` builds them (``params/stages/0/l0/attn/wq``), over the
port's trees (dicts, lists, ``TrainState``).

**The run time** (``plan``, ``cache_plan``; the default flags). Each leaf
is stored as exactly its shard. Where the rules put ``model`` on the
dimension that a Megatron pair splits its math on, the rank computes on its
shard (``"split"``): ``wq`` / ``wk`` / ``wv`` -> ``wo`` over heads,
``w_gate`` / ``w_up`` -> ``w_down`` over the FFN width, ``embed`` and
``lm_head`` over the vocabulary. KV heads that ``tp`` does not divide are
used whole by every rank (each attends with the KV heads its query heads
group with) and their gradient is summed over ``model`` (``"partial"``),
as is that of the qk-norms inside a split attention. Every other sharded
dimension is gathered before use (``"gather"``: FSDP over ``data``, the
``head_dim`` fallbacks, replicated attention when ``H % tp != 0``, the MoE
experts, the SSM channels, the encoder, ``frontend_proj``, caches sharded
on anything but the batch or the split KV heads) and its gradient sliced
back. The batch runs split over ``batch_dims(B)``; where that is ``None``
every rank runs the whole batch.

**The perf variants** (``Run``: what a step takes at its shapes, decided
once a step call by ``run_for``, where the reference decides in the
layers). ``moe_ep`` (v-B): where the reference takes its EP branch
(``ep_dup``), the expert stacks are used as stored, ``"ep"``: each rank
runs its ``E / tp`` experts on the tokens an all-to-all brings it (FSDP
over ``data`` still gathered); with fewer experts than ranks (``dup``
copies of each) they are gathered whole over ``model`` and each copy's
gradient summed (``"partial"``); the router's gradient is summed over
``model`` (each rank routes its own slice of the tokens). Elsewhere the
dense dispatch runs on gathered experts, as the reference falls back.
``seq_shard_kv_decode`` (v-C, decode only, a cache length ``tp``
divides): the self-attention cache is used split on the sequence, every
rank attends with every head and ``wo`` splits on heads where it is
stored so; ``wq`` / ``wk`` / ``wv`` project
the heads they hold, split as stored, and the step's q, k and v are
all-gathered over heads. ``seq_shard_activations`` (v-E,
where the reference's ``"activation"`` spec puts ``model`` on the
sequence): the token stream between blocks is the rank's slice of the
sequence, and the norms applied to it sum their gradients over
``model``. ``bf16_reduce`` (v-D) changes no plan: ``rp_einsum``'s
partial sums ride the wire in the model dtype. On one rank every flag is
the identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.lm.config import LMConfig


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else (e if e else None)
    return e


class PartitionSpec(tuple):
    """A spec: one entry a dimension (an axis name, a tuple of names, or
    ``None``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_norm_entry(e) for e in entries))

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The axes of dimension ``dim`` (``()`` when replicated)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return e if isinstance(e, tuple) else (e,)

    def all_axes(self) -> Tuple[str, ...]:
        return tuple(a for d in range(len(self)) for a in self.axes(d))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes only: the rules' mesh (the port's
    ``AbstractMesh``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return _prod(self.sizes)


def shard_shape(mesh, spec: PartitionSpec, shape) -> Tuple[int, ...]:
    """The local shape of a ``shape`` tensor stored under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        k = _prod(mesh.shape[a] for a in spec.axes(d))
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} ({n}) does "
                             f"not split {k} ways ({spec})")
        out.append(n // k)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return shard_shape(self.mesh, self.spec, shape)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _path_str(kp) -> str:
    return "/".join(str(k) for k in kp)


def tree_paths(tree, prefix=()):
    """``(path tuple, leaf)`` for every leaf of a port tree (dicts in
    sorted key order, lists, ``TrainState``'s fields; a spec is a
    leaf)."""
    from repro_torch.optim.adamw import TrainState
    if isinstance(tree, TrainState):
        for name in ("params", "mu", "nu", "step"):
            yield from tree_paths(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                            PartitionSpec):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def map_with_path(fn, tree):
    """``tree``'s structure with ``fn(path_str, leaf)`` at every leaf."""
    from repro_torch.optim.adamw import tree_like
    return tree_like(tree, [fn(_path_str(kp), leaf)
                            for kp, leaf in tree_paths(tree)])


# the Megatron pairs: the (unstacked) dimension each leaf splits its math on
_SPLIT_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "embed": 0, "lm_head": 1}
_DENSE_MLP_DIM = {"w_gate": 1, "w_up": 1, "w_down": 0}
# the norms of the token stream (v-E: applied to the rank's slice of it)
_STREAM_NORMS = ("norm", "mlp_norm", "cross_norm", "final_norm")
_EXPERTS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class Run:
    """The perf variants one step call takes at its shapes: ``ep`` the
    copies of each expert on v-B's EP branch (0: the dense dispatch),
    ``seq`` v-E's split token stream, ``kv_seq`` v-C's decode over the
    sequence-split cache."""

    ep: int = 0
    seq: bool = False
    kv_seq: bool = False


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """What the run time does with one leaf: ``spec`` is how it is stored;
    ``model`` is ``"split"`` (the math runs on the shard), ``"gather"``
    (gathered over ``model`` before use, gradient sliced back),
    ``"partial"`` (used whole, gradient summed over ``model``) or
    ``"whole"``; ``use`` is the spec the math sees (``model`` on the split
    dimension, nothing else: every other sharded dimension is gathered)."""

    spec: PartitionSpec
    model: str
    use: PartitionSpec

    @property
    def gathered(self) -> Tuple[int, ...]:
        """The dimensions gathered before use."""
        return tuple(d for d in range(len(self.spec))
                     if self.spec.axes(d) and not self.use.axes(d))


@dataclasses.dataclass
class Partitioner:
    mesh: Any
    cfg: LMConfig
    mode: str = "train"                  # train | prefill | decode
    fsdp_threshold: int = 64 * 2**20     # bytes; params above this get FSDP
    zero_threshold: int = 1 * 2**20      # bytes; moments above this: ZeRO-1
    seq_shard_activations: bool = False  # sequence parallelism (perf v-E)
    # perf iteration flags. Defaults = the reference's tuned config.
    attn_head_sharding_only: bool = True   # v-A: replicate attn when H % tp
    seq_shard_kv_decode: bool = False      # v-C: S-sharded decode cache
    moe_ep: bool = False                   # v-B: EP all-to-all MoE
    bf16_reduce: bool = False              # v-D: bf16 partial-sum collectives

    # ------------------------------------------------------------ axes
    @property
    def tp_axis(self) -> str:
        return "model"

    @property
    def fsdp_axis(self) -> str:
        return "data"

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    @property
    def tp(self) -> int:
        return self.mesh.shape[self.tp_axis]

    @property
    def dp(self) -> int:
        return _prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def data_size(self) -> int:
        return self.mesh.shape[self.fsdp_axis]

    def named(self, spec: PartitionSpec) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    # ------------------------------------------------------------ params
    def _base_param_spec(self, path: str, shape: Tuple[int, ...]) -> list:
        """TP assignment on the *unstacked* shape; returns a mutable list."""
        tp, ax = self.tp, self.tp_axis
        spec: list = [None] * len(shape)
        leaf = path.split("/")[-1]

        def try_axis(*cands):
            for c in cands:
                if shape[c] % tp == 0:
                    spec[c] = ax
                    return True
            return False

        if leaf in ("embed", "lm_head"):
            # vocab TP (padded to a multiple of 128)
            try_axis(0 if leaf == "embed" else 1)
        elif leaf == "frontend_proj":
            try_axis(1)
        elif leaf == "wq":
            if self.attn_head_sharding_only and self.mode != "decode":
                # v-A: H % tp != 0 -> REPLICATE attention, TP only the MLP
                try_axis(1)
            else:
                try_axis(1, 2)                 # heads, else head_dim
        elif leaf in ("wk", "wv"):
            if self.mode == "decode" and not self.seq_shard_kv_decode:
                # decode: KV heads, else head_dim
                try_axis(1, 2)
            else:
                # train/prefill (and v-C decode): KV heads if divisible,
                # else REPLICATE (Megatron GQA duplication)
                try_axis(1)
        elif leaf == "wo":
            if self.attn_head_sharding_only and self.mode != "decode":
                try_axis(0)
            else:
                try_axis(0, 1)
        elif leaf in ("w_gate", "w_up"):
            if len(shape) == 3:                # MoE [E, D, F]: EP else TP
                try_axis(0, 2)
            else:
                try_axis(1)
        elif leaf == "w_down":
            if len(shape) == 3:                # MoE [E, F, D]
                try_axis(0, 1)
            else:
                try_axis(0)
        elif leaf in ("wi_z", "wi_x", "wi_bc", "wi_dt"):
            try_axis(1)
        elif leaf in ("conv_w_x", "conv_w_bc"):
            try_axis(1)
        elif leaf in ("conv_b_x", "conv_b_bc", "gate_norm"):
            try_axis(0)
        # router, norms, A_log / dt_bias / D_skip, scalars: replicate
        if leaf == "wo" and len(shape) == 2:    # mamba out proj [din, D]
            spec[:] = [None] * len(shape)
            try_axis(0)
        return spec

    def _apply_fsdp(self, spec: list, shape: Tuple[int, ...], nbytes: int,
                    threshold: int) -> list:
        if nbytes < threshold:
            return spec
        ds = self.data_size
        # largest unsharded dim divisible by the data axis
        cands = sorted(
            (i for i in range(len(shape))
             if spec[i] is None and shape[i] % ds == 0),
            key=lambda i: -shape[i])
        if cands:
            spec[cands[0]] = self.fsdp_axis
        return spec

    @staticmethod
    def _stacked(path: str) -> bool:
        return path.startswith("stages/") or "/stages/" in path

    def _spec(self, path: str, leaf, itemsize: int, threshold: int):
        shape = tuple(leaf.shape)
        stacked = self._stacked(path)
        inner = shape[1:] if stacked else shape
        spec = self._base_param_spec(path, inner)
        spec = self._apply_fsdp(spec, inner, _prod(shape) * itemsize,
                                threshold)
        if stacked:
            spec = [None] + spec
        return P(*spec)

    def param_spec(self, path: str, leaf) -> PartitionSpec:
        return self._spec(path, leaf, _itemsize(leaf.dtype),
                          self.fsdp_threshold)

    def opt_spec(self, path: str, leaf) -> PartitionSpec:
        """ZeRO-1: moments follow params but with an aggressive FSDP gate."""
        return self._spec(path, leaf, 4, self.zero_threshold)

    def _tree_specs(self, tree, fn) -> Any:
        return map_with_path(lambda p, leaf: self.named(fn(p, leaf)), tree)

    def param_shardings(self, params_tree) -> Any:
        return self._tree_specs(params_tree, self.param_spec)

    def state_shardings(self, state_tree) -> Any:
        """TrainState: params use param rules; mu/nu use ZeRO rules."""
        def fn(path, leaf):
            if path.startswith("mu/") or path.startswith("nu/"):
                return self.opt_spec(path.split("/", 1)[1], leaf)
            if path.startswith("params/"):
                return self.param_spec(path.split("/", 1)[1], leaf)
            return P()
        return self._tree_specs(state_tree, fn)

    # ------------------------------------------------------------ data
    def batch_dims(self, b: int) -> Optional[Tuple[str, ...]]:
        """Mesh axes to shard the batch dim over (None = replicate)."""
        if b % self.dp == 0:
            return self.dp_axes
        if b % self.data_size == 0:
            return (self.fsdp_axis,)
        return None

    def batch_spec(self, shape: Tuple[int, ...]) -> PartitionSpec:
        ba = self.batch_dims(shape[0])
        spec = [ba] + [None] * (len(shape) - 1)
        if ba is None and len(shape) >= 2 and shape[1] % self.data_size == 0:
            spec[1] = self.fsdp_axis       # sequence sharding fallback
        return P(*spec)

    def cache_spec(self, path: str, leaf) -> PartitionSpec:
        """KV / SSM cache sharding. Shapes carry a leading stage-repeat dim."""
        shape = tuple(leaf.shape)
        tp, ds = self.tp, self.data_size
        leaf_name = path.split("/")[-1]
        spec: list = [None] * len(shape)
        if leaf_name in ("k", "v"):
            _, b, s, kv, hd = shape
            ba = self.batch_dims(b)
            if ba is not None:
                spec[1] = ba
            elif s % ds == 0 and not self.seq_shard_kv_decode:
                spec[2] = self.fsdp_axis   # context parallelism (B too small)
            if self.seq_shard_kv_decode and self.mode == "decode" \
                    and s % tp == 0:
                # v-C: sequence-sharded cache (decode only)
                spec[2] = self.tp_axis
            elif kv % tp == 0:
                spec[3] = self.tp_axis
            elif hd % tp == 0:
                spec[4] = self.tp_axis
        elif leaf_name == "conv":
            _, b, k, c = shape
            ba = self.batch_dims(b)
            if ba is not None:
                spec[1] = ba
            if c % tp == 0:
                spec[3] = self.tp_axis
        elif leaf_name == "state":
            _, b, h, p_, n = shape
            ba = self.batch_dims(b)
            if ba is not None:
                spec[1] = ba
            if h % tp == 0:
                spec[2] = self.tp_axis
        return P(*spec)

    def cache_shardings(self, cache_tree) -> Any:
        return self._tree_specs(cache_tree, self.cache_spec)

    # ------------------------------------------------------------ logical
    def logical_resolver(self, batch: Optional[int] = None,
                         seq: Optional[int] = None,
                         cache_len: Optional[int] = None
                         ) -> "LogicalResolver":
        """Resolver installed via ``nn.common.sharding_context``: callable
        (the shape check by logical name) and carrying the mesh / axis
        metadata, the step's ``Run`` and the run-time collectives the
        layers need. ``batch`` / ``seq``: the global batch and token length
        of the step it runs (the shape check needs the batch; the variants
        both); ``cache_len``: a decode's cache length."""
        run = (self.run_for(batch, seq, cache_len)
               if batch is not None and seq is not None else Run())
        return LogicalResolver(self, batch, run)

    # ------------------------------------------------------------ variants
    def ep_dup(self, batch: int, seq: int) -> int:
        """v-B at ``batch`` x ``seq`` tokens: each expert's copies on the
        reference's EP branch (``moe_ep``, ``E % tp == 0`` or ``tp % E ==
        0``, a sharded batch, ``tp`` dividing the rank's tokens:
        ``repro/nn/moe.py:57-62``, ``:163-164``); 0 where it falls back to
        the dense dispatch."""
        e, tp = self.cfg.num_experts, self.tp
        if not (self.moe_ep and e and (e % tp == 0 or tp % e == 0)):
            return 0
        dpb = self.batch_dims(batch)
        if dpb is None or (batch // _prod(self.mesh.shape[a] for a in dpb)
                           * seq) % tp:
            return 0
        return 1 if e % tp == 0 else tp // e

    def seq_split(self, batch: int, seq: int) -> bool:
        """v-E: whether the ``[batch, seq, D]`` token stream runs split
        over ``model`` on the sequence (the reference's ``"activation"``
        spec puts ``model`` there)."""
        if not self.seq_shard_activations or self.tp == 1:
            return False
        spec = self._resolve_fn()("activation",
                                  (batch, seq, self.cfg.d_model))
        return spec[1] == self.tp_axis

    def kv_seq_split(self, cache_len: int) -> bool:
        """v-C: whether a decode attends over a cache of ``cache_len``
        split over ``model`` on the sequence (``cache_spec``'s rule)."""
        return (self.seq_shard_kv_decode and self.mode == "decode"
                and self.tp > 1 and cache_len % self.tp == 0)

    def run_for(self, batch: int, seq: int,
                cache_len: Optional[int] = None) -> Run:
        """The variants a step of ``batch`` x ``seq`` tokens (a decode's:
        one token against ``cache_len``) takes."""
        return Run(ep=self.ep_dup(batch, seq),
                   seq=self.seq_split(batch, seq),
                   kv_seq=(cache_len is not None and seq == 1
                           and self.kv_seq_split(cache_len)))

    def _resolve_fn(self):
        tp, ax = self.tp, self.tp_axis
        ds, fa = self.data_size, self.fsdp_axis

        def resolve(name: str, shape) -> Optional[PartitionSpec]:
            spec: list = [None] * len(shape)
            if name == "activation":            # [B, S, D]
                ba = self.batch_dims(shape[0])
                if ba is not None:
                    spec[0] = ba
                elif shape[1] % ds == 0:
                    spec[1] = fa
                if self.seq_shard_activations and spec[1] is None \
                        and shape[1] % tp == 0 and shape[1] > 1:
                    spec[1] = ax
            elif name == "kv":                  # [B, S, KV, hd]
                ba = self.batch_dims(shape[0])
                if ba is not None:
                    spec[0] = ba
                elif shape[1] % ds == 0:
                    spec[1] = fa
                if shape[2] % tp == 0:
                    spec[2] = ax
                elif shape[3] % tp == 0:
                    spec[3] = ax
            elif name == "ffn_hidden":          # [B, S, F]
                ba = self.batch_dims(shape[0])
                if ba is not None:
                    spec[0] = ba
                if shape[-1] % tp == 0:
                    spec[-1] = ax
            elif name == "attn_out_heads":      # [B, Q, H, hd]
                ba = self.batch_dims(shape[0])
                if ba is not None:
                    spec[0] = ba
                if shape[2] % tp == 0:
                    spec[2] = ax
                elif shape[3] % tp == 0:
                    spec[3] = ax
            elif name == "ssm_heads":           # [B, L, nh, hd]
                ba = self.batch_dims(shape[0])
                if ba is not None:
                    spec[0] = ba
                if shape[2] % tp == 0:
                    spec[2] = ax
            elif name == "moe_dispatch":        # [E, C, D]
                if shape[0] % tp == 0:
                    spec[0] = ax
                if shape[1] % self.dp == 0:
                    spec[1] = self.dp_axes
            elif name == "moe_hidden":          # [E, C, F]
                if shape[0] % tp == 0:
                    spec[0] = ax
                elif shape[2] % tp == 0:
                    spec[2] = ax
                if shape[1] % self.dp == 0:
                    spec[1] = self.dp_axes
            else:
                return None
            return P(*spec)

        return resolve

    # ------------------------------------------------------------ run time
    def _inner(self, name: str) -> Tuple[int, ...]:
        """The unstacked shape of an attention or dense-MLP leaf of this
        config."""
        cfg = self.cfg
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        return {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
                "wo": (h, hd, d), "w_gate": (d, cfg.d_ff),
                "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}[name]

    def _tp_on(self, name: str, dim: int) -> bool:
        spec = self._base_param_spec(name, self._inner(name))
        return spec[dim] == self.tp_axis

    @property
    def attn_split(self) -> bool:
        """Whether attention splits its heads over ``model``: ``wq`` and
        ``wo`` on heads, and every rank's query heads grouping with a
        contiguous run of KV heads (``wk`` / ``wv`` on KV heads, or whole
        and duplicated where ``H / tp`` divides the group size)."""
        cfg = self.cfg
        if self.tp == 1 or not (self._tp_on("wq", 1) and self._tp_on("wo", 0)):
            return False
        if self._tp_on("wk", 1):
            return True
        group = cfg.num_heads // cfg.num_kv_heads
        return group % (cfg.num_heads // self.tp) == 0

    @property
    def kv_split(self) -> bool:
        """Whether a split attention's ``wk`` / ``wv`` (and the KV cache)
        are split over KV heads; else each rank computes every KV head and
        attends with its group's."""
        return self.attn_split and self._tp_on("wk", 1)

    @property
    def mlp_split(self) -> bool:
        """Whether the dense MLP splits its width over ``model``."""
        return (self.tp > 1 and self.cfg.d_ff > 0 and self._tp_on("w_gate", 1)
                and self._tp_on("w_down", 0))

    @property
    def vocab_split(self) -> bool:
        """Whether ``embed`` (and ``lm_head``, or the tied head) split the
        (padded) vocabulary over ``model``."""
        vp = -(-self.cfg.vocab_size // 128) * 128
        return self.tp > 1 and vp % self.tp == 0

    def _model_use(self, path: str, spec: list,
                   run: Run) -> Tuple[str, Optional[int]]:
        """``(decision, split dim)`` over ``model`` for one leaf."""
        parts = path.split("/")
        leaf = parts[-1]
        on_model = self.tp_axis in spec
        block = parts[-2] if len(parts) > 1 else ""
        if run.seq and leaf in _STREAM_NORMS and parts[0] != "encoder":
            return "partial", None
        if run.ep and block == "moe":
            if leaf == "router":
                return "partial", None
            if leaf in _EXPERTS:
                return ("ep", 0) if run.ep == 1 else ("partial", None)
        if run.kv_seq and block in ("attn", "cross"):
            dim = _SPLIT_DIM.get(leaf)
            if dim is not None and spec[dim] == self.tp_axis:
                return "split", dim
            return ("gather" if on_model else "whole"), None
        if block in ("attn", "cross") and self.attn_split:
            if leaf in ("wq", "wo"):
                return "split", _SPLIT_DIM[leaf]
            if leaf in ("wk", "wv"):
                return (("split", 1) if self.kv_split else ("partial", None))
            if leaf in ("q_norm", "k_norm"):
                return "partial", None
        if block == "mlp" and leaf in _DENSE_MLP_DIM and self.mlp_split:
            return "split", _DENSE_MLP_DIM[leaf]
        if leaf in ("embed", "lm_head") and on_model \
                and spec[_SPLIT_DIM[leaf]] == self.tp_axis:
            return "split", _SPLIT_DIM[leaf]
        return ("gather" if on_model else "whole"), None

    def plan(self, path: str, leaf, run: Run = Run()) -> LeafPlan:
        """The run-time decision for parameter ``path`` in a step taking
        ``run``: its stored spec, split / ep / gather / partial / whole
        over ``model``, and the spec the math sees."""
        spec = self.param_spec(path, leaf)
        stacked = self._stacked(path)
        model, dim = self._model_use(path, list(spec)[stacked:], run)
        use = [None] * len(spec)
        if dim is not None:
            use[dim + stacked] = self.tp_axis
        return LeafPlan(spec, model, P(*use))

    def cache_plan(self, path: str, leaf, run: Run = Run()) -> LeafPlan:
        """A cache leaf's stored spec and the spec the layers see: the
        batch's axes, and ``model`` on the KV heads of a KV-split
        attention or (v-C) on the sequence of a self-attention cache;
        everything else gathered (and written back)."""
        spec = self.cache_spec(path, leaf)
        use = [None] * len(spec)
        use[1] = spec[1]
        parts = path.split("/")
        model = "gather" if self.tp_axis in spec.all_axes() else "whole"
        if parts[-1] in ("k", "v"):
            if run.kv_seq:
                if parts[-2] == "attn" and spec[2] == self.tp_axis:
                    use[2], model = self.tp_axis, "split"
            elif spec[3] == self.tp_axis and self.kv_split:
                use[3], model = self.tp_axis, "split"
        return LeafPlan(spec, model, P(*use))


class LogicalResolver:
    """Callable sharding resolver + mesh metadata (the reference's
    ``LogicalResolver``). ``spec(name, shape)`` is the reference's
    constraint for a logical tensor of global ``shape``; ``resolver(name,
    x)`` checks that ``x``, a rank's local tensor, has the global shape
    divided by the spec the run time keeps (the batch's axes, and ``model``
    where the math is split), raises on a mismatch and returns ``x``
    itself. On a ``RankMesh`` the resolver also carries the step's
    ``run`` and the run time's collectives (``to_model``,
    ``reduce_model``, ``gather_batch``, the variants')."""

    def __init__(self, part: Partitioner, batch: Optional[int] = None,
                 run: Run = Run()):
        self.part = part
        self._fn = part._resolve_fn()
        self.mesh = part.mesh
        self.cfg = part.cfg
        self.tp_axis = part.tp_axis
        self.tp = part.tp
        self.dp_axes = part.dp_axes
        self.dp = part.dp
        self.batch_dims = part.batch_dims
        self.seq_shard_kv_decode = part.seq_shard_kv_decode
        self.moe_ep = part.moe_ep
        self.bf16_reduce = part.bf16_reduce
        self.batch = batch
        self.run = run
        # v-C attends with every head on every rank: the projections and
        # ``wo`` split as stored, q, k and v are gathered over heads
        self.attn_split = part.attn_split and not run.kv_seq
        self.kv_split = part.kv_split and not run.kv_seq
        self.wo_split = (part._tp_on("wo", 0) if run.kv_seq
                         else self.attn_split)
        self.q_split = run.kv_seq and part._tp_on("wq", 1)
        self.kv_heads_split = run.kv_seq and part._tp_on("wk", 1)
        self.mlp_split = part.mlp_split
        self.vocab_split = part.vocab_split

    def splits(self, leaf: str) -> bool:
        """Whether the math of ``leaf`` (``"wo"``, ``"w_down"``,
        ``"embed"``, ``"lm_head"``) runs split over ``model``."""
        return {"wo": self.wo_split, "w_down": self.mlp_split,
                "embed": self.vocab_split,
                "lm_head": self.vocab_split}[leaf]

    def spec(self, name: str, shape) -> Optional[PartitionSpec]:
        return self._fn(name, tuple(shape))

    # ------------------------------------------------------------ checks
    def _global(self, name: str, local) -> Tuple[int, ...]:
        cfg = self.cfg
        g = list(local)
        if name in ("activation", "kv", "ffn_hidden", "attn_out_heads",
                    "ssm_heads"):
            if self.batch is None:
                raise ValueError(f"shard({name!r}): the resolver has no "
                                 f"global batch (logical_resolver(batch=))")
            g[0] = self.batch
        if name == "activation":
            g[2] = cfg.d_model
        elif name == "kv":
            g[2], g[3] = cfg.num_kv_heads, cfg.resolved_head_dim
        elif name == "attn_out_heads":
            g[2], g[3] = cfg.num_heads, cfg.resolved_head_dim
        elif name == "ffn_hidden":
            g[2] = cfg.d_ff
        elif name == "ssm_heads":
            g[2], g[3] = cfg.ssm_heads, cfg.ssm_head_dim
        elif name in ("moe_dispatch", "moe_hidden"):
            g[0] = cfg.num_experts
        return tuple(g)

    def runtime_spec(self, name: str, spec: PartitionSpec) -> PartitionSpec:
        """The part of the reference's ``spec`` the run time keeps: the
        batch's axes (dimension 0 of the batch-major names) and ``model``
        on the heads of a split attention or the width of a split MLP."""
        keep = [None] * len(spec)
        if name in ("activation", "kv", "ffn_hidden", "attn_out_heads",
                    "ssm_heads"):
            keep[0] = spec[0]
        if name == "attn_out_heads" and self.attn_split:
            keep[2] = spec[2]
        elif name == "kv" and self.kv_split:
            keep[2] = spec[2]
        elif name == "ffn_hidden" and self.mlp_split:
            keep[2] = spec[2]
        return P(*keep)

    def __call__(self, name, x):
        if self._fn(name, tuple(x.shape)) is None:
            return x
        g = self._global(name, x.shape)
        spec = self.spec(name, g)
        want = shard_shape(self.mesh, self.runtime_spec(name, spec), g)
        if tuple(x.shape) != want:
            raise ValueError(
                f"shard({name!r}): local shape {tuple(x.shape)}, expected "
                f"{want} (global {g} under {spec})")
        return x

    # ------------------------------------------------------------ run time
    def to_model(self, x):
        """Megatron's f: identity forward, all-reduce over ``model`` of the
        gradient."""
        return self.mesh.copy_to(x, (self.tp_axis,))

    def reduce_model(self, x, dtype=None, wire=torch.float32):
        """Megatron's g: all-reduce over ``model`` in ``wire``'s dtype
        (identity backward), cast to ``dtype``."""
        return self.mesh.reduce_from(x, (self.tp_axis,), dtype, wire)

    def max_model(self, x):
        """The max over ``model`` (no gradient)."""
        return self.mesh.all_reduce(x.detach(), (self.tp_axis,), op="max")

    # v-E: the token stream split over ``model`` on the sequence (dim 1)
    def seq_slice(self, x):
        """This rank's slice of the sequence; the gradient all-gathered."""
        return self.mesh.slice_to(x, (self.tp_axis,), 1)

    def seq_gather(self, x, partial: bool):
        """The whole sequence from every rank's slice; the gradient
        reduce-scattered where the consumer's is ``partial`` (split over
        ``model``), else sliced."""
        if partial:
            return self.mesh.gather_from(x, (self.tp_axis,), 1)
        return self.mesh.gather_replicated(x, (self.tp_axis,), 1)

    def seq_reduce_scatter(self, x, dtype=None, wire=torch.float32):
        """Row-parallel partial sums summed over ``model``, this rank's
        slice of the sequence kept; the gradient all-gathered."""
        return self.mesh.reduce_scatter_from(x, (self.tp_axis,), 1, dtype,
                                             wire)

    # v-B: the tokens of a data shard, split over ``model``
    def model_slice(self, x, dim: int = 0):
        """This rank's piece over ``model`` along ``dim``; the gradient
        all-gathered (the input is replicated over ``model``)."""
        return self.mesh.slice_to(x, (self.tp_axis,), dim)

    def model_gather(self, x, dim: int = 0):
        """Every model rank's piece along ``dim``; the gradient sliced (the
        consumers are replicated over ``model``)."""
        return self.mesh.gather_replicated(x, (self.tp_axis,), dim)

    def exchange(self, x):
        """An all-to-all over ``model`` of ``x``'s dimension 0 (under
        autograd)."""
        return self.mesh.exchange(x, (self.tp_axis,))

    def gather_model(self, x, dim: int):
        """All-gather over ``model`` along ``dim`` (no gradient)."""
        return self.mesh.all_gather(x, (self.tp_axis,), dim)

    def model_index(self) -> int:
        return self.mesh.index((self.tp_axis,))

    def batch_axes(self) -> Tuple[str, ...]:
        ba = self.batch_dims(self.batch) if self.batch is not None else None
        return tuple(ba or ())

    def gather_batch(self, x):
        """``x``'s local batch rows all-gathered over the batch's axes
        (gradient reduce-scattered back), and a function slicing this
        rank's rows out of a whole-batch tensor."""
        axes = self.batch_axes()
        n = _prod(self.mesh.shape[a] for a in axes)
        if n == 1:
            return x, (lambda y: y)
        i, rows = self.mesh.index(axes), x.shape[0]
        return (self.mesh.gather_from(x, axes, 0),
                lambda y: y[i * rows:(i + 1) * rows])

    def kv_rows(self, num_kv_local: int) -> Tuple[int, int]:
        """The KV heads (``[lo, hi)`` of those the rank computes) that this
        rank's query heads group with."""
        if self.kv_split or not self.attn_split:
            return 0, num_kv_local
        cfg = self.cfg
        hq = cfg.num_heads // self.tp
        group = cfg.num_heads // cfg.num_kv_heads
        lo = self.model_index() * hq // group
        return lo, lo + math.ceil(hq / group)


# ---------------------------------------------------------------------------
# the drivers' flags (the reference's ``launch/dryrun.py`` names)
# ---------------------------------------------------------------------------
VARIANT_FLAGS = (("--moe-ep", "moe_ep", "v-B: expert-parallel MoE dispatch "
                  "(an all-to-all over the model axis)"),
                 ("--seq-shard-kv", "seq_shard_kv_decode",
                  "v-C: sequence-sharded decode KV cache"),
                 ("--bf16-reduce", "bf16_reduce",
                  "v-D: bf16 partial-sum collectives"),
                 ("--seq-shard", "seq_shard_activations",
                  "v-E: sequence-parallel activations"))


def add_variant_flags(ap) -> None:
    """The perf variants' flags on an ``argparse`` parser."""
    for flag, _, text in VARIANT_FLAGS:
        ap.add_argument(flag, action="store_true", help=text)


def variant_kwargs(args) -> Optional[Dict[str, bool]]:
    """The ``Partitioner`` flags the parsed ``args`` set (``None``: none)."""
    out = {name: True for flag, name, _ in VARIANT_FLAGS
           if getattr(args, flag[2:].replace("-", "_"))}
    return out or None


# ---------------------------------------------------------------------------
# the run time's trees, on a RankMesh
# ---------------------------------------------------------------------------
def flat_leaves(tree) -> list:
    """The leaves of a tree of any leaf type (specs, shardings, plans) in
    ``tree_leaves`` order."""
    return [leaf for _, leaf in tree_paths(tree)]


def local_shard(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's shard (a view) of the whole tensor ``t`` under
    ``spec``."""
    for d in range(len(spec)):
        if spec.axes(d):
            t = mesh.local(t, spec.axes(d), d)
    return t


def gather_whole(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's shard ``t`` under ``spec``."""
    for d in range(len(spec)):
        if spec.axes(d):
            t = mesh.all_gather(t, spec.axes(d), d)
    return t


def to_use(t: torch.Tensor, plan: LeafPlan, mesh) -> torch.Tensor:
    """A stored shard gathered over the dimensions its plan gathers."""
    for d in plan.gathered:
        t = mesh.all_gather(t, plan.spec.axes(d), d)
    return t


def from_use(t: torch.Tensor, plan: LeafPlan, mesh) -> torch.Tensor:
    """A tensor of the use's shape sliced back to the stored shard (a view
    where nothing was gathered: ``t`` itself)."""
    for d in plan.gathered:
        t = mesh.local(t, plan.spec.axes(d), d)
    return t


def owned(t: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``t`` in storage of its own when it is a view into ``whole``."""
    return t if t is whole else t.clone()
