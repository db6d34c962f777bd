"""The TuningDecisions table codegen dispatches on (the port's copy of
``repro.tune.decisions``).

Three decision families, mirroring the three layers where the compiler
makes a choice:

* ``ops``      — per lowered op instance (keyed by ``tune/space.py`` keys):
                 tile shape, gather fusion. Consulted at run time by
                 ``codegen._exec_gemm`` / ``_exec_traversal``.
* ``materialization`` — per edge variable of a lowered program: COMPACT vs
                 VANILLA. Consulted at *lowering* time (it changes the
                 plan's gather schemes), keyed per (program, graph).
* ``layout``   — per graph: the kernel-layout tile / node-block shape.

The port's executors run eagerly and read the table at every call, so a
changed table takes effect at the next call; ``fingerprint()`` identifies
a table (the tuner's logs, the cache-replay checks).
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional

from repro_torch.tune.space import variant_from_json


class TuningDecisions:
    def __init__(self,
                 ops: Optional[Dict[str, object]] = None,
                 materialization: Optional[Dict[str, Dict[str, str]]] = None,
                 layout: Optional[Dict[str, Dict[str, int]]] = None):
        self.ops = dict(ops or {})
        self.materialization = dict(materialization or {})
        self.layout = dict(layout or {})
        self._fingerprint: Optional[str] = None

    # -- op decisions ---------------------------------------------------
    def lookup(self, key: str):
        """Variant for one lowered op instance, or None (use defaults)."""
        return self.ops.get(key)

    def set_op(self, key: str, variant) -> None:
        self.ops[key] = variant
        self._fingerprint = None

    # -- materialization / layout ---------------------------------------
    def set_materialization(self, key: str, per_var: Dict[str, str]) -> None:
        self.materialization[key] = dict(per_var)
        self._fingerprint = None

    def compact_vars(self, key: str) -> Optional[frozenset]:
        """The COMPACT-var set recorded for one (program, graph), or None
        when that program was never tuned (lowering keeps its default)."""
        per_var = self.materialization.get(key)
        if per_var is None:
            return None
        return frozenset(v for v, m in per_var.items() if m == "compact")

    def set_layout(self, key: str, tile: int, node_block: int) -> None:
        self.layout[key] = {"tile": int(tile), "node_block": int(node_block)}
        self._fingerprint = None

    def layout_for(self, key: str) -> Optional[Dict[str, int]]:
        return self.layout.get(key)

    # -- identity --------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "ops": {k: v.to_json() for k, v in sorted(self.ops.items())},
            "materialization": self.materialization,
            "layout": self.layout,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TuningDecisions":
        return cls(
            ops={k: variant_from_json(v) for k, v in d.get("ops", {}).items()},
            materialization=d.get("materialization", {}),
            layout=d.get("layout", {}),
        )

    def fingerprint(self) -> str:
        """Stable digest of the whole table."""
        if self._fingerprint is None:
            blob = json.dumps(self.to_json(), sort_keys=True)
            self._fingerprint = hashlib.sha1(blob.encode()).hexdigest()[:16]
        return self._fingerprint

    def __len__(self) -> int:
        return len(self.ops) + len(self.materialization) + len(self.layout)

    def __repr__(self) -> str:
        return (f"TuningDecisions(ops={len(self.ops)}, "
                f"materialization={len(self.materialization)}, "
                f"layout={len(self.layout)}, fp={self.fingerprint()})")
