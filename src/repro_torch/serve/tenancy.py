"""Multi-model tenancy: several compiled models serving from one process
(the port's copy of ``repro.serve.tenancy``).

Each tenant is one ``hector_torch.compile()`` artifact wrapped in its own
``ServingRuntime`` (own admission queue, ladder, latency model, worker
threads); the process-level resources are shared:

* **one tuning cache** — tenants built with the same ``tune_cache`` path
  replay each other's measured per-operator decisions (the cache key
  includes the model/plan identity, so entries never collide);
* **one obs scope** — every tenant reports into the ambient registry,
  isolated by its ``model=<name>`` label, and spans land on each tenant's
  own worker-thread tracks;
* **one compiled-executor regime** — executors key their captured graphs
  by plan identity + shapes, so interleaved traffic across tenants never
  cross-invalidates: model A's shape warmup survives model B's, and the
  steady state stays at zero retraces for *all* tenants. Each tenant's
  executor captures on its own execute thread; captures across the
  process are serialized by ``core.executor``'s capture lock, so two
  tenants never capture at once.

``MultiTenantRuntime`` itself is thin routing: ``submit`` dispatches on
``Request.model`` (or the sole tenant), lifecycle calls fan out.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.serve.load import Request
from repro_torch.serve.runtime import ServingRuntime


class MultiTenantRuntime:
    """Route requests to named ``ServingRuntime`` tenants.

    Build with ``add_tenant`` (which constructs the per-tenant runtime) or
    ``add`` (which registers one you built yourself); then ``calibrate()``
    every tenant's ladder before ``start()``. Context-manager use closes
    all tenants — every tenant's worker threads are joined.
    """

    def __init__(self):
        self._tenants: Dict[str, ServingRuntime] = {}
        self._started = False

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add(self, runtime: ServingRuntime) -> ServingRuntime:
        if runtime.name in self._tenants:
            raise ValueError(f"duplicate tenant {runtime.name!r}")
        self._tenants[runtime.name] = runtime
        return runtime

    def add_tenant(self, name: str, engine, params, store=None,
                   **runtime_kw) -> ServingRuntime:
        return self.add(ServingRuntime(engine, params, store,
                                       name=name, **runtime_kw))

    @property
    def tenants(self) -> Dict[str, ServingRuntime]:
        return dict(self._tenants)

    def __getitem__(self, name: str) -> ServingRuntime:
        return self._tenants[name]

    def __len__(self) -> int:
        return len(self._tenants)

    # ------------------------------------------------------------------
    # lifecycle (fans out)
    # ------------------------------------------------------------------
    def calibrate(self, **kw) -> None:
        for rt in self._tenants.values():
            rt.calibrate(**kw)

    def start(self) -> "MultiTenantRuntime":
        if not self._tenants:
            raise RuntimeError("no tenants registered")
        for rt in self._tenants.values():
            rt.start()
        self._started = True
        return self

    def __enter__(self) -> "MultiTenantRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        for rt in self._tenants.values():
            rt.drain(timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        first_failure = None
        for rt in self._tenants.values():
            try:
                rt.close(timeout=timeout)
            except BaseException as e:  # close every tenant regardless
                if first_failure is None:
                    first_failure = e
        if first_failure is not None:
            raise first_failure

    def worker_threads(self) -> List:
        return [t for rt in self._tenants.values()
                for t in rt.worker_threads()]

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Dispatch on ``req.model``; a single-tenant deployment may leave
        it unset."""
        if req.model is None:
            if len(self._tenants) != 1:
                raise ValueError(
                    f"request {req.rid} names no model and "
                    f"{len(self._tenants)} tenants are registered")
            rt = next(iter(self._tenants.values()))
        else:
            rt = self._tenants.get(req.model)
            if rt is None:
                raise KeyError(
                    f"request {req.rid}: unknown model {req.model!r} "
                    f"(tenants: {sorted(self._tenants)})")
        return rt.submit(req)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Per-tenant reports plus the cross-tenant isolation aggregate
        (``retraces_after_warmup`` summed over tenants — the zero-cross-
        model-retrace contract is one number)."""
        per = {name: rt.stats() for name, rt in self._tenants.items()}
        retr = [s["retraces_after_warmup"] for s in per.values()
                if s["retraces_after_warmup"] is not None]
        return {
            "tenants": per,
            "requests": sum(s["requests"] for s in per.values()),
            "retraces_after_warmup": sum(retr) if retr else None,
        }
