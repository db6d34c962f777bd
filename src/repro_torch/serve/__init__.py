"""``repro_torch.serve`` — the online serving runtime of the port
(``repro.serve``'s counterpart, the same exports).

* ``load``: open-loop request generation — seeded Poisson / burst /
  uniform arrivals over ``SeedStream``, per-request sizes, deadlines and
  tenant routes;
* ``coalesce``: deadline-aware batch coalescing into the largest ladder
  rung whose measured latency meets the tightest in-batch deadline, the
  rungs validated by ``repro_torch.tune.ladder.validate_ladder``;
* ``runtime``: the async pipeline — coalescer thread, the loader's
  prefetch, one execute thread that owns the engine's executor (its
  captures included), bounded queues, graceful drain;
* ``tenancy``: several compiled models in one process, routed by model.
"""
from repro_torch.serve.coalesce import (Coalescer,  # noqa: F401
                                        LatencyModel, PlanDecision,
                                        PlannedBatch, ladder)
from repro_torch.serve.load import (LATE, OK,  # noqa: F401
                                    REJECTED_DEADLINE, REJECTED_OVERLOAD,
                                    REJECTED_SHUTDOWN, TERMINAL_STATUSES,
                                    OpenLoopLoad, Request, Response)
from repro_torch.serve.runtime import ServingRuntime  # noqa: F401
from repro_torch.serve.tenancy import MultiTenantRuntime  # noqa: F401

__all__ = [
    "OpenLoopLoad", "Request", "Response", "OK", "LATE",
    "REJECTED_DEADLINE", "REJECTED_OVERLOAD", "REJECTED_SHUTDOWN",
    "TERMINAL_STATUSES", "ladder", "LatencyModel", "Coalescer",
    "PlannedBatch", "PlanDecision", "ServingRuntime", "MultiTenantRuntime",
]
