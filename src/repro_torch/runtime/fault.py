"""Fault tolerance runtime: heartbeats, failure detection, straggler
mitigation policy, elastic re-mesh orchestration.

The port's copy of ``repro.runtime.fault`` (no JAX in either). On a
real cluster the heartbeat source is the coordination service; here the
monitor is driven by an injectable clock + report stream so the policy
logic is fully unit-testable on CPU. The train driver
(``launch/train.py``) wires it together with ``Checkpointer`` and
``plan_elastic_mesh``:

    failure detected -> drain -> plan_elastic_mesh(survivors)
    -> rebuild the step -> Checkpointer.restore
    -> resume from last step (data stream is a pure function of step, so
       no sample is lost or duplicated).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class HostState:
    last_heartbeat: float
    step: int = 0
    step_times: List[float] = dataclasses.field(default_factory=list)


class HeartbeatMonitor:
    """Declares hosts dead after ``timeout`` seconds of silence."""

    def __init__(self, hosts: List[str], timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.hosts: Dict[str, HostState] = {
            h: HostState(last_heartbeat=now) for h in hosts}

    def heartbeat(self, host: str, step: int = 0,
                  step_time: Optional[float] = None):
        st = self.hosts[host]
        st.last_heartbeat = self.clock()
        st.step = step
        if step_time is not None:
            st.step_times.append(step_time)
            if len(st.step_times) > 32:
                st.step_times.pop(0)

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_heartbeat > self.timeout]

    def alive_hosts(self) -> List[str]:
        dead = set(self.dead_hosts())
        return [h for h in self.hosts if h not in dead]

    # ------------------------------------------------------------------
    def stragglers(self, factor: float = 1.5) -> List[str]:
        """Hosts whose recent step time exceeds ``factor`` x fleet median."""
        meds = {}
        for h, st in self.hosts.items():
            if st.step_times:
                xs = sorted(st.step_times[-8:])
                meds[h] = xs[len(xs) // 2]
        if not meds:
            return []
        fleet = sorted(meds.values())[len(meds) // 2]
        return [h for h, m in meds.items() if m > factor * fleet]


@dataclasses.dataclass
class StragglerPolicy:
    """Mitigation decisions for slow hosts.

    * ``observe``: below trigger threshold — keep.
    * ``hot_swap``: persistent straggler and spares available — replace.
    * ``evict``: persistent straggler, no spares — elastic down-scale
      (cheaper than letting one host gate every synchronous step).
    """

    trigger_factor: float = 1.5
    persist_steps: int = 8
    _counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def decide(self, monitor: HeartbeatMonitor, spares: int = 0) -> Dict[str, str]:
        actions: Dict[str, str] = {}
        slow = set(monitor.stragglers(self.trigger_factor))
        for h in list(self._counts):
            if h not in slow:
                del self._counts[h]
        for h in slow:
            self._counts[h] = self._counts.get(h, 0) + 1
            if self._counts[h] < self.persist_steps:
                actions[h] = "observe"
            elif spares > 0:
                actions[h] = "hot_swap"
                spares -= 1
            else:
                actions[h] = "evict"
        return actions


@dataclasses.dataclass
class FailureEvent:
    step: int
    dead_hosts: List[str]
    surviving_devices: int


class ElasticController:
    """Drives the detect -> drain -> re-mesh -> restore -> resume sequence.

    The controller is transport-agnostic: ``rebuild`` is a callback that
    receives an ElasticPlan and returns the new (step_fn, state); the driver
    supplies it (launch/train.py).
    """

    def __init__(self, monitor: HeartbeatMonitor, devices_per_host: int,
                 model_parallel: int = 16):
        self.monitor = monitor
        self.devices_per_host = devices_per_host
        self.model_parallel = model_parallel
        self.events: List[FailureEvent] = []

    def check(self, step: int) -> Optional[FailureEvent]:
        dead = self.monitor.dead_hosts()
        if not dead:
            return None
        surviving = len(self.monitor.alive_hosts()) * self.devices_per_host
        ev = FailureEvent(step=step, dead_hosts=dead,
                          surviving_devices=surviving)
        self.events.append(ev)
        return ev

    def replan(self, ev: FailureEvent):
        from repro_torch.launch.mesh import plan_elastic_mesh
        return plan_elastic_mesh(ev.surviving_devices,
                                 model_parallel=self.model_parallel)
