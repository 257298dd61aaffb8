"""Deterministic fault injection for the serving path (chaos harness).

The port's copy of the JAX package's ``utils/faults.py``: the same spec
grammar and the same seeded schedules. Without it the only way an engine
exception reaches the scheduler is a real CUDA error on a real card, which
no CPU test can schedule. This module makes failure a first-class, SEEDED input: a :class:`FaultPlan` names
injection points and fires at deterministic arrival indices, so a chaos
test can assert "the 5th dispatch raises" and replay the exact same
schedule every run — same spec, same seed, same faults.

Injection points (the names are the JAX package's vocabulary; hooks are
one function call at each site, zero work when no plan is armed). The
port's engine fires two of them:

    engine.dispatch   — prefill_chunk, decode, decode_multi, decode_spec,
                        decode_pipelined, decode_prefill_fused,
                        decode_spec_pipelined, decode_spec_prefill_fused,
                        after their argument checks, before any device work
    engine.consume    — pipeline_consume (the lagged blocking readback)

The others parse, so that one spec arms both packages alike, and fire
nowhere in the port yet: ``engine.transfer`` (the JAX engine's host logits
transfers, which the port has no counterpart of), ``plane.broadcast`` and
``plane.recv`` (the multi-process control plane), ``journal.write`` and
``recovery.replay`` (the request journal).

Spec grammar (``DLLAMA_FAULTS`` env var, or :func:`arm` directly)::

    spec    := clause (';' clause)*
    clause  := point ':' trigger (':' option)*
    trigger := '@' N ['+' M]          fire at the Nth arrival (1-based),
                                      then every M arrivals after
             | 'p=' F ',seed=' S      Bernoulli(F) per arrival, decided by
                                      a pure hash of (seed, arrival) — the
                                      schedule is a function of the seed
    option  := 'n=' K                 at most K fires (default unlimited)
             | 'kind=raise'           raise InjectedFault (default)
             | 'kind=hang'            block the calling thread instead —
                                      the blackholed-step simulator the
                                      watchdog exists for
             | 'hang=' SECONDS        hang duration (default 30; the hang
                                      aborts early on disarm())

Examples::

    DLLAMA_FAULTS="engine.dispatch:@5:n=1"         one fault, 5th dispatch
    DLLAMA_FAULTS="engine.consume:p=0.02,seed=7"   seeded 2% consume faults
    DLLAMA_FAULTS="engine.consume:@8:n=1:kind=hang:hang=5"  one 5s blackhole

Armed state is process-global (the engine hot paths can't thread a plan
through every call); ``fire()`` on an unarmed process is one global read.
"""

from __future__ import annotations

import threading
import time

from ..lockcheck import make_lock

POINTS = (
    "engine.dispatch",
    "engine.consume",
    "engine.transfer",
    "plane.broadcast",
    "plane.recv",
    "journal.write",
    "recovery.replay",
)


class InjectedFault(RuntimeError):
    """A scheduled fault firing. Deliberately NOT a ValueError: the
    scheduler's failure classifier treats it as engine-scoped (the class
    of failure the containment layer exists for), matching the real
    errors it stands in for (a CUDA error raised by a step)."""

    def __init__(self, point: str, arrival: int):
        self.point = point
        self.arrival = arrival
        super().__init__(
            f"injected fault at {point} (arrival {arrival})"
        )


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a pure, platform-stable hash — the Bernoulli
    trigger's decision for arrival i is mix(seed ^ i), so a schedule is a
    function of (seed, arrival index) and nothing else."""
    x &= 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class FaultClause:
    """One parsed clause: a point, a deterministic trigger, and limits."""

    def __init__(self, point: str, at: int = 0, every: int = 0,
                 prob: float = 0.0, seed: int = 0, limit: int = 0,
                 kind: str = "raise", hang_s: float = 30.0):
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (expected one of {POINTS})"
            )
        if kind not in ("raise", "hang"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if at <= 0 and prob <= 0.0:
            raise ValueError(
                f"clause for {point} needs a trigger (@N or p=F,seed=S)"
            )
        self.point = point
        self.at = at
        self.every = every
        self.prob = prob
        self.seed = seed
        self.limit = limit
        self.kind = kind
        self.hang_s = hang_s

    def decides(self, arrival: int, fired: int) -> bool:
        """Pure decision for the ``arrival``-th (1-based) event at this
        clause's point, given ``fired`` prior fires — no state, so the
        whole schedule is enumerable up front (see FaultPlan.schedule)."""
        if self.limit and fired >= self.limit:
            return False
        if self.at > 0:
            if arrival == self.at:
                return True
            return (
                self.every > 0
                and arrival > self.at
                and (arrival - self.at) % self.every == 0
            )
        # Bernoulli(prob) via the top 53 bits of the hash
        draw = _mix64(self.seed ^ (0x9E3779B97F4A7C15 * arrival)) >> 11
        return draw / float(1 << 53) < self.prob

    @staticmethod
    def parse(text: str) -> "FaultClause":
        parts = [p.strip() for p in text.split(":") if p.strip()]
        if len(parts) < 2:
            raise ValueError(f"fault clause {text!r} needs point:trigger")
        point = parts[0]
        kw: dict = {}
        trigger = parts[1]
        if trigger.startswith("@"):
            body = trigger[1:]
            if "+" in body:
                at, every = body.split("+", 1)
                kw["at"], kw["every"] = int(at), int(every)
            else:
                kw["at"] = int(body)
        else:
            for item in trigger.split(","):
                k, _, v = item.partition("=")
                if k == "p":
                    kw["prob"] = float(v)
                elif k == "seed":
                    kw["seed"] = int(v)
                else:
                    raise ValueError(f"bad trigger term {item!r} in {text!r}")
        for opt in parts[2:]:
            k, _, v = opt.partition("=")
            if k == "n":
                kw["limit"] = int(v)
            elif k == "kind":
                kw["kind"] = v
            elif k == "hang":
                kw["hang_s"] = float(v)
            else:
                raise ValueError(f"bad option {opt!r} in fault clause {text!r}")
        return FaultClause(point, **kw)


class FaultPlan:
    """A parsed, armed-able set of clauses with per-point arrival counters.

    Counters are the only mutable state; decisions are pure functions of
    (clause, arrival index), so ``schedule()`` can enumerate exactly which
    arrivals will fire — the determinism contract the chaos tests pin."""

    def __init__(self, clauses: list[FaultClause]):
        self.clauses = list(clauses)
        self._lock = make_lock("FaultPlan._lock")
        self._arrivals: dict[str, int] = {}
        self._fired: list[int] = [0] * len(self.clauses)

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        clauses = [
            FaultClause.parse(c) for c in spec.split(";") if c.strip()
        ]
        if not clauses:
            raise ValueError(f"empty fault spec {spec!r}")
        return FaultPlan(clauses)

    def schedule(self, point: str, horizon: int) -> list[int]:
        """The arrival indices in [1, horizon] that will fire at ``point``
        — computed without touching the live counters, so two plans parsed
        from the same spec report identical schedules (the determinism
        gate)."""
        out = []
        fired = [0] * len(self.clauses)
        for arrival in range(1, horizon + 1):
            for i, c in enumerate(self.clauses):
                if c.point != point:
                    continue
                if c.decides(arrival, fired[i]):
                    fired[i] += 1
                    out.append(arrival)
                    break
        return out

    def fire(self, point: str) -> None:
        """One arrival at ``point``: count it, and act when a clause
        decides — raise :class:`InjectedFault` (kind=raise) or block the
        calling thread (kind=hang, the blackholed-step simulator; aborts
        early on :func:`disarm`). The decision happens under the lock;
        the action happens outside it."""
        act: FaultClause | None = None
        arrival = 0
        with self._lock:
            arrival = self._arrivals.get(point, 0) + 1
            self._arrivals[point] = arrival
            for i, c in enumerate(self.clauses):
                if c.point != point:
                    continue
                if c.decides(arrival, self._fired[i]):
                    self._fired[i] += 1
                    act = c
                    break
        if act is None:
            return
        if act.kind == "hang":
            deadline = time.monotonic() + act.hang_s
            # interruptible blackhole: disarm() releases hung threads so
            # a chaos test never leaks a sleeping loop thread past its
            # assertions
            while time.monotonic() < deadline and _armed() is self:
                _ABORT.wait(0.05)
            return
        raise InjectedFault(point, arrival)


# -- process-global arming ----------------------------------------------------

_PLAN: FaultPlan | None = None
_ABORT = threading.Event()


def _armed() -> FaultPlan | None:
    return _PLAN


def armed() -> bool:
    return _PLAN is not None


def arm(plan_or_spec) -> FaultPlan:
    """Arm a plan process-wide (a spec string parses first). Re-arming
    replaces the previous plan and releases any of its hung threads."""
    global _PLAN
    plan = (
        FaultPlan.parse(plan_or_spec)
        if isinstance(plan_or_spec, str)
        else plan_or_spec
    )
    _ABORT.set()
    _ABORT.clear()
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None
    _ABORT.set()  # release kind=hang blackholes
    _ABORT.clear()


def maybe_arm_from_env() -> FaultPlan | None:
    """Arm from ``DLLAMA_FAULTS`` when set and nothing is armed yet —
    called by scheduler.start() so `DLLAMA_FAULTS=... dllama-api ...`
    just works. Idempotent: an explicitly armed plan is never replaced."""
    import os

    if _PLAN is not None:
        return _PLAN
    spec = os.environ.get("DLLAMA_FAULTS")
    if not spec:
        return None
    return arm(spec)


def fire(point: str) -> None:
    """Hook call placed at each injection point: one global read when
    unarmed (the zero-overhead contract), the plan's decision otherwise."""
    plan = _PLAN
    if plan is None:
        return
    plan.fire(point)
