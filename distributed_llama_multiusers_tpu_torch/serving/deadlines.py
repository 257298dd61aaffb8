"""Per-request deadlines: queue-wait timeout and wall-clock generation budget.

Two monotonic clocks per request, both optional and both overridable
per-request (``Request.queue_timeout_s`` / ``Request.budget_s``) on top of
the server-wide :class:`DeadlinePolicy` (``--queue-timeout`` /
``--request-budget``):

- **queue wait** (``submitted_at`` → admission): a request that waited
  longer than its timeout finishes with ``finish_reason="timeout"`` without
  ever claiming a lane. Checked when the scheduler pops it AND by a
  periodic sweep of the waiting queue (``QosQueue.remove_if``), so a
  saturated server — all lanes busy, nothing being popped — still times out
  its backlog instead of holding clients open forever.
- **generation budget** (``admitted_at`` → now): a lane whose request
  exceeded its wall-clock budget finishes with ``finish_reason="timeout"``
  at the next decode-loop iteration and frees the lane for the next queued
  request. With multi-step decode the check lands on horizon boundaries, so
  a budget can overshoot by up to ``multi_step`` tokens' worth of time.

``None`` or ``<= 0`` disables a limit. All helpers are pure functions of
(request, policy, now) so they are trivially testable and the scheduler owns
all state transitions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass(frozen=True)
class DeadlinePolicy:
    """Server-wide deadline defaults; requests override field-by-field."""

    queue_timeout_s: float | None = None
    request_budget_s: float | None = None

    @staticmethod
    def from_args(args) -> "DeadlinePolicy":
        """Build from the CLI surface (--queue-timeout / --request-budget;
        the argparse defaults are 0 = disabled)."""
        return DeadlinePolicy(
            queue_timeout_s=getattr(args, "queue_timeout", 0) or None,
            request_budget_s=getattr(args, "request_budget", 0) or None,
        )

    @property
    def active(self) -> bool:
        return (
            (self.queue_timeout_s or 0) > 0 or (self.request_budget_s or 0) > 0
        )


def _limit(override: float | None, default: float | None) -> float | None:
    v = override if override is not None else default
    if v is None or v <= 0:
        return None
    return float(v)


def queue_timeout_for(req, policy: DeadlinePolicy) -> float | None:
    return _limit(getattr(req, "queue_timeout_s", None), policy.queue_timeout_s)


def budget_for(req, policy: DeadlinePolicy) -> float | None:
    return _limit(getattr(req, "budget_s", None), policy.request_budget_s)


def queue_expired(req, policy: DeadlinePolicy, now: float | None = None) -> bool:
    """Did ``req`` outwait its queue timeout? False when no timeout applies
    or the request was never stamped (direct library use)."""
    limit = queue_timeout_for(req, policy)
    t0 = getattr(req, "submitted_at", None)
    if limit is None or t0 is None:
        return False
    return (now if now is not None else time.monotonic()) - t0 > limit


def budget_expired(req, policy: DeadlinePolicy, now: float | None = None) -> bool:
    """Did ``req`` exceed its wall-clock generation budget? Measured from
    admission (lane claim), not submission — queue wait is governed by the
    queue timeout, not the budget."""
    limit = budget_for(req, policy)
    t0 = getattr(req, "admitted_at", None)
    if limit is None or t0 is None:
        return False
    return (now if now is not None else time.monotonic()) - t0 > limit
