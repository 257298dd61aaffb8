"""Graceful drain for the continuous-batching scheduler.

Shutdown today is ``Scheduler.stop()``: in-flight generations finish as
``"cancelled"`` and queued requests fail — correct for an emergency stop,
wrong for a rolling restart. Drain is the graceful path:

1. ``scheduler._draining`` flips — ``submit()`` starts shedding with the
   typed :class:`~..serving.qos.AdmissionRejected` (HTTP 503 + Retry-After),
   and the ``/health`` readiness endpoint flips to 503 so load balancers
   stop routing here;
2. the batching loop keeps serving everything already queued or active
   until every lane is free and the queue is empty (deadlines still apply,
   so a drain is bounded by the longest queue-timeout + budget when those
   are configured), then exits on its own;
3. the loop thread is joined. If ``timeout`` elapses first, the remaining
   work is force-cancelled via ``scheduler.stop()`` — either way every
   future resolves, so no client ever hangs on a draining server.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


def drain_scheduler(scheduler, timeout: float | None = None) -> bool:
    """Run the drain protocol on ``scheduler``. Returns True on a clean
    drain (all work finished), False when ``timeout`` forced cancellation.
    Idempotent; safe on a scheduler that never started."""
    scheduler._draining.set()
    watchdog = getattr(scheduler, "watchdog", None)
    thread = scheduler._thread
    if thread is None or not thread.is_alive():
        # loop never ran (or already stopped): nothing is generating, but
        # queued futures must still resolve — as a retryable 503, since
        # these requests never got any service
        for req in scheduler.queue.drain():
            scheduler._shed_unadmitted(req)
        scheduler._thread = None
        if watchdog is not None:
            watchdog.stop()
        return True
    thread.join(timeout)
    if thread.is_alive():
        log.warning(
            "drain timed out after %ss with work still active; "
            "force-cancelling remaining lanes",
            timeout,
        )
        try:
            scheduler.stop()  # resolves in-flight as "cancelled", queued as failed
        except RuntimeError:
            # the loop thread survived even the forced join (hung device
            # dispatch). Nothing more can be done from here; report the
            # failed drain as False instead of masking it with a raise
            # from the cleanup path.
            log.error(
                "force-stop after drain timeout failed; loop thread still alive"
            )
        return False
    scheduler._thread = None
    # a submit() racing the drain flag can slip a request into the queue
    # after the loop took its exit snapshot; flush (as retryable 503s) so
    # every future resolves
    for req in scheduler.queue.drain():
        scheduler._shed_unadmitted(req)
    if watchdog is not None:  # the monitor thread drains with the loop
        watchdog.stop()
    return True
