"""Serving QoS layers: bounded admission, deadlines, graceful drain,
circuit breaker, step watchdog and crash durability.

The substrate between the HTTP layer (server/http.py) and the
continuous-batching loop (runtime/scheduler.py), copied from the JAX
package's ``serving/`` (pure stdlib there and here): qos.py owns who gets
in and in what order, deadlines.py how long anything may wait or run,
drain.py how the whole thing shuts down without dropping clients,
breaker.py when a failing engine stops admitting at all, watchdog.py
turning a hung step into a signal instead of a silent wedge, and the
crash-durability trio, journal.py (append-only request journal),
recovery.py (deterministic replay re-admission) and resume.py (bounded
delta relays for mid-stream SSE reattach), making a process death a
latency blip instead of data loss. Imports nothing from runtime/ or
server/: it is a leaf both depend on.
"""

from .breaker import CircuitBreaker
from .deadlines import (
    DeadlinePolicy,
    budget_expired,
    budget_for,
    queue_expired,
    queue_timeout_for,
)
from .drain import drain_scheduler
from .journal import (
    JournalEntry,
    JournalImage,
    RequestJournal,
    admit_record,
    entry_from_admit_record,
    read_journal,
)
from .qos import (
    AdmissionRejected,
    Priority,
    QosQueue,
    jittered_retry_after,
    page_cost,
)
from .recovery import (
    RecoveryCoordinator,
    attach_recovered_stream,
    recover_scheduler,
)
from .resume import StreamRegistry, StreamRelay
from .watchdog import StepWatchdog
