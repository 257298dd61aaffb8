"""Serving QoS layers: bounded admission, deadlines, graceful drain,
circuit breaker and step watchdog.

The substrate between the HTTP layer (server/http.py) and the
continuous-batching loop (runtime/scheduler.py), copied from the JAX
package's ``serving/`` (pure stdlib there and here): qos.py owns who gets
in and in what order, deadlines.py how long anything may wait or run,
drain.py how the whole thing shuts down without dropping clients,
breaker.py when a failing engine stops admitting at all, and watchdog.py
turning a hung step into a signal instead of a silent wedge. The JAX
package's crash-durability modules (journal, recovery, resume) are a later
slice of the port. Imports nothing from runtime/ or server/: it is a leaf
both depend on.
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
from .qos import (
    AdmissionRejected,
    Priority,
    QosQueue,
    jittered_retry_after,
    page_cost,
)
from .watchdog import StepWatchdog
