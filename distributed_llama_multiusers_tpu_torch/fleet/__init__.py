"""Fleet front-end: multi-replica routing + journal-based live migration.

The layer ABOVE the per-replica serving stack (ROADMAP item 4). A
``dllama-router`` process spreads traffic across N ``dllama-api``
replicas using the signals each replica already emits — the ``/load``
JSON surface (queue depth, free lanes, paged-pool pressure, breaker
state, draining flag), typed 429/503 sheds with jittered Retry-After,
and the ``X-DLlama-Replica`` attribution header — and routes
same-leading-prompt sessions by consistent-hash prefix affinity so the
paged KV pool's warm prefix pages (runtime/kvpool.py) get multiplied
across the fleet instead of diluted by random placement.

Its signature capability is LIVE MIGRATION: deterministic replay
(journal admit record -> byte-identical regeneration -> ``Last-Event-ID``
reattach) turned into a fleet primitive, so drains, rolling restarts and
replica death shed zero requests — see fleet/migrate.py and the
``/admin/session`` + ``/admin/migrate`` endpoints in server/http.py.

Pure stdlib like serving/ and telemetry/ (no torch, no numpy): the router
holds no model and runs anywhere. The port's copy of the JAX package's
``fleet/``: ``stable_hash``, ``prefix_key`` and the consistent-hash ring
are the same functions, so both routers place a key on the same replica.
"""

from .balancer import (
    DEFAULT_AFFINITY_BLOCKS,
    DEFAULT_BLOCK_CHARS,
    FleetBalancer,
    ReplicaState,
    prefix_key,
    stable_hash,
)
from .migrate import (
    MigrationShed,
    fetch_ticket,
    inject_session,
    open_stream,
)
from .router import FleetRouter
