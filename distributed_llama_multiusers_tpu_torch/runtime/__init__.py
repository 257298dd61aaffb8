from .engine import InferenceEngine, EngineStats, resolve_device, warmup_engine
from .scheduler import (
    AdmissionRejected,
    ContinuousBatchingScheduler,
    EngineFailure,
    Request,
    RequestState,
)
