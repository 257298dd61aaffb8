"""Model/engine bootstrapping for the entry points: header -> tokenizer ->
weights on the device (or sharded over a tensor-parallel mesh) -> engine ->
warmed engine (``dllama``) or warmed scheduler (``dllama-api``)."""

from __future__ import annotations

import time

import torch

from ..formats import load_model_header
from ..models import load_params_from_m
from ..models.loader import load_params_from_m_quantized
from ..ops import cuda_attn, cuda_q40, cuda_sample, ring_collective
from ..ops.ring_collective import ring_sync_engages, ring_sync_supported
from ..parallel import make_mesh, mesh_devices, validate_mesh_for_config
from ..parallel.collectives import q80_sync_engages
from ..parallel.sharding import shard_params
from ..quants.packed import PackedQ40
from ..runtime import ContinuousBatchingScheduler, InferenceEngine, resolve_device
from ..runtime.engine import warmup_engine
from ..serving import DeadlinePolicy, QosQueue, RequestJournal
from ..tokenizer import Tokenizer
from .args import parse_mesh_spec


def log(emoji: str, msg: str) -> None:
    print(f"{emoji} {msg}", flush=True)


def load_stack(args, n_lanes: int | None = None):
    """Returns (config, params, tokenizer, engine) on ``args.device``; with
    ``--workers N`` the params are the per-rank shards of a tp=N mesh."""
    plan = parse_mesh_spec(args.workers)
    if plan is not None and plan.n_devices > 1:
        devices = mesh_devices(args.device, plan.n_devices)
        device = devices[0]
    else:
        plan = None
        device = resolve_device(args.device)
    header = load_model_header(args.model, max_seq_len=args.max_seq_len)
    # bf16 activations and weights on the card; f32 on the CPU (parity)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    log("💡", f"Dim: {header.dim}  HiddenDim: {header.hidden_dim}  Layers: {header.n_layers}")
    log("💡", f"Heads: {header.n_heads}/{header.n_kv_heads}  Vocab: {header.vocab_size}  "
              f"SeqLen: {header.seq_len}")
    tokenizer = Tokenizer(args.tokenizer)
    log("📄", f"Vocab: {tokenizer.vocab_size}  Bos: {tokenizer.bos_id}  "
              f"Eos: {tokenizer.eos_token_ids}")

    weights = args.weights
    if weights == "auto":
        weights = "dense" if device.type == "cpu" else "packed"
    # a mesh loads on the host, then each rank takes its shard
    load_on = device if plan is None else "cpu"
    t0 = time.perf_counter()
    if weights == "packed":
        config, params = load_params_from_m_quantized(args.model, header, dtype=dtype,
                                                      device=load_on)
        if isinstance(params.layers.wq, PackedQ40):
            log("🔷", f"Q40 weights resident on {device} (dequant-in-matmul)")
        else:
            log("🔶", "model has no Q40 tensors; loaded dense")
    else:
        config, params = load_params_from_m(args.model, header, dtype=dtype, device=load_on)
    mesh = None
    if plan is not None:
        validate_mesh_for_config(config, plan)
        mesh = make_mesh(plan, devices)
        params = shard_params(params, mesh)
        log("⭕", f"Mesh: dp={plan.dp} pp={plan.pp} tp={plan.tp} sp={plan.sp} "
                  f"ep={plan.ep} over {plan.n_devices} devices "
                  f"({','.join(str(d) for d in mesh.devices)})")
    log("💿", f"Weights loaded in {time.perf_counter() - t0:.1f}s")

    # the dequant mode is set before anything runs
    if args.dequant is not None:
        cuda_q40.set_dequant_mode(args.dequant)
    if cuda_q40.DEQUANT_MODE == "auto":
        from ..ops.dequant_select import table_provenance

        prov = table_provenance()
        log("🎛️", f"Dequant mode: auto — per-site selection from {prov.get('path')} "
                  f"(v{prov.get('version')}, {prov.get('rows')} rows)")
    elif cuda_q40.DEQUANT_MODE != "v4":
        log("🎛️", f"Dequant mode: {cuda_q40.DEQUANT_MODE} (--dequant / DLLAMA_DEQUANT)")

    emulate_q80 = args.buffer_float_type == "q80"
    # the predicates llama_forward reads, so that what is announced is what runs
    q80_sync = emulate_q80 and mesh is not None and q80_sync_engages(config, mesh.shape)
    ring_sync = args.ring_sync == "on"
    if q80_sync:
        log("🔶", "Q80 sync transport: wo/w2 TP boundaries ship int8+scales "
                  "(--buffer-float-type q80 on a tp mesh)")
    elif emulate_q80:
        log("🔶", "Q80 activation-cast emulation enabled (--buffer-float-type q80)")
    if mesh is not None and ring_sync_engages(config, mesh.shape, ring_sync) \
            and ring_sync_supported(config.dim, mesh.tp, q80_sync):
        log("🔗", "Ring TP sync: wo/w2 activation sync interleaved with the dequant "
                  "matmul, every hop one ring_hop kernel launch"
                  + (" (Q80 wire)" if q80_sync else "") + " — --ring-sync off for "
                  "a local partial and a ring all-reduce")

    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "auto": None}[args.kv_dtype]
    engine = InferenceEngine(config, params, n_lanes=n_lanes or args.max_lanes,
                             cache_dtype=cache_dtype, device=device, mesh=mesh,
                             emulate_q80_activations=emulate_q80, q80_sync=q80_sync,
                             ring_sync=ring_sync,
                             # async decode pipeline ring bound (None: 2)
                             pipeline_depth=getattr(args, "pipeline_depth", None))
    return config, params, tokenizer, engine


def warm_engine(engine, spec: bool, multi_step: int, pipeline: bool = True) -> float:
    """Warm the engine (builds the kernels, runs each prefill bucket,
    captures every decode-family graph the caller can replay), zero the
    kernel counters and mark the graphs warm: from here the counters count
    serving launches only, and a graph captured is a capture after warmup
    (``analysis/jitcheck.py``). Returns the seconds it took."""
    t0 = time.perf_counter()
    warmup_engine(engine, spec=spec, multi_step=multi_step, pipeline=pipeline)
    if engine.device.type == "cuda":
        for dev in dict.fromkeys(engine.devices):
            torch.cuda.synchronize(dev)
    cuda_q40.reset_counts()
    ring_collective.reset_counts()
    cuda_sample.reset_counts()
    cuda_attn.reset_counts()
    if engine.graphs is not None:
        engine.graphs.mark_warm()
    return time.perf_counter() - t0


def warmup_log(engine, seconds: float) -> None:
    graphs = engine.graphs
    log("⏳", f"Warmup done in {seconds:.1f}s"
        + (f" ({len(graphs)} decode graphs captured in {graphs.capture_s:.1f}s)"
           if graphs is not None else ""))


def make_scheduler(engine, tokenizer, args=None) -> ContinuousBatchingScheduler:
    """Build the scheduler from the serving flags (the JAX package's
    ``make_scheduler``: a ``QosQueue`` bounded at --max-queue, the deadline
    policy, the watchdog where --step-deadline or DLLAMA_STEP_DEADLINE is
    set), warm the engine (builds the kernels, runs each prefill bucket,
    captures every decode-family graph the scheduler can replay, the
    verify step's unless --no-spec; ``warm_engine``), then start the loop:
    from here ``/stats`` counts serving launches only, and a graph captured
    counts as a compile after warmup. ``--journal-path`` gives the
    scheduler its request journal."""
    # the scheduler's defaults stand where the CLI names no value
    overrides = {}
    for flag, key in (("multi_step", "multi_step"), ("prefix_min_tokens", "prefix_min_tokens"),
                      ("step_deadline", "step_deadline_s")):
        v = getattr(args, flag, None)
        if v is not None:
            overrides[key] = v
    fp = getattr(args, "fused_prefill", None)
    if fp is not None:
        overrides["fused_prefill"] = fp == "on"
    journal_path = getattr(args, "journal_path", None)
    if journal_path:
        overrides["journal"] = RequestJournal(journal_path)
        log("📓", f"Request journal: {journal_path} (crash-durable serving)")
    max_queue = getattr(args, "max_queue", 0) or 0
    policy = DeadlinePolicy.from_args(args) if args is not None else DeadlinePolicy()
    log("🚦", f"QoS: queue capacity {max_queue or 'unbounded'}, queue timeout "
              f"{policy.queue_timeout_s or 'off'}, request budget "
              f"{policy.request_budget_s or 'off'}")
    # speculation is on unless --no-spec, as in the JAX package
    sched = ContinuousBatchingScheduler(engine, tokenizer,
                                        speculative=not getattr(args, "no_spec", False),
                                        queue_=QosQueue(capacity=max_queue),
                                        deadlines=policy, **overrides)
    log("⏳", "Warming serving paths (kernel build, prefill buckets, decode graphs)...")
    # horizons are captured only where serving can pick one (a pipelining
    # engine never chains them)
    warmup_log(engine, warm_engine(
        engine, spec=sched.speculative,
        multi_step=sched.multi_step if sched.horizons_reachable() else 0))
    log("🔁", f"Serving paths: pipeline depth {engine.pipeline_depth}, multi-step "
              f"{sched.multi_step}, fused prefill {'on' if sched.fused_prefill else 'off'}, "
              f"speculation {'on' if sched.speculative else 'off'} (SPEC_DRAFT "
              f"{engine.SPEC_DRAFT}), prefix cache "
              f"{sched.prefix_min_tokens or 'off'}, step watchdog "
              f"{sched.watchdog.deadline_s if sched.watchdog is not None else 'off'}")
    sched.start()
    return sched
