"""Model/engine bootstrapping for the entry points: (a pod's join) ->
header -> tokenizer -> weights on the device (or sharded over a
tensor-parallel mesh) -> engine -> warmed engine (``dllama``) or warmed
scheduler (``dllama-api``)."""

from __future__ import annotations

import sys
import time

import torch

from ..formats import load_model_header
from ..models import load_params_from_m
from ..models.loader import load_params_from_m_quantized
from ..ops import cuda_q40, reset_kernel_counts
from ..ops.ring_collective import ring_sync_engages, ring_sync_supported
from ..parallel import make_mesh, mesh_devices, validate_mesh_for_config
from ..parallel.collectives import q80_sync_engages
from ..parallel.multihost import (ControlPlane, ReplayError, RootControlEngine,
                                  maybe_initialize_distributed, pod_hostnames, pod_transport,
                                  requested_pod)
from ..parallel.sharding import shard_params
from ..quants.packed import PackedQ40
from ..runtime import ContinuousBatchingScheduler, InferenceEngine, resolve_device
from ..runtime.engine import warmup_engine
from ..runtime.kvpool import DEFAULT_MAX_PARKED, DEFAULT_PAGE_SIZE
from ..serving import DeadlinePolicy, QosQueue, RequestJournal
from ..serving.qos import page_cost
from ..tokenizer import Tokenizer
from .args import parse_mesh_spec


def log(emoji: str, msg: str) -> None:
    print(f"{emoji} {msg}", flush=True)


def refuse(msg: str) -> None:
    print(f"error: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(2)


def join_pod(args) -> tuple[int, int]:
    """Join the pod where ``--coordinator`` (or ``DLLAMA_COORDINATOR``) asks
    for one, before anything touches a device; refuse (exit 2) what a pod
    does not serve: a mesh the processes cannot split (any axis but tp
    above 1, or a tp the process count does not divide), or processes that
    disagree on the data plane's transport. Processes on different hosts
    take the socket transport (``DLLAMA_POD_TRANSPORT=socket`` takes it on
    one host). Returns (process index, process count)."""
    req = requested_pod(args)
    if req is None or req[1] == 1:
        return 0, 1
    _, n_proc, pid = req
    plan = parse_mesh_spec(args.workers)
    if plan is None or plan.n_devices <= 1:
        refuse("a pod needs a --workers mesh spec spanning the global device set")
    others = {ax: getattr(plan, ax) for ax in ("dp", "sp", "ep", "pp") if getattr(plan, ax) > 1}
    if others:
        refuse(f"a pod splits tp ranks only; --workers {args.workers[0]} ({others}) across "
               "processes is later work (ROADMAP A9.1; pp: A9.2)")
    if plan.tp % n_proc:
        refuse(f"--workers tp{plan.tp} does not split over {n_proc} processes")
    try:
        maybe_initialize_distributed(args)
    except (ReplayError, ValueError) as e:
        refuse(str(e))
    hosts = sorted(set(pod_hostnames()))
    log("⭕", f"Pod transport: {pod_transport()} ({n_proc} processes on "
              f"{len(hosts)} host{'s' if len(hosts) > 1 else ''}: {', '.join(hosts)})")
    return pid, n_proc


def load_stack(args, n_lanes: int | None = None, serving: bool = True):
    """Returns (config, params, tokenizer, engine) on ``args.device``; with
    ``--workers N`` the params are the per-rank shards of a tp=N mesh. The
    paged KV flags apply to a serving engine (the scheduler admits its
    lanes' pages); the CLI's (``serving`` False) keeps contiguous planes.

    A pod (``--coordinator``): the process joins first; each loads the
    model file itself and keeps its own ranks' shards (``--device`` names
    their devices). Process 0's engine comes back wrapped in
    ``RootControlEngine`` (every call broadcast to the workers first); a
    worker's carries ``control_plane`` for ``worker_serve``. Every process
    takes ``--max-lanes`` lanes (``n_lanes`` applies to one process, rounded
    up to a lane a dp group on a dp mesh; ``--max-lanes`` must split over
    dp)."""
    pid, n_proc = join_pod(args)
    plan = parse_mesh_spec(args.workers)
    if plan is not None and plan.n_devices > 1:
        devices = mesh_devices(args.device, plan.n_devices // n_proc)
        device = devices[0]
    else:
        plan = None
        device = resolve_device(args.device)
    header = load_model_header(args.model, max_seq_len=args.max_seq_len)
    # bf16 activations and weights on the card; f32 on the CPU (parity)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    log("💡", f"Dim: {header.dim}  HiddenDim: {header.hidden_dim}  Layers: {header.n_layers}")
    if header.n_experts > 0:
        log("💡", f"Experts: {header.n_experts}  Active: {header.n_active_experts}")
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
        mesh = make_mesh(plan, devices, process_index=pid, num_processes=n_proc)
        params = shard_params(params, mesh)
        log("⭕", f"Mesh: dp={plan.dp} pp={plan.pp} tp={plan.tp} sp={plan.sp} "
                  f"ep={plan.ep} over {plan.n_devices} devices "
                  + (f"({','.join(str(d) for d in mesh.devices)})" if n_proc == 1 else
                     f"in {n_proc} processes (this one: ranks {mesh.local_ranks.start}.."
                     f"{mesh.local_ranks.stop - 1} on "
                     f"{','.join(str(d) for d in mesh.devices)})"))
    log("💿", f"Weights loaded in {time.perf_counter() - t0:.1f}s")
    if mesh is not None and device.type == "cuda":
        # ranks on one card share each weight they hold alike
        # (parallel/sharding.py); what the card holds for them
        for dev in dict.fromkeys(mesh.devices):
            free, total = torch.cuda.mem_get_info(dev)
            log("💾", f"{dev}: {torch.cuda.memory_allocated(dev) >> 20} MiB of weights for "
                      f"{sum(d == dev for d in mesh.devices)} ranks, card free "
                      f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB")

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
    # an MoE model syncs only wo on the ring: its FFN's partials meet in an
    # f32 all-reduce
    synced = "wo" if config.n_experts > 0 else "wo/w2"
    if q80_sync:
        log("🔶", f"Q80 sync transport: {synced} TP boundaries ship int8+scales "
                  "(--buffer-float-type q80 on a tp mesh)")
    elif emulate_q80:
        log("🔶", "Q80 activation-cast emulation enabled (--buffer-float-type q80)")
    if mesh is not None and ring_sync_engages(config, mesh.shape, ring_sync) \
            and ring_sync_supported(config.dim, mesh.tp, q80_sync):
        log("🔗", f"Ring TP sync: {synced} activation sync interleaved with the dequant "
                  "matmul, every hop one ring_hop kernel launch"
                  + (" (Q80 wire)" if q80_sync else "") + " — --ring-sync off for "
                  "a local partial and a ring all-reduce")
    if mesh is not None and not mesh.pure_tp:
        # the JAX package's gates: the ring sync and the Q80 wire are pure-TP
        if mesh.tp > 1:
            log("🔗", f"TP sync: {synced} partials meet in a ring all-reduce within each tp "
                      "group (f32; the ring sync and the Q80 wire serve pure-TP meshes"
                      + (", --buffer-float-type q80 emulates the casts" if emulate_q80 else "")
                      + ")")
        if plan.dp > 1:
            log("⭕", f"dp={plan.dp}: lanes split over the dp groups")
        if plan.sp > 1:
            log("⭕", f"sp={plan.sp}: each rank holds {config.seq_len // plan.sp} slots of every "
                      "lane; attention combines the blocks' flash stats over the sp group")
        if plan.ep > 1:
            log("⭕", f"ep={plan.ep}: {config.n_experts // plan.ep} experts a rank, the routed "
                      "partials meet in one f32 all-reduce over each ep x tp group")

    # None: bf16 KV on the card, f32 on the CPU; f8 doubles the lanes or
    # context a card holds against bf16
    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "f8": torch.float8_e4m3fn, "auto": None}[args.kv_dtype]
    try:
        lanes = (n_lanes if n_proc == 1 else None) or args.max_lanes
        if n_lanes and mesh is not None:
            # the CLI's one lane: one a dp group (the others park)
            lanes = -(-lanes // plan.dp) * plan.dp
        engine = InferenceEngine(config, params, n_lanes=lanes,
                                 cache_dtype=cache_dtype, device=device, mesh=mesh,
                                 emulate_q80_activations=emulate_q80, q80_sync=q80_sync,
                                 ring_sync=ring_sync,
                                 # async decode pipeline ring bound (None: 2)
                                 pipeline_depth=getattr(args, "pipeline_depth", None),
                                 grammar_slab_states=getattr(args, "grammar_slab_states", None),
                                 **(paged_kwargs(args) if serving else {}))
    except ReplayError as e:
        # a pod whose processes disagree on the KV layout (multihost.agree)
        refuse(f"{e}; a dllama inference/chat root keeps contiguous planes, so its "
               "workers run without --paged-kv")
    if not serving and getattr(args, "paged_kv", "off") == "on":
        log("📑", "--paged-kv applies to dllama-api; the CLI keeps contiguous planes")
    if args.kv_dtype != "auto":
        planes = engine.cache if mesh is None else engine.cache[0]
        per_token = (2 * config.n_layers * config.n_kv_heads * config.head_size
                     * planes.k.element_size())
        log("🗄️", f"KV cache: {args.kv_dtype} ({planes.k.dtype}), {per_token} bytes a token, "
                  f"{per_token * config.seq_len / (1 << 20):.1f} MiB a lane at seq_len "
                  f"{config.seq_len}")
    pool = engine.kvpool
    if pool is not None:
        log("📑", f"Paged KV: {pool.n_pages} pages x {pool.page_size} tokens, "
                  f"{pool.blocks_per_lane} blocks/lane, max parked {pool.max_parked}, "
                  + (f"host swap tier {pool.host_tier.budget_bytes // (1 << 20)} MiB"
                     if pool.host_tier.enabled else "host swap tier off")
                  + " (--paged-kv off restores contiguous planes)")
    # structured output: register the tokenizer's piece table (special
    # tokens, from bos_id up, are illegal everywhere) so response_format
    # requests compile token-level automata; --grammar off refuses them
    if getattr(args, "grammar", "on") != "off":
        engine.grammar_init([tokenizer.vocab[i] if i < tokenizer.bos_id else None
                             for i in range(tokenizer.vocab_size)],
                            tokenizer.eos_token_ids)
        log("🧩", "Structured output: json_object / json_schema enabled "
                  "(--grammar off disables)")
    if n_proc > 1:
        # a slot fits the largest prompt chunk, every per-lane vector and
        # the in-chain drafts (ControlPlane's sizing)
        plane = ControlPlane(engine.n_lanes, chunk=engine.prefill_buckets[-1], fatal=pid == 0)
        log("⭕", f"Pod: {n_proc} processes, ring steps across them over "
                  f"{engine.pod.transport} ({engine.pod.slot_bytes // 1024} KiB slots); "
                  "decode families run eagerly (no CUDA graphs on a pod: ROADMAP A7.3)")
        if pid == 0:
            log("⭕", f"Pod root: control plane up ({plane.chunk}-word slots)")
            engine = RootControlEngine(engine, plane)
        else:
            log("⭕", f"Pod worker {pid}/{n_proc}")
            engine.control_plane = plane
    return config, params, tokenizer, engine


def paged_kwargs(args) -> dict:
    """The engine's paged-KV keywords from the flags. Explicit values pass
    through unmodified (None = flag absent): a 0 or negative
    --kv-page-size must die in the pool's validation, not silently become
    the default."""
    page = getattr(args, "kv_page_size", None)
    parked = getattr(args, "kv_max_parked", None)
    return {
        "paged_kv": getattr(args, "paged_kv", "off") == "on",
        "kv_page_size": DEFAULT_PAGE_SIZE if page is None else page,
        "kv_pool_pages": getattr(args, "kv_pool_pages", None),
        "kv_max_parked": DEFAULT_MAX_PARKED if parked is None else parked,
        "kv_host_bytes": getattr(args, "kv_host_bytes", None) or 0,
    }


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
    reset_kernel_counts()
    if getattr(engine, "pod", None) is not None:
        engine.pod.reset_stats()
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
    # a paged engine charges DRR fair share in pages, what admission takes
    # from the pool, with the quantum rescaled to ~128 tokens' worth
    qos_kw = {}
    pool = getattr(engine, "kvpool", None)
    if pool is not None:
        qos_kw = {"cost": page_cost(pool.page_size),
                  "quantum": max(1.0, 128.0 / pool.page_size)}
    # a pod root's watchdog ends the process on a trip: a dead worker
    # leaves the root in a ring step that never completes
    overrides["watchdog_fatal"] = isinstance(engine, RootControlEngine)
    sched = ContinuousBatchingScheduler(engine, tokenizer,
                                        speculative=not getattr(args, "no_spec", False),
                                        queue_=QosQueue(capacity=max_queue, **qos_kw),
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
