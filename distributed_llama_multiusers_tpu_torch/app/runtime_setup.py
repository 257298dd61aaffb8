"""Model/engine bootstrapping for the entry points: header -> tokenizer ->
weights on the device -> engine -> warmed scheduler."""

from __future__ import annotations

import time

import torch

from ..formats import load_model_header
from ..models import load_params_from_m
from ..models.loader import load_params_from_m_quantized
from ..ops import cuda_q40
from ..quants.packed import PackedQ40
from ..runtime import ContinuousBatchingScheduler, InferenceEngine, resolve_device
from ..runtime.engine import warmup_engine
from ..tokenizer import Tokenizer


def log(emoji: str, msg: str) -> None:
    print(f"{emoji} {msg}", flush=True)


def load_stack(args, n_lanes: int | None = None):
    """Returns (config, params, tokenizer, engine) on ``args.device``."""
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
    t0 = time.perf_counter()
    if weights == "packed":
        config, params = load_params_from_m_quantized(args.model, header, dtype=dtype,
                                                      device=device)
        if isinstance(params.layers.wq, PackedQ40):
            log("🔷", f"Q40 weights resident on {device} (dequant-in-matmul)")
        else:
            log("🔶", "model has no Q40 tensors; loaded dense")
    else:
        config, params = load_params_from_m(args.model, header, dtype=dtype, device=device)
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

    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "auto": None}[args.kv_dtype]
    engine = InferenceEngine(config, params, n_lanes=n_lanes or args.max_lanes,
                             cache_dtype=cache_dtype, device=device)
    return config, params, tokenizer, engine


def make_scheduler(engine, tokenizer) -> ContinuousBatchingScheduler:
    """Warm the engine (builds the kernels, runs each prefill bucket and a
    decode step), zero the kernel counters, then start the loop: from here
    ``/stats`` counts serving launches only."""
    log("⏳", "Warming serving paths (kernel build, prefill buckets, decode)...")
    t0 = time.perf_counter()
    warmup_engine(engine)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    cuda_q40.reset_counts()
    log("⏳", f"Warmup done in {time.perf_counter() - t0:.1f}s")
    sched = ContinuousBatchingScheduler(engine, tokenizer)
    sched.start()
    return sched
