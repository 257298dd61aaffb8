"""`dllama` CLI of the port: inference | chat | worker (the JAX package's
``app/dllama.py``).

    python -m distributed_llama_multiusers_tpu_torch.app.dllama inference \\
        --model m.m --tokenizer t.t --prompt "Hello" --steps 64 \\
        [--temperature 0] [--benchmark] [--dequant auto] [--workers 2]
    python -m distributed_llama_multiusers_tpu_torch.app.dllama chat \\
        --model m.m --tokenizer t.t [--chat-template llama3]

- inference: prompt evaluation, then up to ``--steps`` tokens, with the
  per-token Pred readout under ``--benchmark`` and the Evaluation /
  Prediction tok/s summary;
- chat: turns read from stdin, rendered through the chat template, each
  reply streamed through the stop-string detector; the position carries
  across turns until the context window is full;
- worker: the JAX package joins a multi-process pod here; the port runs
  one process (``--workers N`` shards over this host's cards) and prints
  that guidance.

Greedy runs (``--temperature 0``) decode through ``SpecStream``:
prompt-lookup speculation (unless ``--no-spec``) and, where no draft hits,
8-step horizons, both of the stream plain decoding gives. Sampled runs
take a plain step and draw on the host (``tokenizer/sampler.py``). The
engine is one lane on ``--device`` (the card unless ``--device cpu``), its
decode, verify and multi-step bodies captured as CUDA graphs at startup.
"""

from __future__ import annotations

import sys
import time

from ..ops.ring_collective import ring_counts
from ..runtime.spec import SpecStream
from ..tokenizer import (ChatItem, EosDetector, EosResult, Sampler, TokenizerChatStops,
                         chat_generator_for)
from ..utils.seeds import fresh_seed
from .args import build_parser
from .runtime_setup import load_stack, log, warm_engine, warmup_log

MULTI_H = 8  # the greedy stream's multi-step horizon where no draft hits


def _spec_stream(args, engine, config, prompt_tokens=()):
    """The run's ``SpecStream`` (speculation and horizons for greedy runs),
    the engine warmed: its graphs captured, the counters zeroed."""
    greedy = args.temperature == 0.0
    spec = SpecStream(engine, config, enabled=greedy and not args.no_spec,
                      prompt_tokens=prompt_tokens,
                      multi_h=0 if not greedy else (MULTI_H if args.multi_step is None
                                                    else args.multi_step))
    warmup_log(engine, warm_engine(engine, spec=spec.enabled, multi_step=spec.multi_h,
                                   pipeline=False))
    return spec


def _sync_suffix(engine, hops0: int, steps0: int) -> str:
    """The Pred line's Sync readout on a mesh: the hop bytes of the last
    decode step per rank and the ring hop's launches per decode step since
    the previous line (the JAX package reckons both from the compiled
    step's collectives)."""
    steps = engine.stats.decode_steps - steps0
    if engine.mesh is None or steps <= 0:
        return ""
    hops = (ring_counts()["ring_hop_launches"] - hops0) // steps
    kb = engine.stats.sync_bytes_per_decode / 1024 / len(engine.devices)
    return f"  Sync {kb:8.1f} kB/chip ({hops} collectives)"


def run_inference(args) -> None:
    config, params, tokenizer, engine = load_stack(args, n_lanes=1)
    prompt = args.prompt or "Hello"
    tokens = tokenizer.encode(prompt)
    log("📄", f"Prompt tokens: {len(tokens)}")
    if len(tokens) >= config.seq_len:
        # --max-seq-len only clamps down, so it is not the remedy
        log("🚫", f"Prompt ({len(tokens)} tokens) does not fit the context "
            f"window ({config.seq_len}); shorten the prompt")
        raise SystemExit(2)
    # a fixed default seed keeps one-shot runs reproducible; `is not None`:
    # --seed 0 is a seed
    sampler = Sampler(config.vocab_size, args.temperature, args.topp,
                      args.seed if args.seed is not None else 12345)
    spec = _spec_stream(args, engine, config, prompt_tokens=tokens)

    t0 = time.perf_counter()
    logits, greedy, pos = engine.prefill(0, tokens)
    eval_s = time.perf_counter() - t0
    log("🔷", f"Eval {eval_s * 1000:8.2f} ms  ({len(tokens)} tokens, "
              f"{len(tokens) / eval_s:.1f} tok/s)")

    cur = (greedy if args.temperature == 0.0
           else sampler.sample(engine.lane_logits(logits[None], 0)))
    tokenizer.reset_decoder()
    pred_times = []
    for _ in range(args.steps):
        piece = tokenizer.decode(cur)
        if piece:
            print(piece, end="", flush=True)
        if tokenizer.is_eos(cur) or pos >= config.seq_len:
            break
        t1 = time.perf_counter()
        hops0, steps0 = ring_counts()["ring_hop_launches"], engine.stats.decode_steps
        nxt, used_forward = spec.advance(cur, pos)
        if not used_forward:
            # cur's cache write happened in the verify or multi step
            pos += 1
            pred_times.append(0.0)  # counts the token for the tok/s summary
            cur = nxt
            continue
        if args.temperature > 0.0:
            nxt = sampler.sample(engine.lane_logits(spec.last_logits, 0))
        dt = time.perf_counter() - t1
        pred_times.append(dt)
        if args.benchmark:
            spec_note = f"  (spec +{len(spec.pending)})" if spec.pending else ""
            log("🔶", f"Pred {dt * 1000:8.2f} ms{_sync_suffix(engine, hops0, steps0)}"
                      f"{spec_note}")
        pos += 1
        cur = nxt
    print()
    if pred_times:
        total = sum(pred_times)
        log("⏱", f"Evaluation: {eval_s * 1000:.2f} ms ({len(tokens) / eval_s:.2f} tok/s)")
        log("⏱", f"Prediction: {total * 1000:.2f} ms ({len(pred_times) / total:.2f} tok/s)")
    if args.benchmark:
        st = engine.stats.snapshot()
        if st["spec_lane_steps"]:
            log("⏱", f"Speculation: {st['spec_steps']} verify steps, {st['spec_emitted']} "
                      f"tokens ({st['spec_emitted'] / st['spec_lane_steps']:.3f} a step)")
    if args.benchmark and engine.mesh is not None:
        # the split measured by torch.profiler beside the counted bytes
        m = engine.measured_sync_stats()
        if m.get("sync_ms") is not None:
            log("⏱", f"Measured/step: {m['step_ms']:.2f} ms wall, "
                f"{m['device_busy_ms']:.2f} ms device, "
                f"Sync {m['sync_ms']:.2f} ms ({m['sync_frac'] * 100:.1f}% "
                f"of device, {m['source']})")
        else:
            log("⏱", f"Measured/step: {m['step_ms']:.2f} ms wall "
                "(sync split unavailable: the profiler recorded no device time)")


def run_chat(args) -> None:
    config, params, tokenizer, engine = load_stack(args, n_lanes=1)
    generator = chat_generator_for(tokenizer, args.chat_template)
    stops = TokenizerChatStops(tokenizer)
    # an unseeded chat draws OS entropy, not wall-clock seconds; `is not
    # None`: --seed 0 is a seed
    sampler = Sampler(config.vocab_size, args.temperature, args.topp,
                      args.seed if args.seed is not None else fresh_seed())
    spec = _spec_stream(args, engine, config)

    pos = 0
    first = True
    print("💬 Chat mode. Ctrl-D to exit.")
    while True:
        try:
            user = input("\n> ")
        except EOFError:
            print()
            return
        items = []
        if first and args.prompt:
            items.append(ChatItem("system", args.prompt))
        items.append(ChatItem("user", user))
        chat = generator.generate(items, append_generation_prompt=True)
        first = False

        tokens = tokenizer.encode(chat.content, add_bos=(pos == 0))
        if pos + len(tokens) >= config.seq_len:
            log("🚫", "Context window full")
            return
        spec.extend_history(tokens)
        logits, greedy, pos = engine.prefill(0, tokens, start_pos=pos)
        cur = (greedy if args.temperature == 0.0
               else sampler.sample(engine.lane_logits(logits[None], 0)))

        detector = EosDetector(tokenizer.eos_token_ids, stops.stops, 2, 2)
        decoder = tokenizer.make_stream_decoder()
        while pos < config.seq_len:
            piece = decoder.decode(cur)
            result = detector.append(cur, piece)
            if result == EosResult.EOS:
                delta = detector.get_delta()
                if delta:
                    print(delta, end="", flush=True)
                break
            if result == EosResult.NOT_EOS:
                delta = detector.get_delta()
                if delta:
                    print(delta, end="", flush=True)
                detector.reset()
            nxt, used_forward = spec.advance(cur, pos)
            if used_forward and args.temperature > 0.0:
                nxt = sampler.sample(engine.lane_logits(spec.last_logits, 0))
            pos += 1
            cur = nxt
        # lookahead past the turn's end is uncommitted cache the next
        # prefill overwrites from pos; only the host buffer goes (and a
        # partly used verify step leaves the acceptance counters)
        spec.discard_pending()
        print()


def run_worker(args) -> None:
    """The JAX package's pod worker. The port runs one process: a host's
    cards join through ``--workers N`` (multi-process and multi-host tensor
    parallelism are ROADMAP A7)."""
    log("⭕", "Single process: no pod to join (multi-process workers are not "
              "ported yet).")
    log("⭕", "This host's cards need no worker: shard with dllama inference "
              "--workers N ...")


def main(argv=None) -> None:
    args = build_parser("dllama").parse_args(argv)
    if args.mode == "train":
        print("error: train mode is not ported yet (ROADMAP A9); the JAX package's "
              "dllama train is the reference", file=sys.stderr)
        raise SystemExit(2)
    if args.mode == "worker":
        run_worker(args)
        return
    if not (args.model and args.tokenizer):
        print("error: --model and --tokenizer are required", file=sys.stderr)
        raise SystemExit(2)
    if args.mode == "inference":
        run_inference(args)
    else:
        run_chat(args)


if __name__ == "__main__":
    main()
