#!/usr/bin/env python3
"""Where a paged server's time goes beside a contiguous one's, on one CUDA
card and chip_smoke.py's synthetic full-width model:

    python3 tools/paged_probe.py admit   # host ms of a paged admission + release
    python3 tools/paged_probe.py trace [N]  # N default passes, contiguous
                                            # and --paged-kv on in turns

``admit``: an engine with ``paged_kv`` (8 lanes, 4 decoding), the host
time of ``paged_admit`` + ``paged_finish`` of a 1,900-token prompt with
nothing in flight and with two pipelined steps in flight, and of the
pool's bookkeeping alone (20 runs each; min, p50, max).

``trace``: chip_smoke.py's default serving pass (4 concurrent requests),
alternately contiguous and paged (N passes, default 4), each server's
``/trace`` read after the batch: per pass the TTFTs, the median span of
each step kind, and the concurrent batch's schedule (claims, prompt
chunks, fused steps; ms from the batch's first submit). Traces land in
``build/chip_smoke/paged_probe/``. Prints the card's name and power limit
first, then one JSON line per result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "chip_smoke", "paged_probe")


def _spread(ts: list) -> dict:
    ts = sorted(ts)
    return {"min": ts[0], "p50": ts[len(ts) // 2], "max": ts[-1]}


def admit(chip_smoke) -> dict:
    import numpy as np
    import torch

    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    model, _ = chip_smoke.ensure_model(chip_smoke.llama32_1b_header(), seed=0)
    config, params = load_params_from_m_quantized(model, load_model_header(model),
                                                  dtype=torch.bfloat16, device="cuda")
    eng = InferenceEngine(config, params, n_lanes=8, device="cuda", paged_kv=True)
    eng.capture_graphs(spec=True)
    prompt = [(13 * i) % 100 + 1 for i in range(1900)]
    for lane in range(4):
        eng.paged_admit(lane, prompt[:40 + lane], config.seq_len)
        eng.prefill(lane, prompt[:40 + lane])
    pos = np.full(8, config.seq_len, np.int64)
    pos[:4] = [40, 41, 42, 43]
    carried = np.where(pos < config.seq_len, -1, pos)
    toks = np.zeros(8, np.int64)
    torch.cuda.synchronize()

    def admit_release():
        eng.paged_admit(6, prompt, config.seq_len)
        eng.paged_finish(6, park=False)

    def pool_only():
        eng.kvpool.admit(6, prompt, config.seq_len)
        eng.kvpool.release(6)

    def timed(fn, in_flight: bool) -> list:
        ts = []
        for _ in range(20):
            if in_flight:
                eng.decode_pipelined(pos, tokens=toks)
                eng.decode_pipelined(carried)
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
            eng.pipeline_flush()
        return ts

    return {"admit_release_ms_idle": _spread(timed(admit_release, False)),
            "admit_release_ms_in_flight": _spread(timed(admit_release, True)),
            "pool_only_ms_in_flight": _spread(timed(pool_only, True))}


SCHEDULE = ("queued", "prefill.sync", "step.sync", "step.fused", "step.spec_fused",
            "prefill.fused")


def trace(chip_smoke, passes: int) -> list:
    model, tok = chip_smoke.ensure_model(chip_smoke.llama32_1b_header(), seed=0)
    os.makedirs(OUT, exist_ok=True)
    out = []
    for i in range(passes):
        args = ("--paged-kv", "on") if i % 2 else ()
        p = chip_smoke.serve_pass(model, tok, None, chip_smoke.GEN_TOKENS, extra_args=args,
                                  name=f"probe{i}",
                                  extra=lambda base: chip_smoke._json_call(base, "/trace")[2])
        with open(os.path.join(OUT, f"trace_{i}.json"), "w") as f:
            json.dump(p["extra"], f)
        spans = [e for e in p["extra"]["traceEvents"] if e.get("ph") == "X"]
        steps = {}
        for e in spans:
            if e["name"].startswith("step."):
                steps.setdefault(e["name"], []).append(e["dur"] / 1e3)
        # the concurrent batch opens with the third submit (after the probe
        # and the greedy request alone)
        submits = sorted(e["ts"] for e in p["extra"]["traceEvents"]
                         if e.get("name") == "submitted")
        t0 = submits[2]
        schedule = [[e["name"], e.get("args", {}).get("request_id"),
                     round((e["ts"] - t0) / 1e3, 1), round(e["dur"] / 1e3, 1)]
                    for e in sorted(spans, key=lambda e: e["ts"])
                    if e["name"] in SCHEDULE and t0 <= e["ts"] <= t0 + 400e3]
        out.append({"pass": i, "args": list(args), "ttft_ms": p["ttft_ms"],
                    "ttft_ms_p50": p["ttft_ms_p50"],
                    "tokens_per_s_batch": p["tokens_per_s_batch"],
                    "step_ms_median": {k: statistics.median(v) for k, v in steps.items()},
                    "steps": {k: len(v) for k, v in steps.items()},
                    "schedule": schedule})
    return out


def main(argv: list) -> int:
    if not argv or argv[0] not in ("admit", "trace"):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if argv[0] == "admit":
        print(json.dumps(admit(chip_smoke)), flush=True)
    else:
        for row in trace(chip_smoke, int(argv[1]) if len(argv) > 1 else 4):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
