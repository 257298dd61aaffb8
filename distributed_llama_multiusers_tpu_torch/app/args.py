"""CLI argument surface of the port's entry points, ``dllama`` (inference,
chat, worker) and ``dllama-api``: the flags the port serves so far; the
JAX package's ``app/args.py`` is the full set."""

from __future__ import annotations

import argparse

from ..parallel import MeshPlan

# the JAX package's dequant knob, mirrored (ops/cuda_q40.SELECTABLE_MODES)
DEQUANT_CHOICES = ("auto", "v4", "bf16chain", "repeat", "u8chain", "blockdot",
                   "i8blockdot")


def build_parser(prog: str, api: bool | None = None) -> argparse.ArgumentParser:
    """The JAX package's ``build_parser(prog, api)``: ``api`` False adds
    ``dllama``'s positional mode and makes ``--temperature``, ``--topp`` and
    ``--seed`` take effect; the server accepts and ignores them (sampling
    is per request). ``api`` None: the server's surface when ``prog`` is
    ``dllama-api``."""
    if api is None:
        api = prog == "dllama-api"
    p = argparse.ArgumentParser(prog=prog)
    if not api:
        p.add_argument("mode", choices=["inference", "chat", "worker", "train"],
                       help="run mode: inference (a prompt, then --steps tokens), "
                            "chat (turns from stdin), worker (a multi-process "
                            "mesh member; not ported yet, prints guidance), "
                            "train (not ported yet; refused)")
        p.add_argument("--prompt", default=None,
                       help="inference: the prompt (default 'Hello'); chat: the "
                            "system message of the first turn")
        p.add_argument("--steps", type=int, default=64,
                       help="tokens to generate (inference mode)")
        p.add_argument("--benchmark", action="store_true",
                       help="print a per-token Pred line (and on a mesh its Sync "
                            "bytes: the ring hop's bytes of a decode step, counted "
                            "by the hop kernel, where the JAX package reckons "
                            "collectives from the compiled program) and, on a "
                            "mesh, a Measured/step line whose Sync time is the "
                            "ring_hop kernels' device time under torch.profiler "
                            "(the JAX package reads an XLA trace)")
        p.add_argument("--temperature", type=float, default=0.8,
                       help="sampling temperature (0: greedy, with prompt-lookup "
                            "speculation unless --no-spec)")
        p.add_argument("--topp", type=float, default=0.9, help="nucleus top-p")
        p.add_argument("--seed", type=int, default=None,
                       help="sampler seed (inference: 12345 when unset; chat: OS "
                            "entropy when unset)")
    p.add_argument("--model", required=api, help="path to .m model file")
    p.add_argument("--tokenizer", required=api, help="path to .t tokenizer file")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; there is no "
                        "silent fall back — pass 'cpu' to run on the CPU). With "
                        "--workers N: one device for every rank ('cpu'; 'cuda' "
                        "= cuda:0..cuda:N-1) or a comma list with one per rank; "
                        "a card serves several ranks only where the list names "
                        "it each time (cuda:0,cuda:0)")
    p.add_argument("--workers", nargs="*", default=None,
                   help="tensor-parallel ranks: a count (2 -> tp2) or a mesh "
                        "spec (tp2); this port serves pure TP")
    p.add_argument("--ring-sync", default="on", choices=["on", "off"],
                   help="TP mesh: sync the wo/w2 outputs through the ring "
                        "reduce-scatter + all-gather interleaved with the "
                        "product (default); 'off': a local partial and a ring "
                        "all-reduce (or the Q80 reduce-scatter + gather with "
                        "--buffer-float-type q80)")
    p.add_argument("--buffer-float-type", default="f32", choices=["f32", "q80"],
                   help="q80: emulate the reference's Q80 activation casts and, "
                        "on a TP mesh whose shards hold whole blocks, ship the "
                        "wo/w2 sync as int8 + f16 scales")
    p.add_argument("--max-seq-len", type=int, default=0,
                   help="clamp the context length (0: the model's)")
    p.add_argument("--weights", default="auto", choices=["auto", "packed", "dense"],
                   help="Q40 models: 'packed' keeps int4+scales resident on the "
                        "device with dequant-in-matmul kernels; 'dense' "
                        "dequantizes at load. auto = packed on CUDA, dense on "
                        "the CPU")
    p.add_argument("--max-lanes", type=int, default=8,
                   help="concurrent request lanes (continuous batching)")
    p.add_argument("--kv-dtype", default="auto", choices=["auto", "bf16", "f32"],
                   help="KV cache dtype: auto = bf16 on CUDA, f32 on the CPU")
    p.add_argument("--chat-template", default=None,
                   choices=[None, "llama2", "llama3", "deepSeek3", "chatml"])
    p.add_argument("--dequant", default=None, choices=DEQUANT_CHOICES,
                   help="Q40 dequant arithmetic for the bf16 dot "
                        "(DLLAMA_DEQUANT env equivalent; default v4). 'auto' "
                        "resolves the mode per (d_in, d_out, m-class) site "
                        "from ops/dequant_table.json; an f32 dot (the CPU) "
                        "always runs v4")
    p.add_argument("--multi-step", type=int, default=None,
                   help="serving: chain up to this many decode steps per "
                        "device dispatch in steady-state decode (identical "
                        "token streams, 1/h the per-token dispatch "
                        "overhead); 0 disables; default: scheduler "
                        "default (8)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="serving: async decode pipeline — bound on "
                        "dispatched-but-unconsumed decode steps. Step k+1 "
                        "dispatches from the on-device token carry while "
                        "step k's host readback (detokenize, stream, "
                        "stop/EOS checks) runs one step behind, overlapped "
                        "with device execution; token streams stay "
                        "byte-identical to synchronous stepping. 0 or 1 "
                        "disables; default: engine default (2)")
    p.add_argument("--fused-prefill", default="on", choices=["on", "off"],
                   help="serving: stall-free admissions — a queued request "
                        "claims a lane inside the live async decode chain "
                        "and its prompt chunks ride fused prefill+decode "
                        "dispatches (one step advances every decoding lane "
                        "one token AND consumes one bounded prompt chunk), "
                        "so admissions never flush the pipeline and "
                        "pipeline_flushes stays ~0 under churn. 'off' "
                        "restores the pre-fused behavior: an admission "
                        "exits the chain to the synchronous admit+prefill "
                        "path")
    p.add_argument("--no-spec", action="store_true",
                   help="serving and greedy dllama runs: turn off prompt-lookup "
                        "speculative decoding "
                        "(on by default: a greedy lane whose history drafts "
                        "verifies up to SPEC_DRAFT + 1 tokens in one forward, "
                        "inside the pipelined chain). Up to 8 lanes a greedy "
                        "stream is the same either way (a verify step's rows "
                        "give a decode step's bits; checked on the card at 1, "
                        "2, 4 and 8 lanes). Above 8 lanes a verify step's "
                        "products pass 32 rows, where the k-split plan and, "
                        "under the blockdot modes, the kernel change, so a "
                        "stream may part from the --no-spec one at a near-tie")
    # the JAX server's QoS and observability surface (serving/, telemetry/)
    p.add_argument("--max-queue", type=int, default=256,
                   help="serving: max requests waiting for a lane before "
                        "submissions are shed with HTTP 429 + Retry-After "
                        "(bounded admission; 0 = unbounded)")
    p.add_argument("--queue-timeout", type=float, default=0.0,
                   help="serving: seconds a request may wait queued before "
                        "finishing with finish_reason=timeout instead of "
                        "holding the client open (0 disables)")
    p.add_argument("--request-budget", type=float, default=0.0,
                   help="serving: wall-clock seconds a request may spend "
                        "generating after admission; exceeding it finishes "
                        "with finish_reason=timeout and frees the lane "
                        "(0 disables)")
    p.add_argument("--step-deadline", type=float, default=None,
                   help="serving: failure-containment watchdog — if a "
                        "blocking engine step makes no progress for this "
                        "many seconds, trip the circuit breaker (/health "
                        "503, new work shed) and abort the async chain; a "
                        "kernel on the card is not cancelled. Default: "
                        "DLLAMA_STEP_DEADLINE env, else off (0)")
    p.add_argument("--prefix-min-tokens", type=int, default=None,
                   help="serving: reuse resident lane KV when a new request "
                        "shares at least this many leading prompt tokens, in "
                        "whole prompt chunks of the largest prefill bucket "
                        "(per-lane prefix cache: the lane's KV is copied and "
                        "only the tail prefilled, so the stream is a cold "
                        "prefill's); 0 disables; default: scheduler default "
                        "(16)")
    # crash-durable serving (serving/journal.py, recovery.py, resume.py)
    p.add_argument("--journal-path", default=None,
                   help="serving: append-only CRC-framed request journal "
                        "(crash durability) — admitted requests with "
                        "their resolved sampler seeds plus periodic "
                        "delivery watermarks, written by a background "
                        "thread off the hot path. Off by default; pair "
                        "with --recover-journal to resume after a crash")
    p.add_argument("--recover-journal", action="store_true",
                   help="serving: on startup, replay the --journal-path "
                        "journal — every admitted-but-unfinished request "
                        "is re-admitted and regenerated from its prompt "
                        "with the same seed (byte-identical streams); "
                        "re-admission is paced through the circuit "
                        "breaker so recovery cannot stampede a freshly "
                        "restarted engine")
    p.add_argument("--reconnect-grace", type=float, default=0.0,
                   help="serving: seconds a disconnected SSE client may "
                        "reattach (GET /v1/stream/<id> with "
                        "Last-Event-ID) before the request is cancelled; "
                        "while the window is open the request keeps "
                        "generating into a bounded delta buffer. 0 "
                        "(default) preserves cancel-on-disconnect")
    p.add_argument("--trace-path", default=None,
                   help="serving: write the request-lifecycle span ring as "
                        "Chrome trace-event JSON (Perfetto / chrome://tracing "
                        "loadable) to this path when the server drains; the "
                        "live ring is always at GET /trace and metrics at GET "
                        "/metrics")
    p.add_argument("--port", type=int, default=9990)
    p.add_argument("--host", default="0.0.0.0")
    # the JAX package's command line, accepted and ignored: the server
    # samples per request, and the reference's thread and GPU knobs mean
    # nothing here
    p.add_argument("--nthreads", type=int, default=1, help=argparse.SUPPRESS)
    if api:
        p.add_argument("--temperature", type=float, default=0.8, help=argparse.SUPPRESS)
        p.add_argument("--topp", type=float, default=0.9, help=argparse.SUPPRESS)
        p.add_argument("--seed", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--gpu-index", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--gpu-segments", default=None, help=argparse.SUPPRESS)
    p.add_argument("--net-turbo", type=int, default=1, help=argparse.SUPPRESS)
    return p


def parse_mesh_spec(workers: list[str] | None):
    """--workers '8' -> tp=8 (the reference's pure TP); 'dp2,tp2,sp2,ep2' ->
    explicit axes."""
    if not workers:
        return None
    spec = workers[0]
    if spec.isdigit():
        return MeshPlan(tp=int(spec))
    plan = {"dp": 1, "tp": 1, "sp": 1, "ep": 1, "pp": 1}
    for part in spec.split(","):
        for axis in plan:
            if part.startswith(axis):
                plan[axis] = int(part[len(axis):])
                break
        else:
            raise ValueError(f"bad mesh spec part {part!r}")
    return MeshPlan(**plan)
