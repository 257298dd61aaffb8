"""`dllama-router` entry point: the fleet front-end (fleet/router.py).

One model-free process above N `dllama-api` replicas: prefix-affine
consistent-hash routing (same-system-prompt sessions land on the replica
holding the warm paged-KV prefix), least-loaded placement from each
replica's /load scrape, typed shed handling with honored Retry-After,
and journal-based live migration so drains, rolling restarts and replica
death shed zero requests; long prompts hand off from a ``--role prefill``
replica to a decode replica with a KV-page bundle (the JAX package's
docs/SERVING.md "Fleet serving" and docs/DISAGG.md describe both).

Deliberately import-light: no torch, no numpy, no model loading — the
router starts in milliseconds and can front replicas of either package::

    python -m distributed_llama_multiusers_tpu_torch.app.dllama_router \
        --replicas 127.0.0.1:8081 127.0.0.1:8082 --port 8080
"""

from __future__ import annotations

import signal
import threading

from ..disagg.prefill import DEFAULT_LONG_PROMPT_CHARS
from ..fleet import FleetRouter
from ..fleet.balancer import DEFAULT_AFFINITY_BLOCKS, DEFAULT_BLOCK_CHARS
from .args import build_router_parser


def log(emoji: str, msg: str) -> None:
    # runtime_setup.log without the torch import chain
    print(f"{emoji} {msg}", flush=True)


def main(argv=None) -> None:
    args = build_router_parser().parse_args(argv)
    block_chars = (
        DEFAULT_BLOCK_CHARS if args.affinity_block_chars is None
        else args.affinity_block_chars
    )
    blocks = (
        DEFAULT_AFFINITY_BLOCKS if args.affinity_blocks is None
        else args.affinity_blocks
    )
    threshold = (
        DEFAULT_LONG_PROMPT_CHARS if args.disagg_threshold is None
        else args.disagg_threshold
    )
    router = FleetRouter(
        list(args.replicas),
        affinity_block_chars=max(1, block_chars),
        affinity_blocks=max(0, blocks),
        scrape_interval_s=args.scrape_interval,
        migration=args.migration == "on",
        disagg=threshold > 0,
        long_prompt_chars=threshold,
    ).start()
    router.scrape_once()  # first routing decision sees real load state
    httpd = router.serve(host=args.host, port=args.port)
    log("⭐", f"Router listening on {args.host}:{args.port} over "
              f"{len(args.replicas)} replica(s): {', '.join(args.replicas)}")
    log("🧭", "prefix affinity "
              + (f"on ({blocks} x {block_chars} chars)" if blocks > 0
                 else "off")
              + f"; migration {args.migration}"
              + f"; disagg "
              + (f"on (long >= {threshold} chars -> prefill replicas)"
                 if threshold > 0 else "off"))

    def _sigterm(*_):
        log("⭐", "SIGTERM: router stopping (in-flight streams finish)")
        # shutdown() must come from another thread (serve_forever runs on
        # this one); nothing joins the helper
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        log("⭐", "Shutting down")
    finally:
        httpd.shutdown()
        router.close()


if __name__ == "__main__":
    main()
