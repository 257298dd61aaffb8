"""`dllama-api` entry point of the port: the multi-user HTTP server on one
CUDA device, or tensor parallel over several (``--workers N``), backed by
the continuous-batching scheduler.

    python -m distributed_llama_multiusers_tpu_torch.app.dllama_api \\
        --model m.m --tokenizer t.t --port 9990 [--device cuda] [--dequant auto]
        [--workers 2 --device cuda:0,cuda:1] [--buffer-float-type q80]
        [--journal-path j.bin [--recover-journal]] [--reconnect-grace 30]

SIGTERM drains: /health flips to 503, new requests shed, in-flight work
finishes, the span ring is written to ``--trace-path`` where given, the
stream registry, the journal's writer and the recovery thread are joined,
then the process exits 0. ``DLLAMA_FAULTS`` arms the seeded fault plan
(``utils/faults.py``) when the scheduler starts.

Crash durability: ``--journal-path`` journals every admission and ending;
after a crash, ``--recover-journal`` replays the unfinished requests through
the normal admission path (paced behind the circuit breaker), and with
``--reconnect-grace`` > 0 their clients reattach with ``GET /v1/stream/<id>``
and ``Last-Event-ID``.
"""

from __future__ import annotations

import os
import signal
import threading

from ..server import ApiServer
from ..serving import StreamRegistry, recover_scheduler
from ..tokenizer import template_type_from_name
from .args import build_parser
from .runtime_setup import load_stack, log, make_scheduler


def main(argv=None) -> None:
    args = build_parser("dllama-api", api=True).parse_args(argv)
    _, _, tokenizer, engine = load_stack(args)
    scheduler = make_scheduler(engine, tokenizer, args)
    # resumable SSE (serving/resume.py) with --reconnect-grace > 0; journal
    # recovery registers its resumed streams here too
    registry = None
    if args.reconnect_grace > 0:
        registry = StreamRegistry(grace_s=args.reconnect_grace)
        log("🔁", f"SSE reconnect grace: {args.reconnect_grace:.0f}s "
                  "(GET /v1/stream/<id> + Last-Event-ID)")
    # crash recovery (serving/recovery.py): the journal's in-flight set
    # replays through the normal admission path, paced behind the breaker
    recovery = None
    if args.recover_journal and args.journal_path:
        recovery = recover_scheduler(scheduler, args.journal_path, registry=registry)
        n = len(recovery.entries)
        log("📓", f"Journal recovery: {n} incomplete request(s) replaying"
                  + ("" if registry is not None or n == 0 else
                     " (no --reconnect-grace: regenerating without stream reattach)"))
    server = ApiServer(scheduler, tokenizer, model_name=os.path.basename(args.model),
                       template_type=template_type_from_name(args.chat_template),
                       resume=registry)
    httpd = server.serve(host=args.host, port=args.port)
    log("⭐", f"Server listening on {args.host}:{args.port} ({engine.n_lanes} lanes, "
              f"{engine.device})")

    def _sigterm(*_):
        log("⭐", "SIGTERM: draining (health 503, admissions shedding)")
        scheduler._draining.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    def _sigint(*_):
        log("⭐", "Shutting down")
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigint)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # keep answering (503 on /health, sheds on POST) while in-flight
        # work drains, then close the socket
        accept_loop = threading.Thread(target=httpd.serve_forever, daemon=True)
        accept_loop.start()
        try:
            log("⭐", "Draining in-flight requests (30s window)")
            if recovery is not None:
                recovery.stop()  # no new replays into a draining server
            clean = scheduler.drain(timeout=30.0)
            log("⭐", "Drained" if clean else "Drain window passed; cancelled the rest")
        finally:
            httpd.shutdown()
            httpd.server_close()
            if registry is not None:
                registry.close()
            if scheduler.journal is not None:
                # drain() flushed it; close the writer and the file
                scheduler.journal.close()
            if args.trace_path:
                # the drained server's span ring, the document GET /trace served
                try:
                    scheduler.telemetry.dump_trace(args.trace_path)
                    log("⭐", f"Trace written to {args.trace_path}")
                except OSError as e:
                    log("⚠️", f"trace dump failed: {e}")


if __name__ == "__main__":
    main()
