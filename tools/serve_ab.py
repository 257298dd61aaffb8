#!/usr/bin/env python3
"""The default serving pass of chip_smoke.py (``serve_pass``: v4, the
serving defaults, 4 concurrent requests of 64 tokens) on one CUDA card,
for several checkouts of the port in turns, each pass a fresh server run
by that checkout's own chip_smoke.py on one synthetic model:

    python3 tools/serve_ab.py TREE[+ARG,ARG...] [TREE[+ARG,...] ...]

``TREE+--prefix-min-tokens,0`` passes server flags to that tree's passes.
Give the trees in alternating order (parent, change, change, parent, ...)
to compare them within one call. The model is this checkout's
``build/synthetic`` one. Prints the card's name and power limit, then one
JSON line a pass (batch tok/s, TTFT, decode tok/s a request, prefix hits
where the tree counts them).
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("tokens_per_s_batch", "batch_s", "ttft_ms", "ttft_ms_p50", "decode_tok_s_per_request",
        "prefix_hits", "prefix_tokens_saved", "n_tokens")


def main(argv: list) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    model, tok = chip_smoke.ensure_model(chip_smoke.llama32_1b_header(), seed=0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for i, spec in enumerate(argv):
        tree, _, flags = spec.partition("+")
        tree = os.path.abspath(tree)
        extra = [f for f in flags.split(",") if f]
        code = (f"import sys, json\nsys.path.insert(0, {tree!r})\nimport chip_smoke as c\n"
                f"p = c.serve_pass({model!r}, {tok!r}, None, 64, extra_args={extra!r}, "
                f"name='ab{i}')\n"
                f"print('RESULT ' + json.dumps({{k: p.get(k) for k in {KEYS!r}}}))\n")
        r = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                           text=True, timeout=900)
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        if r.returncode != 0 or not line:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr, flush=True)
            return 1
        print(json.dumps({"tree": tree, "args": extra, **json.loads(line[0][7:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
