#!/usr/bin/env python3
"""Time one checkout of the port on one CUDA card with that checkout's own
chip_smoke.py: the T = 1 attention call at the smoke's serving positions
and with every lane at 2047, the 4-row verify window where the checkout
has one, and the `v4` decode step of the full-width synthetic 1B model.
For a before-and-after
on one card, unpack both trees and run this on each in one command, in
the order parent, change, change, parent:

    python3 tools/measure_tree.py TREE [TREE ...]

Each tree is measured in a process of its own (its package is imported
from the tree), all on one synthetic model: the one under
MEASURE_TREE_MODEL_DIR where that is set, else under the first tree's
build/synthetic. Prints the card's name and power limit, then one
JSON line a tree.
"""

import importlib.util
import json
import os
import subprocess
import sys


def measure(tree: str, model_dir: str) -> dict:
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(tree, "chip_smoke.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    import torch

    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca
    from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_multiusers_tpu_torch.ops import cuda_sample as cs
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    if not os.path.abspath(ca.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"the package came from {ca.__file__}, not {tree}")
    q.build_kernels(q.KERNELS + (rc.KERNEL, cs.KERNEL, ca.KERNEL))
    out = {"tree": tree}
    s_len = m.ATTN_S_LEN
    qf, k, v = m.attn_inputs(torch, 8)
    rows = {"serving": m.attn_serving_positions(torch),
            "long": torch.full((m.DECODE_M, 1), s_len - 1, device="cuda")}
    calls = {name: (lambda pos=pos: ca.decode_attention(qf, k, v, pos, 0.125, s_len))
             for name, pos in rows.items()}
    if getattr(ca, "WINDOW", 1) > 1:
        gen = torch.Generator(device="cuda").manual_seed(11)
        qw = torch.randn((m.DECODE_M, ca.WINDOW, 8, 4, 64), device="cuda", generator=gen)
        pos = m.attn_serving_positions(torch) + torch.arange(ca.WINDOW, device="cuda")[None]
        calls["window"] = lambda: ca.decode_attention(qw, k, v, pos, 0.125, s_len)
    for name, call in calls.items():
        out[f"decode_attn_{name}_ms"] = [m.graph_ms(torch, [call] * 20) for _ in range(3)]
    model, _ = m.ensure_model(m.llama32_1b_header(), seed=0, cache_dir=model_dir)
    config, params = load_params_from_m_quantized(model, load_model_header(model),
                                                  dtype=torch.bfloat16, device="cuda")
    b = m.step_breakdown(torch, q, rc, cs, config, params, "v4")
    out["step_v4"] = {k_: b[k_] for k_ in (
        "step_ms_p50", "device_ms_per_step", "device_busy_share", "q40_kernels_ms_per_step",
        "decode_attn_ms_per_step", "device_ops_per_step") if k_ in b}
    return out


def main() -> None:
    trees = [os.path.abspath(a) for a in sys.argv[1:] if a != "--one"]
    if not trees:
        raise SystemExit(__doc__)
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        tree = os.path.abspath(sys.argv[2])
        print(json.dumps(measure(tree, os.environ["MEASURE_TREE_MODEL_DIR"])), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    env = dict(os.environ)
    env.setdefault("MEASURE_TREE_MODEL_DIR", os.path.join(trees[0], "build", "synthetic"))
    for tree in trees:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree], cwd=tree,
                           env=env)
        if r.returncode:
            raise SystemExit(f"{tree}: exit {r.returncode}")


if __name__ == "__main__":
    main()
