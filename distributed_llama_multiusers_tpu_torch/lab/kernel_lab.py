"""Kernel lab: Q40 matmul variants over a stack of L planes, on the card.

The port of ``scripts/kernel_lab.py``. Each variant is one pass of an
m-row product over L layer-like Q40 planes of [d_in, d_out] (the default is
the Llama-3.1-8B w1/w3 site, 8 planes: 235 MB packed, beyond the L2):

- ``v0_current``: the serving ``q40_matmul`` (its configured mode; v4 on a
  bf16 dot by default).
- ``v1_*`` (``_v1_kernel``) and ``v2_*`` (``_v2_kernel``, planes pre-tiled
  by ``retile`` to [J, half, 512]) on ``q40_lab_twodot``: ``f32`` exact;
  ``bf16w`` the f32 product rounded to bf16 with x kept f32; ``bf16wx`` the
  same with x rounded to bf16; v2's ``bf16`` the bf16 chain. A ``_cN``
  variant pins one thread block's d_in range (the split-K chunk) to N; the
  JAX lab's d_out tile widths are TPU VMEM geometry with no counterpart
  (a thread block always covers 512 columns), so the variants that differed
  only in them are one variant here.
- ``dense_bf16``: ``torch.matmul`` over the pre-dequantized bf16 planes, the
  library yardstick (in place of ``dense_bf16_xla``).
- ``read_probe``: ``q40_probe``'s byte sums over the whole packed stack (the
  JAX probe read one plane, which on this card would replay from L2).

A correctness check first holds v0, v1 f32, v1 bf16wx and v2 f32 against
``q40_matmul_dense`` on plane 0 (relative error under 2e-2, the lab's
gate); a failure ends the run. Weights are drawn on the device from seed 0.

Run: python -m distributed_llama_multiusers_tpu_torch.lab.kernel_lab
         [m] [d_in] [d_out] [L] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import torch

from ..ops import cuda_lab as lab
from ..ops import cuda_q40 as q
from ..quants.packed import PackedQ40, q40_matmul_dense, unpack_q40
from .timing import Lab, parser, q40_planes, randn

SITE = "scripts/kernel_lab.py"
REL_GATE = 2e-2


def run(m: int = 1, d_in: int = 4096, d_out: int = 14336, L: int = 8, device="cuda",
        reps: int = 5, plain: bool = False, out=print) -> list:
    lab_run = Lab(f"kernel_lab m={m} d_in={d_in} d_out={d_out} L={L}", device, reps, plain, out)
    dev = lab_run.device
    packed, scales = q40_planes(L, d_in, d_out, dev)
    ws = [PackedQ40(packed[i], scales[i]) for i in range(L)]
    x = randn((m, d_in), dev, seed=1)
    bsum = q._block_sums(x)
    tiled = [lab.retile(w.packed, w.scales) for w in ws]
    wbytes = L * lab.twodot_bytes(m, d_in, d_out, True)
    out(f"weights={L * (d_in * d_out // 2 + (d_in // 32) * d_out * 2) / 1e9:.3f} GB packed+scales")

    ref = q40_matmul_dense(x, ws[0]).float()
    scale = float(ref.abs().max()) + 1e-9
    for name, f in [("v0", lambda: q.q40_matmul(x, ws[0])),
                    ("v1", lambda: lab.q40_lab_twodot(x, ws[0].packed, ws[0].scales,
                                                      bsum=bsum)),
                    ("v1_bf16", lambda: lab.q40_lab_twodot(x, ws[0].packed, ws[0].scales,
                                                           "product_bf16", True, bsum=bsum)),
                    ("v2", lambda: lab.q40_lab_twodot(x, *tiled[0], bsum=bsum))]:
        err = float((f().float() - ref).abs().max()) / scale
        out(f"{name} rel err vs dense: {err:.2e}")
        if not err < REL_GATE:
            raise RuntimeError(f"kernel_lab: {name} is {err:.2e} off the dense product")

    def twodot(name, w_round, x_round, tiles=False, k_chunk=None, site=":127"):
        planes = tiled if tiles else [(w.packed, w.scales) for w in ws]
        kind = "bf16" if x_round and w_round != "f32" else "f32"
        lab_run.measure(
            name, lambda: [lab.q40_lab_twodot(x, p, s, w_round, x_round, bsum=bsum,
                                              k_chunk=k_chunk) for p, s in planes],
            wbytes, kernel="q40_lab_twodot", site=SITE + site, ops=L * 2 * m * d_in * d_out,
            kind=kind,
            plain_fn=lambda: [lab.q40_lab_twodot_plain(x, p, s, w_round, x_round, True, bsum)
                              for p, s in planes],
            library_fn=library, library="torch.matmul bf16")

    dense = [unpack_q40(w, torch.bfloat16) for w in ws]
    xb = x.to(torch.bfloat16)

    def library():
        return [torch.matmul(xb, d) for d in dense]

    dot = q.default_dot_dtype(dev)
    mode = q.resolve_kernel_mode(m, d_in, d_out, dot)
    acts = q.make_q80_acts(x)

    def v0_plain(w):
        if mode == "i8blockdot":
            return q.q40_i8blockdot_plain(acts, w)
        if mode == "blockdot":
            return q.q40_blockdot_plain(x, w, bsum=bsum)
        return q.q40_slab_plain(x, w, dot, mode, bsum=bsum)

    lab_run.measure("v0_current", lambda: [q.q40_matmul(x, w) for w in ws],
                    L * q.bound_bytes(m, d_in, d_out, mode, x_bytes=4),
                    kernel={"i8blockdot": "q40_i8blockdot", "blockdot": "q40_blockdot"}.get(
                        mode, "q40_slab"),
                    site="distributed_llama_multiusers_tpu/ops/pallas_q40.py:654",
                    ops=L * 2 * m * d_in * d_out, kind="int8" if mode == "i8blockdot" else "bf16",
                    plain_fn=lambda: [v0_plain(w) for w in ws], library_fn=library,
                    library="torch.matmul bf16", note=f"mode {mode}")
    twodot("v1_f32", "f32", False)
    twodot("v1_bf16w", "product_bf16", False)
    twodot("v1_bf16wx", "product_bf16", True)
    for c in (4096, 2048, 1024):
        if d_in % c == 0:
            twodot(f"v1_bf16wx_c{c}", "product_bf16", True, k_chunk=c)
    if d_out % 512 == 0:
        twodot("v2_tiled_f32", "f32", False, tiles=True, site=":234")
        twodot("v2_tiled_bf16", "chain_bf16", True, tiles=True, site=":234")
        if d_in % 4096 == 0:
            twodot("v2_tiled_bf16_c4096", "chain_bf16", True, tiles=True, k_chunk=4096,
                   site=":234")
    lab_run.measure("dense_bf16", library, L * lab.dense_bytes(m, d_in, d_out, 2, 2),
                    ops=L * 2 * m * d_in * d_out, kind="bf16",
                    note="torch.matmul, the library yardstick")
    flat = packed.view(-1, d_out)
    lab_run.measure("read_probe", lambda: lab.q40_probe(packed, "bytes"),
                    lab.probe_bytes(packed, "bytes"), kernel="q40_probe", site=SITE + ":287",
                    plain_fn=lambda: lab.q40_probe_plain(packed, "bytes"),
                    library_fn=lambda: flat.sum(0, dtype=torch.int32),
                    library="packed.sum(0, dtype=int32)")
    return lab_run.rows


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], [("m", 1), ("d_in", 4096), ("d_out", 14336),
                                           ("L", 8)]).parse_args(argv)
    run(args.m, args.d_in, args.d_out, args.L, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
