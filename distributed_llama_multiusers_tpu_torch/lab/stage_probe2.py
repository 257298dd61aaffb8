"""Slab-layout probe: the packed plane pre-tiled per output tile, on the card.

The port of ``scripts/stage_probe2.py``. One Q40 plane (drawn on the device
from seed 0) is pre-tiled to the slab layout [J, d_in/2, T] (one output
tile = one contiguous slab) and copied L times into a real [L, J, half, T]
stack (the JAX script's ``np.broadcast_to`` becomes ``.repeat``: a view of
one plane would be timed out of the L2). For each T in 512, 1024, 2048:

  slab T=… dma            ``q40_probe`` dma stage (row 0 of the last plane)
  slab T=… dequant+scale  ``q40_probe`` scale stage
  slab T=… full f32       ``q40_lab_twodot`` on the tiled planes, no −8
                          correction, exact f32
  slab T=… full bf16      the same with W and x rounded to bf16

then ``wide rows=… dma``: the dma stage over the row-major stack
[L, half, d_out] with row blocks of 256, 512, 1024 (the row written is the
last block's first, as the JAX kernel's last grid step).

Run: python -m distributed_llama_multiusers_tpu_torch.lab.stage_probe2
         [d_in] [d_out] [L] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import torch

from ..ops import cuda_lab as lab
from ..quants.packed import PackedQ40, unpack_q40
from .timing import Lab, parser, q40_planes, randn

M = 8
SITE = "scripts/stage_probe2.py"
SLABS = (512, 1024, 2048)
WIDE_ROWS = (256, 512, 1024)


def run(d_in: int = 4096, d_out: int = 14336, L: int = 8, reps: int = 8, device="cuda",
        plain: bool = False, out=print) -> list:
    lab_run = Lab(f"stage_probe2 d_in={d_in} d_out={d_out} L={L}", device, reps, plain, out)
    dev = lab_run.device
    half = d_in // 2
    packed, scales = q40_planes(1, d_in, d_out, dev)
    p, s = packed[0], scales[0]
    out(f"packed={L * p.numel() / 1e6:.1f} MB")
    x = randn((M, d_in), dev, seed=1)
    dense = unpack_q40(PackedQ40(p, s), torch.bfloat16)
    xb = x.to(torch.bfloat16)

    def library():
        return [torch.matmul(xb, dense) for _ in range(L)]

    for T in SLABS:
        if d_out % T:
            continue
        pt, st = lab.retile(p, s, T)
        slab = pt.unsqueeze(0).repeat(L, 1, 1, 1)
        slab_s = st.unsqueeze(0).repeat(L, 1, 1, 1)
        dst = torch.empty_like(slab)
        lab_run.measure(f"slab T={T} dma", lambda slab=slab: lab.q40_probe(slab, "dma"),
                        lab.probe_bytes(slab, "dma"), kernel="q40_probe", site=f"{SITE}:107",
                        plain_fn=lambda slab=slab: lab.q40_probe_plain(slab, "dma"),
                        library_fn=lambda d=dst, slab=slab: d.copy_(slab),
                        library="dst.copy_(src)")
        del dst
        lab_run.measure(f"slab T={T} dequant+scale",
                        lambda slab=slab, slab_s=slab_s: lab.q40_probe(slab, "scale", slab_s),
                        lab.probe_bytes(slab, "scale"), kernel="q40_probe", site=f"{SITE}:129",
                        ops=lab.probe_ops(slab, "scale"),
                        plain_fn=lambda slab=slab, slab_s=slab_s: lab.q40_probe_plain(
                            slab, "scale", slab_s))
        for tag, w_round, x_round in (("f32", "f32", False), ("bf16", "product_bf16", True)):
            lab_run.measure(
                f"slab T={T} full {tag}",
                lambda slab=slab, slab_s=slab_s, r=w_round, xr=x_round: [
                    lab.q40_lab_twodot(x, slab[i], slab_s[i], r, xr, correction=False)
                    for i in range(L)],
                L * lab.twodot_bytes(M, d_in, d_out, False), kernel="q40_lab_twodot",
                site=f"{SITE}:165", ops=L * 2 * M * d_in * d_out, kind=tag,
                plain_fn=lambda slab=slab, slab_s=slab_s, r=w_round, xr=x_round: [
                    lab.q40_lab_twodot_plain(x, slab[i], slab_s[i], r, xr, False)
                    for i in range(L)],
                library_fn=library, library="torch.matmul bf16")
        del slab, slab_s

    stacked = p.unsqueeze(0).repeat(L, 1, 1)
    dst = torch.empty_like(stacked)
    for rows in WIDE_ROWS:
        if rows > half:
            continue
        lab_run.measure(f"wide rows={rows} dma",
                        lambda rows=rows: lab.q40_probe(stacked, "dma", tile_rows=rows),
                        lab.probe_bytes(stacked, "dma"), kernel="q40_probe", site=f"{SITE}:196",
                        plain_fn=lambda rows=rows: lab.q40_probe_plain(stacked, "dma",
                                                                       tile_rows=rows),
                        library_fn=lambda: dst.copy_(stacked), library="dst.copy_(src)")
    return lab_run.rows


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], [("d_in", 4096), ("d_out", 14336),
                                           ("L", 8)]).parse_args(argv)
    run(args.d_in, args.d_out, args.L, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
