"""Staged Q40 probe: where a pass over the packed planes spends its time, on
the card.

The port of ``scripts/stage_probe.py``. A stack of L packed planes
[L, d_in/2, d_out] (drawn on the device from seed 0) streams through
``q40_probe`` at each stage, each adding one step of the dequant chain:

  u8 dma            every tile staged in shared memory by cp.async, one row
                    written (row (half/1024 - 1)*1024 of the last plane, the
                    JAX kernel's last grid step)
  u8 +unpack_i32    byte sums (the JAX stage widened u8 to int32 lanes)
  u8 +nibbles       lo + hi nibble sums
  u8 +convert_f32 / +convert_bf16   the nibbles converted, added in that type
  u8 +scale         lo*s + hi*s with the block's f16 scale
  u32 +nibbles / +convert_*         the same on int32 words of 4 columns

then ``dot_only bf16/f32`` (``dense_dot`` over L dense [d_in, d_out] planes,
x [8, d_in]: the dense stream reference) and ``full f32/bf16w/bf16wx``
(``q40_lab_twodot`` without the −8 correction, x rounded to the W type: on
this card bf16w and bf16wx are one computation, as in the JAX kernel, which
casts x down to w_dtype in both). The reductions sum the whole stack where
the JAX kernels kept their last grid step (``ops/cuda_lab.py``).

Run: python -m distributed_llama_multiusers_tpu_torch.lab.stage_probe
         [d_in] [d_out] [L] [reps] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import torch

from ..ops import cuda_lab as lab
from ..quants.packed import PackedQ40, unpack_q40
from .timing import Lab, parser, q40_planes, randn

CHUNK = 2048  # the JAX grid's d_in per step: the dma stage's tile of CHUNK/2 rows
M = 8
SITE = "scripts/stage_probe.py"

U8_STAGES = [("u8 dma", "dma", ":47"), ("u8 +unpack_i32", "bytes", ":53"),
             ("u8 +nibbles", "nibbles", ":60"), ("u8 +convert_f32", "convert_f32", ":70"),
             ("u8 +convert_bf16", "convert_bf16", ":70"), ("u8 +scale", "scale", ":80")]
U32_STAGES = [("u32 +nibbles", "nibbles", ":113"), ("u32 +convert_f32", "convert_f32", ":124"),
              ("u32 +convert_bf16", "convert_bf16", ":124")]
# (name, W rounding, x rounding): _k_full casts x down to w_dtype
FULL = [("full f32", "f32", False), ("full bf16w", "product_bf16", True),
        ("full bf16wx", "product_bf16", True)]


def run(d_in: int = 4096, d_out: int = 14336, L: int = 8, reps: int = 8, device="cuda",
        plain: bool = False, out=print) -> list:
    lab_run = Lab(f"stage_probe d_in={d_in} d_out={d_out} L={L}", device, reps, plain, out)
    dev = lab_run.device
    half = d_in // 2
    packed, scales = q40_planes(L, d_in, d_out, dev)
    out(f"packed={packed.numel() / 1e6:.1f} MB")
    tile_rows = min(CHUNK // 2, half)
    copy_dst = torch.empty_like(packed)
    flat = packed.view(-1, d_out)
    for name, stage, body in U8_STAGES:
        sc = scales if stage == "scale" else None
        lib = {"dma": (lambda: copy_dst.copy_(packed), "dst.copy_(src)"),
               "bytes": (lambda: flat.sum(0, dtype=torch.int32),
                         "packed.sum(0, dtype=int32)")}.get(stage, (None, None))
        lab_run.measure(
            name, lambda st=stage, sc=sc: lab.q40_probe(packed, st, sc, tile_rows),
            lab.probe_bytes(packed, stage), kernel="q40_probe", site=f"{SITE}:208 ({body})",
            ops=lab.probe_ops(packed, stage),
            plain_fn=lambda st=stage, sc=sc: lab.q40_probe_plain(packed, st, sc, tile_rows),
            library_fn=lib[0], library=lib[1])
    del copy_dst
    p32 = packed.view(torch.int32)  # little-endian words of 4 consecutive d_out bytes
    for name, stage, body in U32_STAGES:
        lab_run.measure(
            name, lambda st=stage: lab.q40_probe(p32, st), lab.probe_bytes(p32, stage),
            kernel="q40_probe", site=f"{SITE}:248 ({body})", ops=lab.probe_ops(p32, stage),
            plain_fn=lambda st=stage: lab.q40_probe_plain(p32, st))

    x = randn((M, d_in), dev, seed=1)
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        wd = randn((L, d_in, d_out), dev, seed=2, dtype=dt)
        xd = x.to(dt)
        nbytes = L * lab.dense_bytes(M, d_in, d_out, wd.element_size(), xd.element_size())
        lab_run.measure(
            f"dot_only {tag}", lambda wd=wd, xd=xd: [lab.dense_dot(xd, w) for w in wd], nbytes,
            kernel="dense_dot", site=f"{SITE}:279", ops=L * 2 * M * d_in * d_out,
            kind="bf16" if tag == "bf16" else "f32",
            plain_fn=lambda wd=wd, xd=xd: [lab.dense_dot_plain(xd, w) for w in wd],
            library_fn=lambda wd=wd, xd=xd: [torch.matmul(xd, w) for w in wd],
            library=f"torch.matmul {tag}")
        del wd

    ws = [(packed[i], scales[i]) for i in range(L)]
    dense = [unpack_q40(PackedQ40(p, s), torch.bfloat16) for p, s in ws]
    xb = x.to(torch.bfloat16)
    for name, w_round, x_round in FULL:
        lab_run.measure(
            name, lambda r=w_round, xr=x_round: [
                lab.q40_lab_twodot(x, p, s, r, xr, correction=False) for p, s in ws],
            L * lab.twodot_bytes(M, d_in, d_out, False), kernel="q40_lab_twodot",
            site=f"{SITE}:309", ops=L * 2 * M * d_in * d_out,
            kind="bf16" if x_round else "f32",
            plain_fn=lambda r=w_round, xr=x_round: [
                lab.q40_lab_twodot_plain(x, p, s, r, xr, False) for p, s in ws],
            library_fn=lambda: [torch.matmul(xb, d) for d in dense],
            library="torch.matmul bf16")
    return lab_run.rows


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], [("d_in", 4096), ("d_out", 14336), ("L", 8),
                                           ("reps", 8)]).parse_args(argv)
    run(args.d_in, args.d_out, args.L, args.reps, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
