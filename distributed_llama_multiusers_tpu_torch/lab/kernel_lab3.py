"""Kernel lab 3: the serving Q40 kernels' modes at M = 8, on the card.

The port of ``scripts/kernel_lab3.py``. Its Pallas bodies are the serving
modes' products, so each variant runs the serving kernel that computes the
same function (``tests/test_torch_lab.py`` holds each against the JAX
body in interpret mode), one product per plane over L planes of
[d_in, d_out], x f32 [8, d_in], f32 out:

  full_v4          q40_slab, v4 (f32 dequant rounded to bf16, bf16 x)
  full_bf16chain   q40_slab, the bf16 chain
  full_repeat      q40_slab, the bf16 chain  } the same kernel as bf16chain:
  full_u8nib       q40_slab, the bf16 chain  } repeat and u8nib were other
                                               TPU schedules of its values
  full_blockdot    q40_blockdot
  full_i8blockdot  q40_i8blockdot, fed the lab's Q80 operands
                   (``cuda_lab.quantize_x_blocks``)

and two library measurements in plain torch ops over the same packed
bytes, in place of the XLA int4 probes: ``torch_int4_raw`` (nibbles − 8 to
bf16, then ``torch.matmul``) and ``torch_int4_scaled`` (the same with the
scales applied in bf16).

``--check`` holds every variant against the numpy oracle on the JAX lab's
own check inputs (relative error < 2e-2; i8blockdot < 5e-2) and, on the
card, against its plain version (max|Δ| ≤ 1e-4·max|plain|); a failure
raises, and the run exits non-zero. ``--adopt`` times the variants, re-runs the check and records
the fastest verified mode for (d_in, d_out, decode) in the port's selection
table (``ops/dequant_select.record_win``), which the next serving start
reads. Weights are drawn on the device from seed 0.

Run: python -m distributed_llama_multiusers_tpu_torch.lab.kernel_lab3
         [d_in] [d_out] [L] [reps] [--check] [--adopt] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import cuda_lab as lab
from ..ops import cuda_q40 as q
from ..quants.packed import PackedQ40, unpack_q40
from ..device import resolve_device
from .timing import Lab, parser, q40_planes, randn

M = 8
SITE = "scripts/kernel_lab3.py"
PLAIN_TOL = 1e-4

# variant -> (serving kernel, mode, JAX body); _call_kernel :346, main :459
VARIANTS = {
    "full_v4": ("q40_slab", "v4", ":76"),
    "full_bf16chain": ("q40_slab", "bf16chain", ":100"),
    "full_repeat": ("q40_slab", "repeat", ":125"),
    "full_u8nib": ("q40_slab", "u8chain", ":238"),
    "full_blockdot": ("q40_blockdot", "blockdot", ":149"),
    "full_i8blockdot": ("q40_i8blockdot", "i8blockdot", ":177"),
}
# lab variant -> the selection table's mode, for --adopt
ADOPT_MODES = {name: mode for name, (_, mode, _) in VARIANTS.items()}
GATES = {name: (5e-2 if mode == "i8blockdot" else 2e-2) for name, (_, mode, _) in VARIANTS.items()}


def product(name: str, acts, acts8, w: PackedQ40) -> torch.Tensor:
    """Variant ``name``'s product through its serving kernel."""
    kernel, mode, _ = VARIANTS[name]
    if kernel == "q40_slab":
        return q.q40_slab(acts, w, torch.bfloat16, mode)
    if kernel == "q40_blockdot":
        return q.q40_blockdot(acts, w)
    return q.q40_i8blockdot(acts8, w)


def product_plain(name: str, acts, acts8, w: PackedQ40) -> torch.Tensor:
    kernel, mode, _ = VARIANTS[name]
    if kernel == "q40_slab":
        return q.q40_slab_plain(acts.x2, w, torch.bfloat16, mode, bsum=acts.bsum)
    if kernel == "q40_blockdot":
        return q.q40_blockdot_plain(acts.x2, w, bsum=acts.bsum)
    return q.q40_i8blockdot_plain(acts8, w)


def int4_dense(w: PackedQ40, scaled: bool) -> torch.Tensor:
    """Torch ops over the packed bytes: nibbles − 8 as bf16 [d_in, d_out],
    times the bf16 scales when ``scaled``."""
    n_blk, d_out = w.scales.shape
    pb = w.packed.reshape(n_blk, 16, d_out)
    vals = torch.cat([(pb & 0x0F).to(torch.bfloat16), (pb >> 4).to(torch.bfloat16)], dim=1) - 8
    if scaled:
        vals = vals * w.scales.to(torch.bfloat16)[:, None, :]
    return vals.reshape(n_blk * 32, d_out)


def check(device="cuda", out=print) -> list:
    """Every variant against the numpy oracle on kernel_lab3.py's check
    inputs (d_in = d_out = 512, M = 8, numpy seed 0), and on the card
    against its plain version. Returns the rows; raises on a failure."""
    dev = resolve_device(device)
    d_in, d_out = 512, 512
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, (d_in // 2, d_out), np.uint8)
    scales = (rng.random((d_in // 32, d_out), np.float32) * 0.01 + 1e-3).astype(np.float16)
    xf = rng.standard_normal((M, d_in), np.float32)
    y_ref = xf @ lab.ref_dequant(packed, scales)
    w = PackedQ40(torch.from_numpy(packed).to(dev), torch.from_numpy(scales).to(dev))
    x = torch.from_numpy(xf).to(dev)
    acts, acts8 = q.make_q80_acts(x), lab.lab_acts(x)
    rows, failed = [], []
    for name in VARIANTS:
        y = product(name, acts, acts8, w).float()
        rel = float(np.abs(y.cpu().numpy() - y_ref).max() / (np.abs(y_ref).max() + 1e-9))
        row = {"name": name, "rel_err_vs_oracle": rel, "gate": GATES[name]}
        ok = rel < GATES[name]
        if dev.type == "cuda":
            ref = product_plain(name, acts, acts8, w).float()
            torch.cuda.synchronize(dev)
            err = float((y - ref).abs().max())
            row.update(max_abs_err_vs_plain=err, max_abs_plain=float(ref.abs().max()))
            ok = ok and err <= PLAIN_TOL * row["max_abs_plain"]
        row["ok"] = ok
        rows.append(row)
        if not ok:
            failed.append(name)
        extra = (f"  vs plain {row['max_abs_err_vs_plain']:.2e}"
                 if "max_abs_err_vs_plain" in row else "")
        out(f"{name:16s} max-rel-err {rel:.2e}{extra}  {'ok' if ok else 'FAIL'}")
    if failed:
        raise RuntimeError(f"kernel_lab3 --check: {', '.join(failed)} out of tolerance")
    return rows


def run(d_in: int = 4096, d_out: int = 14336, L: int = 8, reps: int = 8, device="cuda",
        plain: bool = False, out=print) -> tuple[list, dict]:
    """Times every variant; returns (rows, {variant: ms per pass})."""
    lab_run = Lab(f"kernel_lab3 d_in={d_in} d_out={d_out} L={L} M={M}", device, reps, plain,
                  out)
    dev = lab_run.device
    packed, scales = q40_planes(L, d_in, d_out, dev)
    ws = [PackedQ40(packed[i], scales[i]) for i in range(L)]
    x = randn((M, d_in), dev, seed=1)
    acts, acts8 = q.make_q80_acts(x), lab.lab_acts(x)
    out(f"packed={packed.numel() / 1e6:.1f} MB  (full_bf16chain, full_repeat and full_u8nib "
        "run the one bf16-chain slab kernel on this card)")
    dense = [unpack_q40(w, torch.bfloat16) for w in ws]
    xb = x.to(torch.bfloat16)

    def library():
        return [torch.matmul(xb, d) for d in dense]

    times = {}
    for name, (kernel, mode, body) in VARIANTS.items():
        row = lab_run.measure(
            name, lambda name=name: [product(name, acts, acts8, w) for w in ws],
            L * q.bound_bytes(M, d_in, d_out, mode, x_bytes=4), kernel=kernel,
            site=f"{SITE}{body}", ops=L * 2 * M * d_in * d_out,
            kind="int8" if mode == "i8blockdot" else "bf16",
            plain_fn=lambda name=name: [product_plain(name, acts, acts8, w) for w in ws],
            library_fn=library, library="torch.matmul bf16", note=f"mode {mode}")
        times[name] = row["ms"]
    del dense
    for name, scaled in (("torch_int4_raw", False), ("torch_int4_scaled", True)):
        nbytes = L * (packed[0].numel() + (scales[0].numel() * 2 if scaled else 0)
                      + 4 * M * d_in + 4 * M * d_out)
        lab_run.measure(name, lambda s=scaled: [torch.matmul(xb, int4_dense(w, s)) for w in ws],
                        nbytes, ops=L * 2 * M * d_in * d_out, kind="bf16",
                        note="plain torch ops, a library measurement")
    return lab_run.rows, times


def adopt(times: dict, d_in: int, d_out: int, device="cuda", path: str | None = None,
          out=print) -> tuple[str, str]:
    """Verify the fastest product variant (``check``, which raises on a
    failure) and record it for (d_in, d_out, decode) in the selection
    table at ``path`` (default: the port's ``dequant_table.json``)."""
    from ..ops.dequant_select import record_win

    timed = {ADOPT_MODES[n]: t for n, t in times.items() if n in ADOPT_MODES}
    if not timed:
        raise RuntimeError("ADOPT: no product variant was timed")
    mode = min(timed, key=timed.get)
    out(f"ADOPT: fastest product variant = {mode} ({timed[mode]:.4f} ms/pass); verifying "
        "before recording")
    check(device, out)
    path = record_win(d_in, d_out, "decode", mode,
                      source=f"distributed_llama_multiusers_tpu_torch.lab.kernel_lab3 --adopt "
                             f"({timed[mode]:.4f} ms/pass, M={M})", path=path)
    out(f"TABLE: {d_in}x{d_out}/decode -> {mode} recorded in {path}")
    return mode, path


def main(argv=None) -> int:
    p = parser(__doc__.splitlines()[0], [("d_in", 4096), ("d_out", 14336), ("L", 8),
                                         ("reps", 8)])
    p.add_argument("--check", action="store_true")
    p.add_argument("--adopt", action="store_true")
    args = p.parse_args(argv)
    if args.check:
        Lab("kernel_lab3 --check", args.device, 1)  # the card line, or the refusal
        check(args.device)
        return 0
    _, times = run(args.d_in, args.d_out, args.L, args.reps, args.device)
    if args.adopt:
        adopt(times, args.d_in, args.d_out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
