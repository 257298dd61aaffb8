"""Q40 dequant-in-matmul on Hopper: y = x @ dequant(W) with W packed.

The counterpart of the JAX package's ``ops/pallas_q40.py``. Weights stay
int4 + f16 block scales in device memory (0.5625 bytes per weight) and are
expanded inside the kernel, never as a dense weight in device memory.
Decode-shaped products are bound by the bytes of the packed weight, so
reading 4.5 bits instead of 16 per weight is the point.

Three hand-written CUDA C++ kernels under ``csrc/`` (built with ``nvcc`` for
``sm_90a`` into a plain-C shared library at first use, loaded with
``ctypes``), one per Pallas kernel body behind the JAX package's single
``pl.pallas_call``:

- ``q40_slab``       (``csrc/q40_slab.cu``) — modes v4 / bf16chain / repeat /
  u8chain. y = x_lo·W_lo + x_hi·W_hi − 8·(bsum·s) with W = nibble·scale
  rounded to the dot dtype; the −8 is folded into one correction against
  the exact f32 per-block sums of x.
- ``q40_blockdot``   (``csrc/q40_blockdot.cu``) — per quant block, dots of the
  raw nibbles against bf16 x on the tensor cores (``mma.sync`` m16n8k16,
  f32 results), then (· − 8·bsum_b)·s_b on the block result.
- ``q40_i8blockdot`` (``csrc/q40_i8blockdot.cu``) — per quant block, int8 dots
  of the raw nibbles against Q80-quantized x on the tensor cores
  (``mma.sync`` m16n8k32, int32 results), then (sx_b·d − 8·bsum_b)·s_b.

Beside each kernel is its plain PyTorch version (``q40_slab_plain``,
``q40_blockdot_plain``, ``q40_i8blockdot_plain``) with the kernel's exact
operand roundings and an f32 product. A wrapper runs the plain version only
for a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
``LAUNCHES`` counts kernel launches (one per wrapper call that launched),
``PLAIN_CALLS`` the CPU calls; ``/stats`` serves both.

Mode selection mirrors ``q40_matmul_pallas``: the dot dtype is bf16 on the
card and exact f32 on the CPU; an f32 dot always runs v4; ``auto`` resolves
per (d_in, d_out, m-class) from ``dequant_table.json``; blockdot and
i8blockdot above ``BLOCKDOT_MAX_M`` rows run bf16chain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import cached_property

import torch

from ..quants.packed import PackedQ40

DEQUANT_MODES = ("v4", "bf16chain", "repeat", "u8chain", "blockdot",
                 "i8blockdot")
# "auto" is selectable but not a kernel mode: it resolves per (d_in, d_out,
# m-class) from the selection table (ops/dequant_select.py)
SELECTABLE_MODES = DEQUANT_MODES + ("auto",)
# repeat and u8chain are other Pallas arithmetic schedules of the same
# values as bf16chain (the scale rounded to bf16 once per block, one bf16
# product per weight); on the card all three run the slab kernel's bf16 chain
_BF16_CHAINS = ("bf16chain", "repeat", "u8chain")
BLOCKDOT_MAX_M = 32  # above this the per-block post-scale outweighs the savings

KERNELS = ("q40_slab", "q40_blockdot", "q40_i8blockdot")
# where each kernel's source lives and which Pallas kernel it replaces
KERNEL_SOURCES = {
    "q40_slab": "distributed_llama_multiusers_tpu_torch/csrc/q40_slab.cu",
    "q40_blockdot": "distributed_llama_multiusers_tpu_torch/csrc/q40_blockdot.cu",
    "q40_i8blockdot": "distributed_llama_multiusers_tpu_torch/csrc/q40_i8blockdot.cu",
}
KERNEL_REPLACES = {
    "q40_slab": "distributed_llama_multiusers_tpu/ops/pallas_q40.py:251",
    "q40_blockdot": "distributed_llama_multiusers_tpu/ops/pallas_q40.py:331",
    "q40_i8blockdot": "distributed_llama_multiusers_tpu/ops/pallas_q40.py:378",
}
LAUNCHES = {k: 0 for k in KERNELS}     # kernel launches (CUDA tensors)
PLAIN_CALLS = {k: 0 for k in KERNELS}  # plain-version calls (CPU tensors)
_counts_lock = threading.Lock()


def reset_counts() -> None:
    with _counts_lock:
        for d in (LAUNCHES, PLAIN_CALLS):
            for k in d:
                d[k] = 0


def kernel_counts() -> dict:
    """Launch and plain-call counts per kernel, for ``/stats``."""
    with _counts_lock:
        return {"kernel_launches": dict(LAUNCHES),
                "kernel_plain_calls": dict(PLAIN_CALLS)}


def add_launches(delta: dict) -> None:
    """Add a recorded delta of launches (a CUDA graph's, on each replay)."""
    with _counts_lock:
        for k, v in delta.items():
            LAUNCHES[k] += v


def _bump(table: dict, key: str) -> None:
    with _counts_lock:
        table[key] += 1


def _env_dequant_default() -> str:
    """DLLAMA_DEQUANT, validated when read: a typo fails here instead of
    running some other chain under the wrong name."""
    mode = os.environ.get("DLLAMA_DEQUANT", "v4")
    if mode not in SELECTABLE_MODES:
        raise ValueError(
            f"DLLAMA_DEQUANT={mode!r} is not a known dequant mode; "
            f"one of {SELECTABLE_MODES}"
        )
    return mode


DEQUANT_MODE = _env_dequant_default()


def set_dequant_mode(mode: str | None) -> None:
    """Select the bf16-path dequant variant (None -> env/default; "auto" ->
    per-site table resolution, ops/dequant_select.py)."""
    global DEQUANT_MODE
    if mode is not None and mode not in SELECTABLE_MODES:
        raise ValueError(
            f"unknown dequant mode {mode!r}; one of {SELECTABLE_MODES}"
        )
    DEQUANT_MODE = mode or _env_dequant_default()


def default_dot_dtype(device) -> torch.dtype:
    """The dot dtype when the caller names none: bf16 on the card, exact
    f32 on the CPU (the parity path)."""
    return torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16


def resolve_kernel_mode(m: int, d_in: int, d_out: int,
                        w_dtype: torch.dtype) -> str:
    """The dequant mode a product of m rows runs: the configured mode on a
    bf16 dot (``auto`` resolved per site), v4 on an f32 dot, and bf16chain
    for blockdot-family modes above BLOCKDOT_MAX_M rows."""
    mode = DEQUANT_MODE if w_dtype == torch.bfloat16 else "v4"
    if mode == "auto":
        from .dequant_select import resolve_mode

        mode = resolve_mode(d_in, d_out, m)
    if mode in ("blockdot", "i8blockdot") and m > BLOCKDOT_MAX_M:
        mode = "bf16chain"
    return mode


# ---------------------------------------------------------------------------
# Shared activation operands
# ---------------------------------------------------------------------------


def _block_sums(xf: torch.Tensor) -> torch.Tensor:
    """Exact-f32 per-32-block sums of xf [m, d_in] -> [m, d_in//32]. On the
    CPU the 32 terms are added in index order, the order the JAX package's
    reduction uses, so the sums are bit-equal to its ``bsum``; on the card
    one reduction kernel (another order, same f32 class)."""
    xb = xf.view(xf.shape[0], -1, 32)
    if xf.device.type != "cpu":
        return xb.sum(dim=-1)
    acc = xb[:, :, 0].clone()
    for j in range(1, 32):
        acc += xb[:, :, j]
    return acc


class Q80Acts:
    """Activation operands for the Q40 kernels, built once per distinct
    input and consumed by every matmul sharing it (wq/wk/wv share one normed
    x, w1/w3 another).

    ``x`` keeps the original [..., d_in] input (shape and dtype source);
    ``x2`` is its contiguous [m, d_in] view. ``bsum`` (exact f32 per-block
    sums, every kernel's folded −8) is built with the bundle; the Q80
    quantization ``xq``/``sx`` only i8blockdot reads, so it is built on
    first use, unless the caller hands it over as ``q80 = (xq, sx)`` (the
    kernel lab feeds its own quantization, ops/cuda_lab.py)."""

    def __init__(self, x: torch.Tensor, q80: tuple | None = None):
        d_in = x.shape[-1]
        if d_in % 32 != 0:
            raise ValueError(f"d_in={d_in} must cover whole 32-wide quant blocks")
        self.x = x
        self.x2 = x.reshape(-1, d_in).contiguous()
        self.bsum = _block_sums(self.x2.to(torch.float32))
        if q80 is not None:
            self.__dict__["_q80"] = q80  # fills the cached_property below

    @property
    def d_in(self) -> int:
        return self.x.shape[-1]

    @property
    def m(self) -> int:
        return self.x2.shape[0]

    @cached_property
    def _q80(self) -> tuple[torch.Tensor, torch.Tensor]:
        # per 32-block: sx = max(max|x|, 1e-8) / 127, xq = clip(round(x/sx))
        # with round half to even (not the codec's half-away Q80 rounding)
        xb = self.x2.to(torch.float32).view(self.m, -1, 32)
        sx = torch.clamp(xb.abs().amax(dim=-1), min=1e-8) / 127.0
        xq = torch.round(xb / sx[:, :, None]).clamp(-127, 127).to(torch.int8)
        return xq.view(self.m, self.d_in), sx

    @property
    def xq(self) -> torch.Tensor:  # int8 [m, d_in]
        return self._q80[0]

    @property
    def sx(self) -> torch.Tensor:  # f32 [m, d_in//32]
        return self._q80[1]


def make_q80_acts(x) -> Q80Acts:
    """Build the operand bundle for ``x`` (idempotent on a bundle)."""
    if isinstance(x, Q80Acts):
        return x
    return Q80Acts(x)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card-side reference)
# ---------------------------------------------------------------------------


def _nibbles(w: PackedQ40) -> tuple[torch.Tensor, torch.Tensor]:
    p = w.packed
    return (p & 0x0F).to(torch.float32), (p >> 4).to(torch.float32)


def _halves(xr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[m, d_in] -> block-local low/high halves, each [m, d_in/2]."""
    m, d_in = xr.shape
    xb = xr.view(m, d_in // 32, 2, 16)
    return xb[:, :, 0, :].reshape(m, d_in // 2), xb[:, :, 1, :].reshape(m, d_in // 2)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).to(torch.float32)


def q40_slab_plain(x2: torch.Tensor, w: PackedQ40, w_dtype: torch.dtype,
                   mode: str, bsum: torch.Tensor | None = None) -> torch.Tensor:
    """The slab kernel's arithmetic. x2 [m, d_in] (f32 or bf16) -> [m,
    d_out] in x2's dtype. The dot operands are x rounded to ``w_dtype`` and
    W rounded to ``w_dtype`` (v4: nibble·s in f32, then rounded; the bf16
    chains: s rounded to bf16, then the product rounded); the −8 correction
    uses bsum of the unrounded f32 x and the f32 scales."""
    xf = x2.to(torch.float32)
    if bsum is None:
        bsum = _block_sums(xf)
    s = w.scales.to(torch.float32)  # [n_blk, d_out]
    lo, hi = _nibbles(w)  # [d_in/2, d_out]
    if mode == "v4" or w_dtype == torch.float32:
        s_rows = s.repeat_interleave(16, dim=0)
        w_lo, w_hi = _round(lo * s_rows, w_dtype), _round(hi * s_rows, w_dtype)
    elif mode in _BF16_CHAINS:
        s_rows = _round(s, torch.bfloat16).repeat_interleave(16, dim=0)
        w_lo = _round(lo * s_rows, torch.bfloat16)
        w_hi = _round(hi * s_rows, torch.bfloat16)
    else:
        raise ValueError(f"slab kernel runs v4 or a bf16 chain, not {mode!r}")
    x_lo, x_hi = _halves(_round(xf, w_dtype))
    y = x_lo @ w_lo + x_hi @ w_hi - 8.0 * (bsum @ s)
    return y.to(x2.dtype)


def _per_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, n_blk*16], b [n_blk*16, d_out] -> per-block dots [m, n_blk, d_out]."""
    m = a.shape[0]
    n_blk = a.shape[1] // 16
    return torch.einsum("mbj,bjo->mbo", a.view(m, n_blk, 16),
                        b.view(n_blk, 16, b.shape[1]))


def q40_blockdot_plain(x2: torch.Tensor, w: PackedQ40,
                       bsum: torch.Tensor | None = None) -> torch.Tensor:
    """The blockdot kernel's arithmetic: per block b, (x_lo_b·nib_lo_b +
    x_hi_b·nib_hi_b − 8·bsum_b)·s_b with x rounded to bf16 and the raw
    nibbles 0..15, summed over blocks in f32."""
    xf = x2.to(torch.float32)
    if bsum is None:
        bsum = _block_sums(xf)
    lo, hi = _nibbles(w)
    x_lo, x_hi = _halves(_round(xf, torch.bfloat16))
    blk = _per_block(x_lo, lo) + _per_block(x_hi, hi)
    s = w.scales.to(torch.float32)
    y = ((blk - 8.0 * bsum[:, :, None]) * s[None]).sum(dim=1)
    return y.to(x2.dtype)


def q40_i8blockdot_plain(acts: Q80Acts, w: PackedQ40,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The i8blockdot kernel's arithmetic: per block b, integer dots of the
    Q80-quantized x against the raw nibbles, then (sx_b·d − 8·bsum_b)·s_b,
    summed over blocks in f32. The integer dots are exact in f32."""
    lo, hi = _nibbles(w)
    xq_lo, xq_hi = _halves(acts.xq.to(torch.float32))
    d = _per_block(xq_lo, lo) + _per_block(xq_hi, hi)
    s = w.scales.to(torch.float32)
    y = ((acts.sx[:, :, None] * d - 8.0 * acts.bsum[:, :, None]) * s[None]).sum(dim=1)
    return y.to(out_dtype or acts.x.dtype)


# ---------------------------------------------------------------------------
# Kernel build and launch
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# per source: decode_attn.cu instantiates 80 kernels (3 cache dtypes x group x
# threads per slot x layout) and was the build's long pole (chip_smoke.py's
# kernel build, all sources at once on an 8-core H100 host: 61.9 s; with its
# optimizations split over the cores, 33.7 s)
# ring_hop.cu looks up the driver's stream memory operations with dlopen
NVCC_EXTRA_FLAGS = {"decode_attn": ("--split-compile=0",), "ring_hop": ("-ldl",)}
_COMMON_HEADER = "q40_common.cuh"
_libs: dict = {}
_build_lock = threading.Lock()

# thread-block geometry the launch plan assumes (csrc/q40_common.cuh)
COLS_PER_THREAD = 4
THREADS_PER_BLOCK = 128
COLS_PER_BLOCK = COLS_PER_THREAD * THREADS_PER_BLOCK


def build_dir() -> str:
    """Where the kernels' shared libraries go: DLLAMA_KERNEL_BUILD_DIR, else
    ``build/torch_kernels`` beside the package (git-ignored)."""
    return os.environ.get("DLLAMA_KERNEL_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(_CSRC)), "build", "torch_kernels"
    )


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's kernels build from "
                           f"{_CSRC} with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for part in (f"{name}.cu", _COMMON_HEADER):
        with open(os.path.join(_CSRC, part), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + NVCC_EXTRA_FLAGS.get(name, ())).encode())
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}.so")


def build_kernels(names=KERNELS, verbose: bool = False) -> dict:
    """Compile every missing kernel library (``csrc/<name>.cu``; the Q40
    kernels by default, ``ring_hop`` too when named), one ``nvcc`` per
    source, all started together; returns {name: library path}. Raises on a
    failed build with the compiler's output."""
    os.makedirs(build_dir(), exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    procs = {}
    for n, p in todo.items():
        tmp = f"{p}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, *NVCC_EXTRA_FLAGS.get(n, ()),
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(_CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    logs = {}
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    if verbose:
        for n, out in logs.items():
            print(f"[nvcc {n}]\n{out}", flush=True)
    return paths


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # x, x_bf16, bsum, packed, scales, out, out_bf16, part,
    # m, d_in, d_out, mt, splits, blocks_per_split, chain, round_dot, stream
    "q40_slab": [_P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, x_bf16, bsum, packed, scales, out, out_bf16, part,
    # m, d_in, d_out, mt, splits, blocks_per_split, stream
    "q40_blockdot": [_P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
    # xq, sx, bsum, packed, scales, out, out_bf16, part,
    # m, d_in, d_out, mt, splits, blocks_per_split, stream
    "q40_i8blockdot": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
}


def load_kernel(name: str, argtypes: list, symbol: str | None = None):
    """The C function ``symbol`` (default ``<name>_launch``) of kernel
    library ``name``, building the library on first use; it returns an int
    CUDA error code."""
    key = (name, symbol)
    fn = _libs.get(key)
    if fn is not None:
        return fn
    with _build_lock:
        if key not in _libs:
            path = build_kernels((name,))[name]
            fn = getattr(ctypes.CDLL(path), symbol or f"{name}_launch")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[key] = fn
    return _libs[key]


def _kernel(name: str):
    return load_kernel(name, _ARGTYPES[name])


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def launch_plan(m: int, d_in: int, d_out: int, n_sm: int) -> tuple[int, int, int]:
    """(rows per m-tile, k-splits, quant blocks per split) for an m x d_in x
    d_out product. One thread owns COLS_PER_THREAD adjacent output columns
    for an m-tile of rows; narrow products split the d_in blocks across
    thread blocks (partials summed by a second pass) until about two
    thread blocks per SM are in flight. A decode-shaped product (m <=
    BLOCKDOT_MAX_M) splits as one m-tile does, so its k-split plan is a
    function of (d_in, d_out) alone: a row sums its partials in the same
    order in a decode step (m = lanes) and in a verify step (m = lanes x
    (SPEC_DRAFT + 1)), so both give a row the same bits."""
    mt = 1 if m == 1 else (8 if m <= 8 else 16)
    m_tiles = 1 if m <= BLOCKDOT_MAX_M else -(-m // mt)
    col_blocks = -(-d_out // COLS_PER_BLOCK)
    n_blk = d_in // 32
    want = max(1, -(-2 * n_sm // (col_blocks * m_tiles)))
    per = -(-n_blk // min(n_blk, want))
    return mt, -(-n_blk // per), per


def _kernel_info(name: str, mt: int) -> dict:
    fn = load_kernel(name, [_I, ctypes.POINTER(ctypes.c_int)], symbol=f"{name}_info")
    vals = (ctypes.c_int * 4)()
    _raise_on(fn(mt, vals), f"{name}_info")
    return {"stages": vals[0], "smem_bytes": vals[1], "registers": vals[2],
            "local_bytes": vals[3]}


def slab_info(mt: int) -> dict:
    """The built slab kernel's geometry at m-tile ``mt`` (cp.async stage):
    ring stages, static shared memory bytes per thread block, registers
    and local (spill) bytes per thread, as the CUDA runtime reports them."""
    return _kernel_info("q40_slab", mt)


def blockdot_info(mt: int) -> dict:
    """The built blockdot kernel's geometry at m-tile ``mt``, as
    ``slab_info`` gives the slab's; each field is the larger of its
    cp.async and plain-load stage instantiations'."""
    return _kernel_info("q40_blockdot", mt)


def i8blockdot_info(mt: int) -> dict:
    """The built i8blockdot kernel's geometry at m-tile ``mt``, as
    ``blockdot_info`` gives blockdot's."""
    return _kernel_info("q40_i8blockdot", mt)


def _check_weight(w: PackedQ40, device: torch.device) -> None:
    p, s = w.packed, w.scales
    if p.dim() != 2 or s.dim() != 2:
        raise ValueError(f"expected a 2D packed weight, got {tuple(p.shape)}")
    if p.dtype != torch.uint8 or s.dtype != torch.float16:
        raise TypeError(f"packed must be uint8 and scales float16, got {p.dtype}, {s.dtype}")
    if p.device != device or s.device != device:
        raise ValueError(f"weight on {p.device}, operands on {device}")
    if not (p.is_contiguous() and s.is_contiguous()):
        raise ValueError("packed weight planes must be contiguous")
    if s.shape != (p.shape[0] // 16, p.shape[1]) or p.shape[0] % 16:
        raise ValueError(f"scales {tuple(s.shape)} do not match packed {tuple(p.shape)}")


def _check_f32(t: torch.Tensor, shape, device, name: str) -> None:
    if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_x(x2: torch.Tensor, w: PackedQ40) -> None:
    if x2.dim() != 2 or x2.shape[1] != w.d_in:
        raise ValueError(f"x {tuple(x2.shape)} does not match d_in={w.d_in}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError("x must be contiguous")


def _outputs(m: int, d_out: int, dtype, device, splits: int):
    out = torch.empty(m, d_out, dtype=dtype, device=device)
    part = (torch.empty(splits, m, d_out, dtype=torch.float32, device=device)
            if splits > 1 else out)
    return out, part


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def q40_slab(acts: Q80Acts, w: PackedQ40, w_dtype: torch.dtype,
             mode: str) -> torch.Tensor:
    """The slab kernel: acts.x2 [m, d_in] -> [m, d_out] in x's dtype."""
    x2 = acts.x2
    if x2.device.type == "cpu":
        _bump(PLAIN_CALLS, "q40_slab")
        return q40_slab_plain(x2, w, w_dtype, mode, bsum=acts.bsum)
    if mode not in ("v4",) + _BF16_CHAINS:
        raise ValueError(f"slab kernel runs v4 or a bf16 chain, not {mode!r}")
    if w_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dot dtype must be float32 or bfloat16, got {w_dtype}")
    _check_x(x2, w)
    _check_weight(w, x2.device)
    m, d_out = x2.shape[0], w.d_out
    _check_f32(acts.bsum, (m, w.d_in // 32), x2.device, "bsum")
    mt, splits, per = launch_plan(m, w.d_in, d_out, _sm_count(x2.device))
    out, part = _outputs(m, d_out, x2.dtype, x2.device, splits)
    bf16_dot = w_dtype == torch.bfloat16
    chain = int(bf16_dot and mode in _BF16_CHAINS)
    # the launch goes to the current CUDA context: make x's device current
    # (a tensor-parallel rank may live on another card)
    with torch.cuda.device(x2.device):
        err = _kernel("q40_slab")(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), acts.bsum.data_ptr(),
            w.packed.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.bfloat16), part.data_ptr(),
            m, w.d_in, d_out, mt, splits, per, chain, int(bf16_dot),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(err, "q40_slab")
    _bump(LAUNCHES, "q40_slab")
    return out


def q40_blockdot(acts: Q80Acts, w: PackedQ40) -> torch.Tensor:
    """The blockdot kernel: acts.x2 [m, d_in] -> [m, d_out] in x's dtype."""
    x2 = acts.x2
    if x2.device.type == "cpu":
        _bump(PLAIN_CALLS, "q40_blockdot")
        return q40_blockdot_plain(x2, w, bsum=acts.bsum)
    _check_x(x2, w)
    _check_weight(w, x2.device)
    m, d_out = x2.shape[0], w.d_out
    if m > BLOCKDOT_MAX_M:
        raise ValueError(f"blockdot takes at most {BLOCKDOT_MAX_M} rows, got {m}")
    _check_f32(acts.bsum, (m, w.d_in // 32), x2.device, "bsum")
    mt, splits, per = launch_plan(m, w.d_in, d_out, _sm_count(x2.device))
    out, part = _outputs(m, d_out, x2.dtype, x2.device, splits)
    with torch.cuda.device(x2.device):
        err = _kernel("q40_blockdot")(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), acts.bsum.data_ptr(),
            w.packed.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.bfloat16), part.data_ptr(),
            m, w.d_in, d_out, mt, splits, per,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(err, "q40_blockdot")
    _bump(LAUNCHES, "q40_blockdot")
    return out


def q40_i8blockdot(acts: Q80Acts, w: PackedQ40) -> torch.Tensor:
    """The i8blockdot kernel: Q80-quantized acts -> [m, d_out] in x's dtype."""
    x2 = acts.x2
    if x2.device.type == "cpu":
        _bump(PLAIN_CALLS, "q40_i8blockdot")
        return q40_i8blockdot_plain(acts, w)
    _check_x(x2, w)
    _check_weight(w, x2.device)
    m, d_out = x2.shape[0], w.d_out
    if m > BLOCKDOT_MAX_M:
        raise ValueError(f"i8blockdot takes at most {BLOCKDOT_MAX_M} rows, got {m}")
    n_blk = w.d_in // 32
    xq = acts.xq
    if xq.dtype != torch.int8 or xq.device != x2.device or not xq.is_contiguous() \
            or tuple(xq.shape) != (m, w.d_in):
        raise ValueError(f"xq must be contiguous int8 [{m}, {w.d_in}] on {x2.device}")
    _check_f32(acts.sx, (m, n_blk), x2.device, "sx")
    _check_f32(acts.bsum, (m, n_blk), x2.device, "bsum")
    mt, splits, per = launch_plan(m, w.d_in, d_out, _sm_count(x2.device))
    out, part = _outputs(m, d_out, x2.dtype, x2.device, splits)
    with torch.cuda.device(x2.device):
        err = _kernel("q40_i8blockdot")(
            xq.data_ptr(), acts.sx.data_ptr(), acts.bsum.data_ptr(),
            w.packed.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.bfloat16), part.data_ptr(),
            m, w.d_in, d_out, mt, splits, per,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(err, "q40_i8blockdot")
    _bump(LAUNCHES, "q40_i8blockdot")
    return out


def q40_matmul(x, w: PackedQ40, w_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ dequant(w). x: [..., d_in] tensor or a prebuilt ``Q80Acts``;
    returns [..., d_out] in the input's dtype. ``w_dtype`` is the dot dtype
    (None: bf16 on the card, f32 on the CPU); the mode comes from
    ``resolve_kernel_mode``."""
    acts = make_q80_acts(x)
    if w.packed.dim() != 2:
        raise ValueError(f"expected a 2D packed weight, got {tuple(w.packed.shape)}")
    if acts.d_in != w.d_in:
        raise ValueError(f"operand d_in {acts.d_in} != weight d_in {w.d_in}")
    w_dtype = w_dtype or default_dot_dtype(acts.x.device)
    mode = resolve_kernel_mode(acts.m, w.d_in, w.d_out, w_dtype)
    if mode == "i8blockdot":
        y = q40_i8blockdot(acts, w)
    elif mode == "blockdot":
        y = q40_blockdot(acts, w)
    else:
        y = q40_slab(acts, w, w_dtype, mode)
    return y.view(*acts.x.shape[:-1], w.d_out)


def bound_bytes(m: int, d_in: int, d_out: int, mode: str, x_bytes: int = 2) -> int:
    """Bytes a product must move at least: the packed weight and its scales,
    the activation operands the kernel reads (i8blockdot: int8 x plus f32
    sx and bsum; the others: x plus f32 bsum) and the output, each once."""
    weight = d_in * d_out // 2 + (d_in // 32) * d_out * 2
    n_blk = d_in // 32
    if mode == "i8blockdot":
        acts = m * d_in + 2 * 4 * m * n_blk
    else:
        acts = m * d_in * x_bytes + 4 * m * n_blk
    return weight + acts + m * d_out * x_bytes


def bound_ops(m: int, d_in: int, d_out: int) -> int:
    """Multiply-adds of the product, counted as two operations each."""
    return 2 * m * d_in * d_out
