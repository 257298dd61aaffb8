"""Weight loading: ``.m`` file (or other sources) -> LlamaParams on a device.

- ``load_params_from_m``: every tensor dequantized on the host, matmuls
  dense [L, d_in, d_out].
- ``load_params_from_m_quantized``: Q40 matmuls stay packed (PackedQ40),
  repacked from the file's block bytes on the target device.
- ``params_from_random``: random weights of the right shapes, from a seed.
- ``params_from_jax_numpy``: the JAX package's parameter tree with numpy
  leaves -> the port's parameters, same layouts, so both packages compute
  the same function.
- ``quantize_params``: dense parameters -> PackedQ40 layer matmuls and wcls,
  through the bit-exact host Q40 encoder.

Mixture-of-experts files (``n_experts`` > 0) carry a router per layer and
each expert's w3/w1/w2; they load as [L, E, d_in, d_out] expert stacks
(packed: [L, E, d_in/2, d_out] planes) and a [L, dim, E] f32 router, as the
JAX package loads them.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..formats.model_file import ModelHeader, iter_model_tensors
from ..ops.rope import build_rope_cache
from ..quants.codec import FloatType, dequantize_q40, dequantize_q80
from ..quants.packed import PackedQ40, pack_q40_from_blocks, pack_q40_host, pad_packed_d_out
from .config import LlamaConfig
from .llama import LlamaLayerParams, LlamaParams

_TENSOR_NAME_MAP = {
    "block_matmul_q": "wq",
    "block_matmul_k": "wk",
    "block_matmul_v": "wv",
    "block_matmul_wo": "wo",
    "block_matmul_w1": "w1",
    "block_matmul_w2": "w2",
    "block_matmul_w3": "w3",
    "block_rms_norm_0": "rms_att",
    "block_rms_norm_1": "rms_ffn",
    "block_bias_q": "bq",
    "block_bias_k": "bk",
    "block_bias_v": "bv",
}
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
_EXPERT_KEYS = ("w1", "w2", "w3")
_BIAS_KEYS = ("bq", "bk", "bv")
_VECTOR_KEYS = {"rms_att", "rms_ffn", *_BIAS_KEYS}


def _decode_tensor(raw: np.ndarray, float_type: int, shape) -> np.ndarray:
    if float_type == FloatType.F32:
        x = raw.view("<f4").astype(np.float32)
    elif float_type == FloatType.F16:
        x = raw.view("<f2").astype(np.float32)
    elif float_type == FloatType.Q40:
        x = dequantize_q40(raw)
    elif float_type == FloatType.Q80:
        x = dequantize_q80(raw)
    else:
        raise ValueError(f"unsupported float type {float_type}")
    return np.ascontiguousarray(x.reshape(shape))


def _rope(config: LlamaConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    cos, sin = build_rope_cache(
        config.seq_len,
        config.head_size,
        config.rope_theta,
        config.rope_scaling_factor,
        config.rope_scaling_low_freq_factor,
        config.rope_scaling_high_freq_factor,
        config.rope_scaling_orig_max_seq_len,
    )
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _put(x: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


def read_m_tensors(path: str, header: ModelHeader) -> dict:
    """A ``.m`` file as dequantized f32 numpy arrays in file orientation
    ([d_out, d_in] matmuls): embedding, rms_final, wcls plus per-layer lists
    of the layer tensors. MoE files also give per-layer ``moe_gate`` [E,
    dim] and w1/w2/w3 as per-layer [E, d_out, d_in] stacks."""
    config = LlamaConfig.from_header(header)
    L, E = config.n_layers, config.n_experts
    w: dict = {k: [None] * L for k in _TENSOR_NAME_MAP.values()}
    if E > 0:
        w["moe_gate"] = [None] * L
        for key in _EXPERT_KEYS:
            w[key] = [[None] * E for _ in range(L)]
    for spec, raw in iter_model_tensors(path, header):
        x = _decode_tensor(raw, spec.float_type, spec.shape)
        if spec.name == "embedding":
            w["embedding"] = x
        elif spec.name == "final_rms_norm":
            w["rms_final"] = x.reshape(-1)
        elif spec.name == "final_matmul_logits":
            w["wcls"] = x
        elif spec.name == "block_moe_gate":
            w["moe_gate"][spec.layer] = x
        else:
            key = _TENSOR_NAME_MAP[spec.name]
            if spec.expert >= 0:
                w[key][spec.layer][spec.expert] = x
            else:
                w[key][spec.layer] = x.reshape(-1) if key in _VECTOR_KEYS else x
    if not header.qkv_bias:
        for key in _BIAS_KEYS:
            del w[key]
    if E > 0:
        for key in _EXPERT_KEYS:
            w[key] = [np.stack(mats) for mats in w[key]]
    return w


def _gate(mats: list, device) -> torch.Tensor:
    """Per-layer routers [E, dim] -> [L, dim, E] f32 (y @ gate)."""
    return _put(np.swapaxes(np.stack(mats), -1, -2), torch.float32, device)


def load_params_from_m(path: str, header: ModelHeader, dtype=torch.bfloat16,
                       device=DEFAULT_DEVICE) -> tuple[LlamaConfig, LlamaParams]:
    """Load and dequantize every tensor; matmul weights transposed to
    [L, d_in, d_out] in ``dtype``, norms and biases f32."""
    device = resolve_device(device)
    config = LlamaConfig.from_header(header)
    raw = read_m_tensors(path, header)
    stacked = {}
    for key in _TENSOR_NAME_MAP.values():
        if key not in raw:
            continue
        if key in _VECTOR_KEYS:
            stacked[key] = _put(np.stack(raw[key]), torch.float32, device)
        else:
            # [L, d_in, d_out] (an MoE expert stack: [L, E, d_in, d_out])
            mats = np.stack([np.swapaxes(m, -1, -2) for m in raw[key]])
            stacked[key] = _put(mats, dtype, device)
    if "moe_gate" in raw:
        stacked["moe_gate"] = _gate(raw["moe_gate"], device)
    cos, sin = _rope(config, device)
    params = LlamaParams(
        embedding=_put(raw["embedding"], dtype, device),
        layers=LlamaLayerParams(**stacked),
        rms_final=_put(raw["rms_final"], torch.float32, device),
        wcls=_put(raw["wcls"].T, dtype, device),
        rope_cos=cos,
        rope_sin=sin,
    )
    return config, params


def load_params_from_m_quantized(path: str, header: ModelHeader,
                                 dtype=torch.bfloat16, device=DEFAULT_DEVICE
                                 ) -> tuple[LlamaConfig, LlamaParams]:
    """Load a ``.m`` keeping Q40 matmul weights packed on ``device``
    (PackedQ40: int4 nibbles + f16 block scales), repacked there from the
    file's block bytes without dequantizing, plane by plane (an MoE expert
    stack never exists dense). Non-Q40 matmul tensors load dense;
    embedding, norms and the MoE router are always dense."""
    device = resolve_device(device)
    config = LlamaConfig.from_header(header)
    L, E = config.n_layers, config.n_experts

    def empty(key):
        return [[None] * E for _ in range(L)] if E > 0 and key in _EXPERT_KEYS else [None] * L

    packed: dict = {}
    dense: dict = {k: empty(k) for k in _TENSOR_NAME_MAP.values()}
    gate: list = [None] * L
    for spec, raw in iter_model_tensors(path, header):
        is_matmul = (spec.name.startswith("block_matmul_")
                     or spec.name == "final_matmul_logits")
        if is_matmul and spec.float_type == FloatType.Q40:
            pk, sc = pack_q40_from_blocks(raw, spec.shape, device=device)
            if spec.name == "final_matmul_logits":
                dense["wcls"] = PackedQ40(pk, sc)
                continue
            key = _TENSOR_NAME_MAP[spec.name]
            lead = (L, E) if spec.expert >= 0 else (L,)
            if key not in packed:
                packed[key] = PackedQ40(
                    torch.empty((*lead, *pk.shape), dtype=pk.dtype, device=device),
                    torch.empty((*lead, *sc.shape), dtype=sc.dtype, device=device),
                )
            at = (spec.layer, spec.expert) if spec.expert >= 0 else spec.layer
            packed[key].packed[at].copy_(pk)
            packed[key].scales[at].copy_(sc)
            continue
        x = _decode_tensor(raw, spec.float_type, spec.shape)
        if spec.name == "embedding":
            dense["embedding"] = _put(x, dtype, device)
        elif spec.name == "final_rms_norm":
            dense["rms_final"] = _put(x.reshape(-1), torch.float32, device)
        elif spec.name == "final_matmul_logits":
            dense["wcls"] = _put(x.T, dtype, device)
        elif spec.name == "block_moe_gate":
            gate[spec.layer] = x
        else:
            key = _TENSOR_NAME_MAP[spec.name]
            x = x.reshape(-1) if key in _VECTOR_KEYS else x.T
            if spec.expert >= 0:
                dense[key][spec.layer][spec.expert] = x
            else:
                dense[key][spec.layer] = x

    layers = {}
    for key in _TENSOR_NAME_MAP.values():
        flat = [m for entry in dense[key]
                for m in (entry if isinstance(entry, list) else [entry])]
        if key in packed:
            if any(m is not None for m in flat):
                raise ValueError(f"{key}: tensors mix Q40 and non-Q40 float "
                                 "types; mixed quantization is not supported")
            layers[key] = packed[key]
        elif all(m is not None for m in flat):
            kind = torch.float32 if key in _VECTOR_KEYS else dtype
            mats = [np.stack(m) if isinstance(m, list) else m for m in dense[key]]
            layers[key] = _put(np.stack(mats), kind, device)
    if E > 0:
        layers["moe_gate"] = _gate(gate, device)
    cos, sin = _rope(config, device)
    params = LlamaParams(
        embedding=dense["embedding"],
        layers=LlamaLayerParams(**layers),
        rms_final=dense["rms_final"],
        wcls=dense["wcls"],
        rope_cos=cos,
        rope_sin=sin,
    )
    return config, params


def params_from_random(config: LlamaConfig, seed: int = 0, dtype=torch.bfloat16,
                       scale: float = 0.02, device=DEFAULT_DEVICE) -> LlamaParams:
    """Random-normal dense weights with the right shapes, drawn from one
    numpy generator in the JAX package's order (wq wk wv wo w1 w2 w3, an
    MoE model's f32 router, then embedding and wcls), so one seed gives both
    packages the same f32 draws."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    L, dim, hidden, kv_dim, vocab = (config.n_layers, config.dim,
                                     config.hidden_dim, config.kv_dim,
                                     config.vocab_size)
    E = config.n_experts
    ffn = (L, E) if E > 0 else (L,)

    def r(*shape, kind=dtype):
        return _put(rng.standard_normal(shape, dtype=np.float32) * scale, kind, device)

    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)  # noqa: E731
    layers = LlamaLayerParams(
        wq=r(L, dim, dim), wk=r(L, dim, kv_dim), wv=r(L, dim, kv_dim),
        wo=r(L, dim, dim), w1=r(*ffn, dim, hidden), w2=r(*ffn, hidden, dim),
        w3=r(*ffn, dim, hidden), rms_att=ones(L, dim), rms_ffn=ones(L, dim),
        moe_gate=r(L, dim, E, kind=torch.float32) if E > 0 else None,
    )
    cos, sin = _rope(config, device)
    return LlamaParams(embedding=r(vocab, dim), layers=layers,
                       rms_final=ones(dim), wcls=r(dim, vocab),
                       rope_cos=cos, rope_sin=sin)


def quantize_params(params: LlamaParams, device=None) -> LlamaParams:
    """Dense parameters -> PackedQ40 layer matmuls (an MoE model's expert
    stacks included) and wcls, through the bit-exact host Q40 encoder, the
    planes the JAX package's ``quantize_params`` gives; wcls is padded as
    its loader pads it (``pad_packed_d_out``). The planes land on ``device``
    (default: the parameters' device); the rest is kept as it is."""
    device = resolve_device(device) if device is not None else params.device

    def q(w, pad: bool = False) -> PackedQ40:
        # [.., d_in, d_out] -> file orientation, then the encoder
        wf = np.swapaxes(w.detach().to("cpu", torch.float32).numpy(), -1, -2)
        pk, sc = pack_q40_host(wf)
        if pad:
            pk, sc = pad_packed_d_out(pk, sc)
        return PackedQ40(torch.from_numpy(pk).to(device), torch.from_numpy(sc).to(device))

    lay = params.layers
    layers = LlamaLayerParams(**{f.name: getattr(lay, f.name) for f in fields(lay)})
    for key in _MATMUL_KEYS:
        setattr(layers, key, q(getattr(lay, key)))
    return LlamaParams(embedding=params.embedding, layers=layers,
                       rms_final=params.rms_final, wcls=q(params.wcls, pad=True),
                       rope_cos=params.rope_cos, rope_sin=params.rope_sin)


def _from_numpy(x, dtype=None, *, device) -> torch.Tensor:
    """A numpy array (bf16 arrays from ml_dtypes included) -> torch."""
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:  # a read-only view (JAX arrays): torch needs its own copy
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax_numpy(tree, device=DEFAULT_DEVICE, dtype=None) -> LlamaParams:
    """The JAX package's ``LlamaParams`` with every leaf a numpy array
    (``PackedQ40`` leaves carry ``packed``/``scales`` arrays) -> the port's
    LlamaParams on ``device``. Layouts carry over unchanged ([L, d_in,
    d_out], or [L, d_in/2, d_out] packed; MoE expert stacks [L, E, ...] and
    the [L, dim, E] router); dense matmul weights and the embedding take
    ``dtype`` when given, else keep theirs."""
    device = resolve_device(device)

    def leaf(x, kind=None):
        if x is None:
            return None
        if hasattr(x, "packed") and hasattr(x, "scales"):
            return PackedQ40(_from_numpy(x.packed, torch.uint8, device=device),
                             _from_numpy(x.scales, torch.float16, device=device))
        return _from_numpy(x, kind, device=device)

    lay = tree.layers
    layers = LlamaLayerParams(
        **{k: leaf(getattr(lay, k), dtype) for k in _MATMUL_KEYS},
        rms_att=leaf(lay.rms_att, torch.float32),
        rms_ffn=leaf(lay.rms_ffn, torch.float32),
        moe_gate=leaf(getattr(lay, "moe_gate", None), torch.float32),
        **{k: leaf(getattr(lay, k, None), torch.float32) for k in _BIAS_KEYS},
    )
    return LlamaParams(
        embedding=leaf(tree.embedding, dtype),
        layers=layers,
        rms_final=leaf(tree.rms_final, torch.float32),
        wcls=leaf(tree.wcls, dtype),
        rope_cos=leaf(tree.rope_cos, torch.float32),
        rope_sin=leaf(tree.rope_sin, torch.float32),
    )
