"""Weight loading: ``.m`` file (or other sources) -> LlamaParams on a device.

- ``load_params_from_m``: every tensor dequantized on the host, matmuls
  dense [L, d_in, d_out].
- ``load_params_from_m_quantized``: Q40 matmuls stay packed (PackedQ40),
  repacked from the file's block bytes on the target device.
- ``params_from_random``: random weights of the right shapes, from a seed.
- ``params_from_jax_numpy``: the JAX package's parameter tree with numpy
  leaves -> the port's parameters, same layouts, so both packages compute
  the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..formats.model_file import ModelHeader, iter_model_tensors
from ..ops.rope import build_rope_cache
from ..quants.codec import FloatType, dequantize_q40, dequantize_q80
from ..quants.packed import PackedQ40, pack_q40_from_blocks
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
_BIAS_KEYS = ("bq", "bk", "bv")
_VECTOR_KEYS = {"rms_att", "rms_ffn", *_BIAS_KEYS}


def _check_dense_only(config: LlamaConfig) -> None:
    if config.n_experts > 0:
        raise ValueError("mixture-of-experts models are not supported by the "
                         "PyTorch port yet")


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
    of the layer tensors."""
    config = LlamaConfig.from_header(header)
    _check_dense_only(config)
    w: dict = {k: [None] * config.n_layers for k in _TENSOR_NAME_MAP.values()}
    for spec, raw in iter_model_tensors(path, header):
        x = _decode_tensor(raw, spec.float_type, spec.shape)
        if spec.name == "embedding":
            w["embedding"] = x
        elif spec.name == "final_rms_norm":
            w["rms_final"] = x.reshape(-1)
        elif spec.name == "final_matmul_logits":
            w["wcls"] = x
        else:
            key = _TENSOR_NAME_MAP[spec.name]
            w[key][spec.layer] = x.reshape(-1) if key in _VECTOR_KEYS else x
    if not header.qkv_bias:
        for key in _BIAS_KEYS:
            del w[key]
    return w


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
            mats = np.stack([m.T for m in raw[key]])
            stacked[key] = _put(mats, dtype, device)
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
    file's block bytes without dequantizing. Non-Q40 matmul tensors load
    dense; embedding and norms are always dense."""
    device = resolve_device(device)
    config = LlamaConfig.from_header(header)
    _check_dense_only(config)
    L = config.n_layers
    packed: dict = {}
    dense: dict = {k: [None] * L for k in _TENSOR_NAME_MAP.values()}
    for spec, raw in iter_model_tensors(path, header):
        is_matmul = (spec.name.startswith("block_matmul_")
                     or spec.name == "final_matmul_logits")
        if is_matmul and spec.float_type == FloatType.Q40:
            pk, sc = pack_q40_from_blocks(raw, spec.shape, device=device)
            if spec.name == "final_matmul_logits":
                dense["wcls"] = PackedQ40(pk, sc)
                continue
            key = _TENSOR_NAME_MAP[spec.name]
            if key not in packed:
                packed[key] = PackedQ40(
                    torch.empty((L, *pk.shape), dtype=pk.dtype, device=device),
                    torch.empty((L, *sc.shape), dtype=sc.dtype, device=device),
                )
            packed[key].packed[spec.layer].copy_(pk)
            packed[key].scales[spec.layer].copy_(sc)
            continue
        x = _decode_tensor(raw, spec.float_type, spec.shape)
        if spec.name == "embedding":
            dense["embedding"] = _put(x, dtype, device)
        elif spec.name == "final_rms_norm":
            dense["rms_final"] = _put(x.reshape(-1), torch.float32, device)
        elif spec.name == "final_matmul_logits":
            dense["wcls"] = _put(x.T, dtype, device)
        else:
            key = _TENSOR_NAME_MAP[spec.name]
            dense[key][spec.layer] = x.reshape(-1) if key in _VECTOR_KEYS else x.T

    layers = {}
    for key in _TENSOR_NAME_MAP.values():
        if key in packed:
            if any(m is not None for m in dense[key]):
                raise ValueError(f"{key}: tensors mix Q40 and non-Q40 float "
                                 "types; mixed quantization is not supported")
            layers[key] = packed[key]
        elif all(m is not None for m in dense[key]):
            kind = torch.float32 if key in _VECTOR_KEYS else dtype
            layers[key] = _put(np.stack(dense[key]), kind, device)
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
    numpy generator in the JAX package's order (wq wk wv wo w1 w2 w3, then
    embedding and wcls), so one seed gives both packages the same f32
    draws."""
    device = resolve_device(device)
    _check_dense_only(config)
    rng = np.random.default_rng(seed)
    L, dim, hidden, kv_dim, vocab = (config.n_layers, config.dim,
                                     config.hidden_dim, config.kv_dim,
                                     config.vocab_size)

    def r(*shape):
        return _put(rng.standard_normal(shape, dtype=np.float32) * scale, dtype, device)

    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)  # noqa: E731
    layers = LlamaLayerParams(
        wq=r(L, dim, dim), wk=r(L, dim, kv_dim), wv=r(L, dim, kv_dim),
        wo=r(L, dim, dim), w1=r(L, dim, hidden), w2=r(L, hidden, dim),
        w3=r(L, dim, hidden), rms_att=ones(L, dim), rms_ffn=ones(L, dim),
    )
    cos, sin = _rope(config, device)
    return LlamaParams(embedding=r(vocab, dim), layers=layers,
                       rms_final=ones(dim), wcls=r(dim, vocab),
                       rope_cos=cos, rope_sin=sin)


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
    d_out], or [L, d_in/2, d_out] packed); dense matmul weights and the
    embedding take ``dtype`` when given, else keep theirs."""
    device = resolve_device(device)

    def leaf(x, kind=None):
        if x is None:
            return None
        if hasattr(x, "packed") and hasattr(x, "scales"):
            return PackedQ40(_from_numpy(x.packed, torch.uint8, device=device),
                             _from_numpy(x.scales, torch.float16, device=device))
        return _from_numpy(x, kind, device=device)

    lay = tree.layers
    if getattr(lay, "moe_gate", None) is not None:
        raise ValueError("mixture-of-experts parameters are not supported by "
                         "the PyTorch port yet")
    layers = LlamaLayerParams(
        **{k: leaf(getattr(lay, k), dtype) for k in _MATMUL_KEYS},
        rms_att=leaf(lay.rms_att, torch.float32),
        rms_ffn=leaf(lay.rms_ffn, torch.float32),
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
