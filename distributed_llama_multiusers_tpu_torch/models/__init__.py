from .config import LlamaConfig
from .llama import KVCache, LlamaLayerParams, LlamaParams, init_kv_cache, llama_forward
from .loader import (
    load_params_from_m,
    load_params_from_m_quantized,
    params_from_jax_numpy,
    params_from_random,
    quantize_params,
)
