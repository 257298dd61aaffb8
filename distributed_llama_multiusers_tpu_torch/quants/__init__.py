from .codec import (
    FloatType,
    Q40_BLOCK_SIZE,
    Q80_BLOCK_SIZE,
    dequantize_q40,
    dequantize_q80,
    quantize_q40,
    quantize_q80,
    quantize_dequantize_q80,
    tensor_bytes,
)
from .packed import PackedQ40
