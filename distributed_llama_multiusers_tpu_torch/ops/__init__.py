"""Ops: RMSNorm, RoPE and activations in plain PyTorch; the Q40
dequant-in-matmul kernels (``cuda_q40``) and their dispatch (``linear``)."""
