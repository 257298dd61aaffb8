"""Ops: RMSNorm, RoPE and activations in plain PyTorch; the Q40
dequant-in-matmul kernels (``cuda_q40``) and their dispatch (``linear``);
the tensor-parallel ring collectives and their hop kernel
(``ring_collective``); the sampler's Gumbel-max draw (``cuda_sample``);
a decode step's attention (``cuda_attn``)."""
