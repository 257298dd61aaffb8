"""Ops: RMSNorm, RoPE and activations in plain PyTorch; the Q40
dequant-in-matmul kernels (``cuda_q40``) and their dispatch (``linear``);
the tensor-parallel ring collectives and their hop kernel
(``ring_collective``); the sampler's Gumbel-max draw (``cuda_sample``);
a decode step's attention (``cuda_attn``)."""


def _kernel_modules() -> tuple:
    from . import cuda_attn, cuda_grammar, cuda_moe, cuda_q40, cuda_sample, ring_collective

    return cuda_q40, ring_collective, cuda_sample, cuda_attn, cuda_grammar, cuda_moe


def reset_kernel_counts() -> None:
    """Zero every kernel's launch counters (a warmed engine's, a pod
    worker's stats reset)."""
    for mod in _kernel_modules():
        mod.reset_counts()


def all_kernel_counts() -> dict:
    """Every kernel's counters under their ``/stats`` names."""
    q40, ring, sample, attn, grammar, moe = _kernel_modules()
    return {**q40.kernel_counts(), **ring.ring_counts(), **sample.sample_counts(),
            **attn.attn_counts(), **grammar.grammar_counts(), **moe.moe_counts()}
