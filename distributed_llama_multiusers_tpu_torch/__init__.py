"""PyTorch/CUDA port of the distributed-llama multi-user serving stack.

NVIDIA Hopper cards serve a Q40 Llama through the same entry points as the
JAX package beside it (``app/dllama_api.py``): the ``.m``/``.t`` formats,
packed Q40 weights resident on the card, ``llama_forward`` with a contiguous
KV cache, the JAX engine's on-device sampler (its threefry draws, so seeded
streams match), its serving loop (pipelined decode, fused admissions,
multi-step horizons, the decode families replayed from CUDA graphs), the
continuous-batching scheduler and the OpenAI-style HTTP server. ``--workers N`` shards the model tensor-
parallel over N ranks driven from one process (``parallel/``), their wo/w2
outputs synced by ring collectives (``ops/ring_collective.py``). The Q40
dequant-in-matmul kernels, the ring hop and the sampler's draw are CUDA C++ for ``sm_90a``
under ``csrc/``, built with ``nvcc`` at first use; every other op is plain
PyTorch.

Entry points run on CUDA unless the caller asks for ``device="cpu"``; on
the CPU each kernel wrapper runs its plain PyTorch version, which is what
the tests compare against the JAX package.
"""
