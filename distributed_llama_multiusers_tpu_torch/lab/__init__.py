"""The kernel lab on the card: the port of the JAX package's lab scripts.

One module per script, each runnable as ``python -m
distributed_llama_multiusers_tpu_torch.lab.<name>`` (``--device cuda`` by
default; ``--device cpu`` runs the plain versions, as the tests do):

- ``kernel_lab``  (scripts/kernel_lab.py): Q40 matmul variants over L
  planes, row-major and pre-tiled, with the read probe.
- ``kernel_lab3`` (scripts/kernel_lab3.py): the serving kernels' modes at
  M = 8 over L planes, ``--check`` against the numpy oracle, ``--adopt``
  into the selection table.
- ``stage_probe`` (scripts/stage_probe.py): DMA, unpack, nibble, convert and
  scale stages, u32 words, dense dots and the two-dot product.
- ``stage_probe2`` (scripts/stage_probe2.py): the slab layout per tile width
  and full-width row blocks.

``timing`` is their harness: CUDA graphs of one pass over the L planes,
replayed between CUDA events. The kernels are ``ops/cuda_lab.py``'s and the
serving ones in ``ops/cuda_q40.py``. Nothing runs at import.
"""
