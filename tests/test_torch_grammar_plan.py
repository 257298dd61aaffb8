"""The grammar kernels' launch plans (``ops/cuda_grammar.py``) on the CPU:
each cluster block's slice of a masked-argmax row, the cluster size and
the other launch constants against ``csrc/grammar.cu``'s, and the
automaton step's number of search rounds. The kernels themselves run only
on the card (``tests/test_torch_gpu.py``); their plain versions are held
against JAX in ``tests/test_torch_grammar.py``.
"""

import os
import re

import numpy as np
import pytest

from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as G

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cluster's edges: fewer entries than 4 a block, no multiple of 4, a
# multiple of 4 in short slices, the 1B and the 151,936-entry vocabularies
EDGE_VOCABS = (1, 31, 33, 1000, 2049, 128256, 151936)


def _cu_constant(name: str) -> int:
    with open(os.path.join(ROOT, G.KERNEL_SOURCE)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} not found in {G.KERNEL_SOURCE}"
    return int(m.group(1))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("vocab", EDGE_VOCABS)
def test_mask_plan_slices_cover_the_row_once(vocab, aligned):
    """The blocks' slices cover every entry of the row once, each a
    multiple of 4 entries with 16-byte loads (which need a vocabulary of a
    multiple of 4 and aligned rows), no slice of that step shorter would
    do, and the launch's check (slice x CLUSTER >= vocab) holds."""
    vec, slice_ = G.mask_plan(vocab, aligned)
    assert vec == (aligned and vocab % 4 == 0)
    step = 4 if vec else 1
    assert slice_ >= 1 and slice_ % step == 0
    assert slice_ * G.CLUSTER >= vocab and (slice_ - step) * G.CLUSTER < vocab
    covered = np.zeros(vocab, dtype=np.int64)
    for c in range(G.CLUSTER):
        lo, hi = c * slice_, min((c + 1) * slice_, vocab)
        if lo < hi:
            covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("vocab", [128256, 151936])
def test_mask_plan_is_one_pass_at_the_served_vocabularies(vocab):
    """Each block's slice of a served vocabulary is one pass of kVecPer
    16-byte loads a thread, and the slices are equal (no block idles)."""
    vec, slice_ = G.mask_plan(vocab, True)
    assert vec and slice_ * G.CLUSTER == vocab
    assert -(-slice_ // (4 * G.THREADS)) <= _cu_constant("kVecPer")


@pytest.mark.parametrize("name,cu_name", [("CLUSTER", "kMaxCluster"), ("THREADS", "kThreads"),
                                          ("SEARCH_FAN", "kNextThreads")])
def test_launch_constants_match_the_kernels(name, cu_name):
    """The wrapper's cluster size is the kernel's (its rank-0 buffer holds
    kMaxCluster keys, and 16 is Hopper's non-portable maximum); the block
    widths the plans assume are the kernels'."""
    assert getattr(G, name) == _cu_constant(cu_name)


@pytest.mark.parametrize("n_edges,rounds", [(1, 1), (255, 1), (256, 1), (257, 2),
                                            (49152, 2), (65536, 2), (65537, 3),
                                            (2**24, 3), (2**24 + 1, 4)])
def test_search_rounds(n_edges, rounds):
    """The fewest rounds of SEARCH_FAN probes that reach every key: two at
    the slab's 49,152 edges, a third only past 65,536."""
    assert G.search_rounds(n_edges) == rounds
    assert G.SEARCH_FAN ** rounds >= n_edges
    assert rounds == 1 or G.SEARCH_FAN ** (rounds - 1) < n_edges
