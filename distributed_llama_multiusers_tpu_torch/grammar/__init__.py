"""Grammar-constrained decoding: structured output on the card.

A request's ``response_format`` — ``{"type": "json_object"}`` or
``{"type": "json_schema", "json_schema": {...}}`` — compiles into a
token-level DFA over the real tokenizer vocab (automaton.py: a byte-level
JSON character machine, walked by every vocab piece), whose per-state
legal-token sets become a packed device mask table and whose transitions
become a compact sparse edge table (slab.py). The engine masks each lane's
row by its state inside every decode step family (``ops/cuda_grammar.py``,
the masked argmax before the exact top-p sort) and advances the state on
the card by the chosen token, so the automaton state rides the pipelined
carry exactly like the position carry — constrained lanes coexist with
unconstrained ones at ``pipeline_flushes == 0``.

Host mirror (``GrammarAutomaton.next_state`` / ``filter_prefix``) serves
draft pre-filtering and deterministic journal replay; the device tables
are the enforcement path. The JAX package's ``grammar/``, copied.
"""

from .automaton import (
    GrammarAutomaton,
    GrammarError,
    canonical_key,
    compile_automaton,
    validate_response_format,
)
from .slab import GrammarSlab, GrammarSlabFull, SlabHandle

__all__ = [
    "GrammarAutomaton",
    "GrammarError",
    "GrammarSlab",
    "GrammarSlabFull",
    "SlabHandle",
    "canonical_key",
    "compile_automaton",
    "validate_response_format",
]
