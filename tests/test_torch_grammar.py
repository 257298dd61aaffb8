"""The port's structured output (``grammar/``, ``ops/cuda_grammar.py``, the
engine's masked families, the scheduler, the server and the journal) on
the CPU, against the JAX package.

- The copied automaton and slab give the JAX package's tables byte for
  byte and its slab bookkeeping op for op.
- The two kernels' plain versions (the CPU runs them) equal the JAX
  engine's ``_g_mask_row`` + ``jnp.argmax`` and ``_g_next1`` /
  ``_g_walk_greedy`` on the same tables, exactly (indices, masked rows bit
  for bit, states).
- On a 320-entry tiny model with the byte tokenizer (the recipe of
  ``tests/test_grammar.py``'s ``real_stack``), every step family gives the
  JAX engine's tokens in lockstep for constrained greedy and seeded lanes,
  and unconstrained lanes in the same batch keep their no-grammar tokens.
- The scheduler and the HTTP server serve ``response_format`` as the JAX
  server does (a 400 on a malformed schema and under ``--grammar off``, a
  429 ``grammar_slab_full``, the ``/stats`` fields), and a constrained
  request recovers from a journal written by either package.

Tolerance: none (tokens, packs, tables and states are compared for
equality; the model is f32 on both sides).
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu import grammar as jg
from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.formats.synthetic import tiny_header, write_synthetic_model
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.runtime import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributed_llama_multiusers_tpu.serving import journal as j_journal
from distributed_llama_multiusers_tpu.serving import recover_scheduler as j_recover
from distributed_llama_multiusers_tpu.utils.testing import ByteJsonTokenizer as JaxByteTokenizer
from distributed_llama_multiusers_tpu_torch import grammar as pg
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.serving import (
    AdmissionRejected,
    RequestJournal,
    read_journal,
    recover_scheduler,
)
from distributed_llama_multiusers_tpu_torch.utils.testing import ByteJsonTokenizer

BYTE_TABLE = [None] + [bytes([i]) for i in range(256)] + [None]
EOS = 257
# BPE-style multi-byte pieces beside the bytes (tests/test_grammar.py's
# regime): a piece is legal iff its whole byte string walks the machine
PIECE_TABLE = BYTE_TABLE[:-1] + [b'{"', b'":', b'",', b"true", b"false", b"null", b"  ",
                                 b'"name', b"\xc3\xa9", b"}{", b"12", None]
SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}},
        "mood": {"enum": ["happy", "sad", 3, None]},
    },
    "required": ["name", "mood"],
}
SCHEMA_RF = {"type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}
ENUM_RF = {"type": "json_schema", "json_schema": {"schema": {"enum": ["happy", "sad", 3]}}}
NESTED_RF = {"type": "json_schema", "json_schema": {"schema": {
    "type": "object",
    "properties": {"rows": {"type": "array", "items": {"type": "array",
                                                       "items": {"type": "integer"}}},
                   "ok": {"type": "boolean"}},
    "required": ["rows", "ok"]}}}
# short, always-completing objects (a random model's strings never end)
FLAGS_RF = {"type": "json_schema", "json_schema": {"schema": {
    "type": "object",
    "properties": {"ok": {"type": "boolean"}, "mood": {"enum": ["a", "b"]},
                   "n": {"type": "null"}},
    "required": ["ok", "mood", "n"]}}}
FORMATS = {"schema": SCHEMA_RF, "object": {"type": "json_object"}, "enum": ENUM_RF,
           "nested": NESTED_RF}
MALFORMED = [
    "json_object",
    ["json_object"],
    {"type": "grammar"},
    {"type": "yaml_mode"},
    {"type": "json_schema"},
    {"type": "json_schema", "json_schema": {"schema": {"type": "x"}}},
    {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "properties": {"a": {"type": "string"}}, "required": ["b"]}}},
    {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "properties": {"a": {"type": "string"}},
        "additionalProperties": True}}},
    {"type": "json_schema", "json_schema": {"schema": {"enum": [[1, 2]]}}},
]


def _tables_equal(a, b) -> None:
    assert (a.key, a.n_states, a.vocab_size, a.start) == (b.key, b.n_states, b.vocab_size,
                                                          b.start)
    for name in ("masks", "default_next", "edge_keys", "edge_next", "accepting"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


# ---------------------------------------------------------------------------
# (a) the automaton and the slab against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", ["bytes", "pieces"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_compiled_tables_equal_jax(fmt, table):
    """Masks, default targets, edge keys and targets, accepting set and
    state count of every schema, at the byte and the multi-byte vocab, at
    the default and a cut nesting bound: the JAX compiler's bytes."""
    pieces = BYTE_TABLE if table == "bytes" else PIECE_TABLE
    eos = [len(pieces) - 1]
    rf = FORMATS[fmt]
    for depth in (None, 3):
        ours = pg.compile_automaton(rf, pieces, eos, max_depth=depth)
        ref = jg.compile_automaton(rf, pieces, eos, max_depth=depth)
        _tables_equal(ours, ref)
    assert pg.canonical_key(rf) == jg.canonical_key(rf)
    assert pg.validate_response_format(rf) == jg.validate_response_format(rf)


def test_compiled_tables_equal_jax_at_a_real_tokenizer(tiny_model):
    """The tiny model's BPE tokenizer (special pieces from bos_id up): the
    same tables, or the same GrammarError, as the JAX compiler."""
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer(tiny_model["tokenizer"])
    table = [tok.vocab[i] if i < tok.bos_id else None for i in range(tok.vocab_size)]
    for rf in FORMATS.values():
        try:
            ref = jg.compile_automaton(rf, table, tok.eos_token_ids)
        except jg.GrammarError as e:
            with pytest.raises(pg.GrammarError) as got:
                pg.compile_automaton(rf, table, tok.eos_token_ids)
            assert str(got.value) == str(e)
            continue
        _tables_equal(pg.compile_automaton(rf, table, tok.eos_token_ids), ref)


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_malformed_response_formats_raise_as_jax(i):
    """A malformed response_format raises GrammarError (a ValueError, the
    server's 400) with the JAX validator's message."""
    rf = MALFORMED[i]
    with pytest.raises(jg.GrammarError) as want:
        jg.validate_response_format(rf)
    with pytest.raises(pg.GrammarError) as got:
        pg.validate_response_format(rf)
    assert str(got.value) == str(want.value)
    assert issubclass(pg.GrammarError, ValueError)


def test_canonical_keys_equal_jax():
    """Keys (the compile cache's and the slab's) are the JAX package's for
    the same format written with its fields in another order, and for
    schemas whose property order differs (declaration order is semantic:
    the keys differ)."""
    a = {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "properties": {"x": {"type": "integer"}, "y": {"type": "string"}}}}}
    b = {"json_schema": {"schema": {"properties": {"x": {"type": "integer"},
                                                   "y": {"type": "string"}},
                                    "type": "object"}}, "type": "json_schema"}
    c = {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "properties": {"y": {"type": "string"}, "x": {"type": "integer"}}}}}
    for rf in (a, b, c):
        assert pg.canonical_key(rf) == jg.canonical_key(rf)
    assert pg.canonical_key(a) != pg.canonical_key(c)


def _slab_view(slab) -> dict:
    masks, keys, nxt, dflt = slab.arrays()
    return {"version": slab.version, "stats": slab.stats(), "free": list(slab._free_ranges),
            "arrays": [a.tobytes() for a in (masks, keys, nxt, dflt)]}


@pytest.mark.parametrize("seed", range(3))
def test_slab_sequences_equal_jax(seed):
    """Seeded attach/detach sequences over four schemas in a slab too small
    for all of them: every op gives the JAX slab's handle base or
    exception, version, stats, free ranges and arrays (park, re-attach,
    LRU eviction, GrammarSlabFull and the empty-slab GrammarError)."""
    rfs = [SCHEMA_RF, {"type": "json_object"}, ENUM_RF, NESTED_RF]
    ours = [pg.compile_automaton(rf, BYTE_TABLE, [EOS]) for rf in rfs]
    refs = [jg.compile_automaton(rf, BYTE_TABLE, [EOS]) for rf in rfs]
    cap = ours[0].n_states + ours[2].n_states + 3
    slabs = (pg.GrammarSlab(258, n_states=cap, n_edges=4096),
             jg.GrammarSlab(258, n_states=cap, n_edges=4096))
    autos = (ours, refs)
    rng = random.Random(seed)
    for _ in range(60):
        k = rng.randrange(len(rfs))
        op = rng.choice(("attach", "attach", "detach"))
        got = []
        for slab, aut in zip(slabs, autos):
            try:
                if op == "attach":
                    h = slab.attach(aut[k])
                    got.append(("ok", h.base, h.start_state))
                else:
                    slab.detach(aut[k].key)
                    got.append(("ok",))
            except Exception as e:  # noqa: BLE001 — the type is the result
                got.append((type(e).__name__, str(e)))
            got.append(_slab_view(slab))
        assert got[:2] == got[2:], (op, k)


# ---------------------------------------------------------------------------
# the 320-entry tiny model with the byte tokenizer, in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grammar_model") / "model.m")
    write_synthetic_model(path, tiny_header(vocab_size=320, seq_len=256), seed=0)
    return path


@pytest.fixture(scope="module")
def pstack(model_path):
    config, params = load_params_from_m_quantized(model_path, load_model_header(model_path),
                                                  dtype=torch.float32, device="cpu")
    return config, params


@pytest.fixture(scope="module")
def jstack(model_path):
    return j_load_params(model_path, j_load_header(model_path), dtype=jnp.float32)


def _pengine(pstack, n_lanes=4, grammar=True, **kw):
    config, params = pstack
    eng = InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=(8, 16),
                          device="cpu", **kw)
    if grammar:
        tok = ByteJsonTokenizer()
        eng.grammar_init(tok.token_table(), tok.eos_token_ids)
    return eng


def _jengine(jstack, n_lanes=4, **kw):
    config, params = jstack
    eng = JaxEngine(config, params, n_lanes=n_lanes, prefill_buckets=(8, 16), **kw)
    tok = JaxByteTokenizer()
    eng.grammar_init(tok.token_table(), tok.eos_token_ids)
    return eng


def _closure(fn, name):
    """A free variable of a (jitted) function of the JAX engine."""
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


@pytest.fixture(scope="module")
def jax_grammar_fns(jstack):
    """The JAX engine's grammar closures and tables with SCHEMA_RF and
    json_object installed."""
    je = _jengine(jstack, n_lanes=2)
    handles = [je.grammar_attach(SCHEMA_RF), je.grammar_attach({"type": "json_object"})]
    prefill_half = _closure(je._prefill_fn, "_prefill_half")
    return {
        "engine": je,
        "handles": handles,
        "mask_row": _closure(prefill_half, "_g_mask_row"),
        "walk": _closure(je._decode_spec_fn, "_g_walk_greedy"),
        "next1": je._g_next_host,
        "gtab": je._gtab(),
    }


def _torch_tables(gtab):
    masks, keys, nxt, dflt = (np.asarray(a) for a in gtab)
    return (torch.from_numpy(masks.view(np.int32).copy()), torch.from_numpy(keys.copy()),
            torch.from_numpy(nxt.copy()), torch.from_numpy(dflt.copy()))


def _rows(rng, n, vocab):
    """f32 rows with ties at the maximum, -inf entries, a -0.0/+0.0 tie, an
    all -inf row and a NaN row."""
    rows = rng.standard_normal((n, vocab)).astype(np.float32)
    rows[0, 7] = rows[0, 200] = rows[0].max() + 1.0  # a tie, lower index wins
    rows[1, ::3] = -np.inf
    rows[2] = 0.0
    rows[2, 50] = -0.0
    rows[3] = -np.inf
    rows[4, 90] = np.nan
    rows[4, 130] = np.nan
    return rows


def _states(rng, handles, n):
    pool = [0] + [h.base + s for h in handles for s in range(h.automaton.n_states)]
    return np.asarray([0, 0] + [rng.choice(pool) for _ in range(n - 2)], np.int64)


@pytest.mark.parametrize("seed", range(3))
def test_mask_argmax_plain_equals_jax(jax_grammar_fns, seed):
    """The masked argmax's plain version against the JAX engine's
    ``_g_mask_row`` + ``jnp.argmax`` on its own tables: indices equal and
    masked rows bit-equal, at FREE and constrained states, through ties,
    -inf, -0.0, all -inf and NaN rows; state 0 gives ``torch.argmax``."""
    f = jax_grammar_fns
    rng = np.random.default_rng(seed)
    vocab = f["engine"].config.vocab_size
    rows = _rows(rng, 12, vocab)
    states = _states(rng, f["handles"], 12)
    masked_j = jax.vmap(f["mask_row"], in_axes=(None, 0, 0))(
        f["gtab"], jnp.asarray(states, jnp.int32), jnp.asarray(rows))
    want = np.asarray(jnp.argmax(masked_j, axis=-1))
    masks = _torch_tables(f["gtab"])[0]
    out = torch.zeros((12, vocab), dtype=torch.float32)
    got = cuda_grammar.mask_argmax(torch.from_numpy(rows), torch.from_numpy(states), masks,
                                   masked_out=out)
    assert got.tolist() == want.tolist()
    assert out.numpy().view(np.int32).tobytes() == np.asarray(masked_j).view(np.int32).tobytes()
    free = torch.from_numpy(rows[:2])
    assert got[:2].tolist() == torch.argmax(free, dim=-1).tolist()
    # every other row of a window: masked_every takes rows 0, 2, 4, ...
    half = torch.zeros((6, vocab), dtype=torch.float32)
    cuda_grammar.mask_argmax(torch.from_numpy(rows), torch.from_numpy(states), masks,
                             masked_out=half, masked_every=2)
    assert half.numpy().view(np.int32).tobytes() == \
        np.asarray(masked_j)[::2].view(np.int32).tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_grammar_next_plain_equals_jax(jax_grammar_fns, seed):
    """The automaton step's plain version against ``_g_next1`` on random
    (state, token) pairs, illegal tokens included, and the window walk
    against ``_g_walk_greedy``: the states and the masked greedy tokens
    of a verify window are the JAX walk's."""
    f = jax_grammar_fns
    rng = np.random.default_rng(100 + seed)
    vocab = f["engine"].config.vocab_size
    masks, keys, nxt, dflt = _torch_tables(f["gtab"])
    states = _states(rng, f["handles"], 40)
    toks = rng.integers(0, vocab, 40).astype(np.int64)
    want = jax.vmap(f["next1"], in_axes=(None, 0, 0))(
        f["gtab"], jnp.asarray(states, jnp.int32), jnp.asarray(toks, jnp.int32))
    got = cuda_grammar.grammar_next(torch.from_numpy(states), torch.from_numpy(toks)[:, None],
                                    keys, nxt, dflt, vocab)
    assert got.tolist() == np.asarray(want).tolist()
    # a verify window: the fed tokens mostly legal (a walk of the host
    # mirror), some random
    n, k1 = 6, 4
    gs = _states(rng, f["handles"], n)
    full = rng.integers(0, vocab, (n, k1)).astype(np.int64)
    for i in range(n):
        s = int(gs[i])
        for h in f["handles"]:
            if h.base <= s < h.base + h.automaton.n_states and i % 2 == 0:
                for t in range(1, k1):
                    legal = h.automaton.legal_ids(s - h.base)
                    full[i, t] = int(legal[rng.integers(len(legal))])
                    s = h.next_state(s, int(full[i, t]))
    logits = rng.standard_normal((n, k1, vocab)).astype(np.float32)
    mg, gst = f["walk"](f["gtab"], jnp.asarray(gs, jnp.int32), jnp.asarray(logits),
                        jnp.asarray(full, jnp.int32))
    walk = cuda_grammar.grammar_next(torch.from_numpy(gs), torch.from_numpy(full)[:, 1:],
                                     keys, nxt, dflt, vocab, walk=True)
    assert walk.tolist() == np.asarray(gst).tolist()
    greedy = cuda_grammar.mask_argmax(torch.from_numpy(logits).reshape(n * k1, vocab),
                                      walk.reshape(-1), masks)
    assert greedy.view(n, k1).tolist() == np.asarray(mg).tolist()


def test_engine_tables_equal_the_slab_and_jax(pstack, jstack):
    """The engine's device tables after attaches equal the JAX engine's
    uploaded tables, are rewritten in place (same tensors), and keep
    state 0 all-ones."""
    pe, je = _pengine(pstack, n_lanes=2), _jengine(jstack, n_lanes=2)
    ptrs = [t.data_ptr() for t in pe._g_tabs]
    for rf in (SCHEMA_RF, ENUM_RF):
        assert pe.grammar_attach(rf).base == je.grammar_attach(rf).base
    pe._sync_gtab()
    for ours, ref in zip(pe._g_tabs, _torch_tables(je._gtab())):
        assert torch.equal(ours, ref)
    assert [t.data_ptr() for t in pe._g_tabs] == ptrs
    assert int(pe._g_tabs[0][0].min()) == -1  # 0xFFFFFFFF as int32
    assert pe.grammar_stats() == je.grammar_stats()


# ---------------------------------------------------------------------------
# (c) every step family in lockstep with the JAX engine
# ---------------------------------------------------------------------------

PROMPTS = [b"name me", b"list it", b"free one", b"free two", b"join now later please"]
LANE_RF = [SCHEMA_RF, {"type": "json_object"}, None, None]
TEMPS = np.asarray([0.0, 0.8, 0.0, 0.8], np.float32)
SEEDS = np.asarray([0, 11, 0, 13], np.uint32)
TOPPS = np.full(4, 0.9, np.float32)
K = InferenceEngine.SPEC_DRAFT


def _enc(b: bytes) -> list:
    return [0] + [1 + c for c in b]


class _Lockstep:
    """The same calls on the port engine and the JAX engine, their token
    outputs asserted equal. Lanes 0-1 are constrained (greedy and seeded),
    lanes 2-3 free unless ``constrain`` is False (then all free)."""

    def __init__(self, pe, je, constrain=True):
        self.engines = (pe, je)
        self.n = pe.n_lanes
        self.handles = [None] * self.n
        if constrain:
            for i, rf in enumerate(LANE_RF):
                if rf is not None:
                    hs = [e.grammar_attach(rf) for e in self.engines]
                    assert hs[0].base == hs[1].base
                    self.handles[i] = hs[0]
        self.g = [h.start_state if h is not None else 0 for h in self.handles]
        self.streams = [[] for _ in range(self.n)]
        self.pos = [0] * self.n
        self.nxt = [0] * self.n

    def both(self, method, *args, **kw):
        out = [getattr(e, method)(*args, **kw) for e in self.engines]
        return out

    def adv(self, i, tok):
        self.streams[i].append(int(tok))
        if self.handles[i] is not None:
            self.g[i] = self.handles[i].next_state(self.g[i], int(tok))

    def prefill(self, lanes):
        for i in lanes:
            toks = _enc(PROMPTS[i])
            (_, g0, s0), (_, g1, s1) = self.both(
                "prefill_chunk", i, toks, 0, temp=float(TEMPS[i]), topp=0.9,
                seed=int(SEEDS[i]), g_state=self.g[i])
            assert (g0, s0) == (g1, s1)
            first = g0 if TEMPS[i] == 0.0 else s0
            self.pos[i] = len(toks)
            self.nxt[i] = first
            self.adv(i, first)

    def gvec(self):
        return np.asarray(self.g, np.int64)


def _tok_eq(a, b):
    a = [np.asarray(x) for x in a]
    b = [np.asarray(x) for x in b]
    assert all(x.tolist() == y.tolist() for x, y in zip(a, b))


def _run_family(ls: _Lockstep, family: str, steps: int = 10):
    n = ls.n
    lanes = list(range(n)) if family not in ("fused", "spec_fused") else [0, 1, 2]
    ls.prefill(lanes)
    if family == "decode":
        for _ in range(steps):
            outs = ls.both("decode", np.asarray(ls.nxt), np.asarray(ls.pos), TEMPS, TOPPS,
                           SEEDS, g_states=ls.gvec())
            _tok_eq(outs[0][1:], outs[1][1:])
            _, greedy, sampled = outs[0]
            for i in range(n):
                ls.nxt[i] = int(greedy[i] if TEMPS[i] == 0 else sampled[i])
                ls.pos[i] += 1
                ls.adv(i, ls.nxt[i])
    elif family == "multi":
        for _ in range(steps // 4):
            outs = ls.both("decode_multi", np.asarray(ls.nxt), np.asarray(ls.pos), TEMPS,
                           TOPPS, SEEDS, h=4, g_states=ls.gvec())
            _tok_eq([outs[0]], [outs[1]])
            for i in range(n):
                for j in range(4):
                    ls.adv(i, outs[0][j, i])
                ls.nxt[i] = int(outs[0][3, i])
                ls.pos[i] += 4
    elif family == "spec":
        rng = np.random.default_rng(5)
        for step in range(steps):
            drafts = np.zeros((n, K), np.int64)
            dlen = np.zeros(n, np.int64)
            for i in (0, 2):  # greedy lanes: legal drafts, then junk ones
                h = ls.handles[i]
                if step % 2 == 0 and h is not None:
                    s, d = ls.g[i], []
                    for _ in range(K):
                        legal = h.automaton.legal_ids(s - h.base)
                        d.append(int(legal[0]))
                        s = h.next_state(s, d[-1])
                else:
                    d = [int(t) for t in rng.integers(0, 320, K)]
                drafts[i], dlen[i] = d, K
            outs = ls.both("decode_spec", np.asarray(ls.nxt), drafts, dlen, np.asarray(ls.pos),
                           TEMPS, TOPPS, SEEDS, g_states=ls.gvec())
            _tok_eq(outs[0][1:], outs[1][1:])
            _, emitted, n_emit = outs[0]
            for i in range(n):
                for t in emitted[i, :n_emit[i]]:
                    ls.adv(i, t)
                ls.nxt[i] = int(emitted[i, n_emit[i] - 1])
                ls.pos[i] += int(n_emit[i])
    else:
        _run_chain(ls, family, steps)


def _run_chain(ls: _Lockstep, family: str, steps: int):
    """The pipelined families: a reseed with the host states, chained steps
    reading the carries (-1), consumed one behind; the fused ones admit
    lane 3 (constrained by ENUM_RF) chunk by chunk inside the chain."""
    n = ls.n
    spec = family in ("spec_pipelined", "spec_fused")
    fused = family in ("fused", "spec_fused")
    live = [0, 1, 2] if fused else list(range(n))
    p_g = 0
    if fused:
        hs = [e.grammar_attach(ENUM_RF) for e in ls.engines]
        ls.handles[3] = hs[0]
        ls.g[3] = p_g = hs[0].start_state
    pending = _enc(PROMPTS[4]) if fused else []
    p_start = 0
    meta = []
    seq_len = ls.engines[0].config.seq_len
    for step in range(steps):
        reseed = step == 0
        positions = np.full(n, seq_len, np.int64)
        gs = np.zeros(n, np.int64)
        for i in live:
            positions[i] = ls.pos[i] if reseed else -1
            gs[i] = ls.g[i] if reseed else -1
        feed = np.asarray(ls.nxt, np.int64) if reseed else None
        kw = dict(tokens=feed, g_states=gs)
        args = (positions,)
        if spec:
            drafts = np.zeros((n, K + 1), np.int64)
            dlen = np.zeros(n, np.int64)
            if reseed:
                drafts[:, 0] = ls.nxt
                drafts[0, 1:] = [1 + ord(c) for c in "{ \""]
                dlen[0] = K + 1
            args = (positions, drafts, dlen)
        if fused and pending:
            chunk, pending = pending[:8], pending[8:]
            kw.update(p_lane=3, chunk=chunk, p_start=p_start, p_temp=0.0, p_topp=0.9,
                      p_seed=0, p_g=p_g)
            p_start += len(chunk)
            ls.both("decode_spec_prefill_fused" if spec else "decode_prefill_fused",
                    *args, TEMPS, TOPPS, SEEDS, **kw)
            meta.append((tuple(live), not pending))
            if not pending:
                live = live + [3]
                ls.pos[3] = p_start
        else:
            ls.both("decode_spec_pipelined" if spec else "decode_pipelined", *args, TEMPS,
                    TOPPS, SEEDS, **kw)
            meta.append((tuple(live), False))
        if len(meta) == 2 or step == steps - 1:
            _consume(ls, meta.pop(0), spec)
    while meta:
        _consume(ls, meta.pop(0), spec)
    for e in ls.engines:
        e.pipeline_flush()


def _consume(ls: _Lockstep, entry, spec: bool):
    lanes, final = entry
    (a0, b0), (a1, b1) = ls.both("pipeline_consume")
    _tok_eq([a0, b0], [a1, b1])
    for i in lanes:
        if spec:
            cnt = int(b0[i])
            for t in a0[i, :cnt]:
                ls.adv(i, t)
            ls.nxt[i] = int(a0[i, cnt - 1])
        else:
            tok = a0[i] if TEMPS[i] == 0 else b0[i]
            ls.nxt[i] = int(tok)
            ls.adv(i, tok)
    if final:
        tok = int(a0[-1, 0]) if spec else int(a0[-1])
        ls.nxt[3] = tok
        ls.adv(3, tok)


FAMILIES = ["decode", "multi", "spec", "pipelined", "spec_pipelined", "fused", "spec_fused"]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_streams_equal_jax_in_lockstep(pstack, jstack, family):
    """Constrained greedy and seeded lanes beside free ones, every step's
    tokens equal to the JAX engine's; the constrained lanes' tokens are
    legal in their automata; the free lanes keep the tokens of the same
    run with no constrained lane."""
    ls = _Lockstep(_pengine(pstack), _jengine(jstack))
    _run_family(ls, family)
    for i, h in enumerate(ls.handles):
        if h is None:
            continue
        s = h.start_state
        for t in ls.streams[i]:
            assert h.is_legal(s, t), (i, ls.streams[i])
            s = h.next_state(s, t)
    plain = _Lockstep(_pengine(pstack), _jengine(jstack), constrain=False)
    _run_family(plain, family)
    for i in (2,):
        assert ls.streams[i] == plain.streams[i]
    if family not in ("fused", "spec_fused"):  # lane 3 is the admission there
        assert ls.streams[3] == plain.streams[3]


# ---------------------------------------------------------------------------
# (d) the scheduler, the HTTP server and the journal
# ---------------------------------------------------------------------------

# (prompt, max_tokens, temperature, seed, response_format)
REQS = [
    ("give me json", 60, 0.0, None, {"type": "json_object"}),
    ("the flags", 80, 0.0, None, FLAGS_RF),
    ("the flags", 80, 0.8, 5, FLAGS_RF),
    ("sampled object", 60, 0.7, 9, {"type": "json_object"}),
    ("plain greedy", 24, 0.0, None, None),
    ("plain sampled", 24, 0.8, 21, None),
]
# the port's serving paths: (engine keywords, scheduler keywords)
CONFIGS = {
    "default": ({}, {}),
    "sync": ({"pipeline_depth": 0}, {"multi_step": 0, "speculative": False}),
    "multi": ({"pipeline_depth": 0}, {"multi_step": 4, "speculative": False}),
    "spec_sync": ({"pipeline_depth": 0}, {"multi_step": 0}),
    "pipelined": ({}, {"fused_prefill": False, "speculative": False}),
}


def _submit_all(sched, make, reqs):
    out = [sched.submit(make(prompt=p, max_tokens=m, temperature=t, seed=s,
                             response_format=rf)) for p, m, t, s, rf in reqs]
    for r in out:
        r.future.result(timeout=300)
    return [(r.finish_reason, list(r.generated_tokens), r.generated_text) for r in out]


@pytest.fixture(scope="module")
def jax_served(jstack):
    """The JAX scheduler's answers to REQS (its defaults: pipelined, fused
    admissions, speculation)."""
    je = _jengine(jstack)
    sched = JaxScheduler(je, JaxByteTokenizer(), prefix_min_tokens=0)
    sched.start()
    try:
        return _submit_all(sched, JaxRequest, REQS)
    finally:
        sched.stop()


def _psched(pstack, engine_kw=None, grammar=True, **kw):
    eng = _pengine(pstack, grammar=grammar, **(engine_kw or {}))
    sched = ContinuousBatchingScheduler(eng, ByteJsonTokenizer(), prefix_min_tokens=0, **kw)
    sched.start()
    return sched


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_scheduler_streams_equal_jax(pstack, jax_served, config):
    """Constrained (json_object, a json_schema; greedy and seeded) and
    plain requests served together: every request's tokens, text and
    finish equal the JAX scheduler's, on each of the port's serving paths;
    the constrained texts parse and conform."""
    engine_kw, sched_kw = CONFIGS[config]
    sched = _psched(pstack, engine_kw, **sched_kw)
    try:
        got = _submit_all(sched, Request, REQS)
        stats = sched.engine.stats.snapshot()
    finally:
        sched.stop()
    assert got == jax_served
    for (_, _, _, _, rf), (reason, _, text) in zip(REQS, got):
        if rf is not None and reason == "stop":
            obj = json.loads(text)
            assert isinstance(obj, dict)
            if rf is FLAGS_RF:
                assert set(obj) == {"ok", "mood", "n"} and obj["mood"] in ("a", "b")
    assert stats["grammar_lanes"] == 4 and stats["grammar_masked_steps"] > 0
    assert sched.engine.grammar_stats()["grammar_schemas_live"] == 0


def test_plain_requests_keep_their_streams_beside_constrained(pstack, jax_served):
    """The plain requests' tokens are those of a run with no constrained
    request at all."""
    sched = _psched(pstack)
    try:
        alone = _submit_all(sched, Request, REQS[4:])
    finally:
        sched.stop()
    assert alone == jax_served[4:]


def _serve(sched):
    api = ApiServer(sched, sched.tokenizer, model_name="grammar-test")
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def http_server(pstack):
    sched = _psched(pstack)
    httpd, url = _serve(sched)
    yield url
    httpd.shutdown()
    sched.stop()


def test_http_completion_and_chat_parse(http_server):
    """json_object and json_schema completions and chat completions, greedy
    and sampled: 200, and the text parses (a dict; the schema's keys for
    the schema). A random model's sampled json_object may open a string it
    never closes, so the sampled cases take the schema, whose values are
    bounded."""
    for route, key in (("/v1/completions", None), ("/v1/chat/completions", "chat")):
        body = {"max_tokens": 60, "response_format": {"type": "json_object"}}
        if key:
            body["messages"] = [{"role": "user", "content": "give me json"}]
        else:
            body["prompt"] = "give me json"
        status, out, _ = _post(http_server + route, body)
        text = out["choices"][0]["message"]["content"] if key else out["generated_text"]
        assert status == 200 and isinstance(json.loads(text), dict)
    for temp in (0.0, 0.8):
        status, body, _ = _post(http_server + "/v1/completions", {
            "prompt": "the flags", "max_tokens": 80, "temperature": temp, "seed": 4,
            "response_format": FLAGS_RF})
        assert status == 200 and set(json.loads(body["generated_text"])) == {"ok", "mood", "n"}
        status, body, _ = _post(http_server + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "fill the form"}], "max_tokens": 80,
            "temperature": temp, "seed": 4, "response_format": FLAGS_RF})
        assert status == 200
        obj = json.loads(body["choices"][0]["message"]["content"])
        assert set(obj) == {"ok", "mood", "n"}


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_http_400_on_malformed_response_format(http_server, i):
    status, body, _ = _post(http_server + "/v1/completions", {
        "prompt": "x", "max_tokens": 4, "response_format": MALFORMED[i]})
    assert status == 400 and "error" in body


def test_http_stats_carry_the_grammar_fields(http_server):
    _post(http_server + "/v1/completions", {"prompt": "one", "max_tokens": 8,
                                            "response_format": {"type": "json_object"}})
    stats = _get(http_server + "/stats")
    for key in ("grammar_lanes", "grammar_masked_steps", "grammar_schemas_installed",
                "grammar_schemas_live", "grammar_slab_states_used",
                "grammar_slab_states_total", "grammar_mask_argmax_launches",
                "grammar_next_launches", "grammar_mask_argmax_plain_calls",
                "grammar_next_plain_calls"):
        assert key in stats, key
    assert stats["grammar_lanes"] >= 1 and stats["grammar_masked_steps"] >= 1
    assert stats["grammar_mask_argmax_plain_calls"] > 0  # the CPU's plain versions
    metrics = urllib.request.urlopen(http_server + "/metrics", timeout=30).read().decode()
    assert "grammar_schemas_installed" in metrics


def test_http_grammar_off_answers_400(pstack):
    """An engine with no piece table (``--grammar off``): response_format
    gets a 400 naming it, a plain request is served."""
    sched = _psched(pstack, grammar=False)
    httpd, url = _serve(sched)
    try:
        status, body, _ = _post(url + "/v1/completions", {
            "prompt": "x", "max_tokens": 4, "response_format": {"type": "json_object"}})
        assert status == 400 and "structured output is disabled" in body["error"]
        status, _, _ = _post(url + "/v1/completions", {"prompt": "x", "max_tokens": 4})
        assert status == 200
    finally:
        httpd.shutdown()
        sched.stop()


def test_http_slab_full_sheds_429(pstack):
    """A slab held by a live schema sheds another schema with a typed,
    retryable 429 (the JAX scheduler's ``grammar_slab_full``), counted by
    the queue; the held schema is still served."""
    other_rf = {"type": "json_schema", "json_schema": {"schema": {"enum": ["x", "y"]}}}
    held = pg.compile_automaton(ENUM_RF, BYTE_TABLE, [EOS])
    other = pg.compile_automaton(other_rf, BYTE_TABLE, [EOS])
    # state 0 is FREE: room for either schema alone, not for both
    sched = _psched(pstack, {"grammar_slab_states": held.n_states + other.n_states})
    sched.engine.grammar_attach(ENUM_RF)  # live: refcount 1, never released
    httpd, url = _serve(sched)
    try:
        status, body, headers = _post(url + "/v1/completions", {
            "prompt": "x", "max_tokens": 4, "response_format": other_rf})
        assert status == 429 and body.get("reason") == "grammar_slab_full", body
        assert int(headers["Retry-After"]) >= 1
        # a schema too big for an empty slab is the schema's fault: a 400
        status, body, _ = _post(url + "/v1/completions", {
            "prompt": "x", "max_tokens": 4, "response_format": {"type": "json_object"}})
        assert status == 400 and "slab capacity" in body["error"]
        status, body, _ = _post(url + "/v1/completions", {
            "prompt": "x", "max_tokens": 20, "response_format": ENUM_RF})
        assert status == 200 and json.loads(body["generated_text"]) in ("happy", "sad", 3)
        assert sched.queue._rejected.get("grammar_slab_full") == 1
        stats = _get(url + "/stats")
        assert stats["grammar_schemas_installed"] == stats["grammar_schemas_live"] == 1
    finally:
        httpd.shutdown()
        sched.stop()


def test_export_session_carries_response_format(pstack):
    sched = _psched(pstack)
    try:
        req = Request(prompt="the flags", max_tokens=80, response_format=FLAGS_RF)
        seen = []
        req.on_delta = lambda d: (seen.append(sched.export_session(req.id)), time.sleep(0.005))
        sched.submit(req)
        req.future.result(timeout=120)
    finally:
        sched.stop()
    recs = [r for r in seen if r is not None]
    assert recs and all(r["response_format"] == FLAGS_RF for r in recs)


def _admit_constrained(journal, tok, rid, body):
    journal.record_admit(request_id=rid, prompt=body["prompt"], tokens=tok.encode(body["prompt"]),
                         max_tokens=body["max_tokens"], temperature=body["temperature"],
                         topp=0.9, seed=body.get("seed", 0), stop=[], add_bos=True,
                         add_special_tokens=True, user=None, priority=1, queue_timeout_s=None,
                         budget_s=None, stream=False, kind="completion",
                         response_format=body["response_format"])


JOURNAL_BODIES = [
    dict(prompt="the flags", max_tokens=60, temperature=0.0, response_format=FLAGS_RF),
    dict(prompt="sampled object", max_tokens=40, temperature=0.8, seed=8,
         response_format={"type": "json_object"}),
]


def test_constrained_journal_records_equal_jax(tmp_path):
    """The two writers frame a constrained admission into the same bytes,
    and each reads the other's back with its response_format."""
    paths = []
    for name, cls in (("port", RequestJournal), ("jax", j_journal.RequestJournal)):
        p = str(tmp_path / f"{name}.bin")
        j = cls(p, fsync=False)
        for i, b in enumerate(JOURNAL_BODIES):
            _admit_constrained(j, ByteJsonTokenizer(), 50 + i, b)
        assert j.flush()
        j.close()
        paths.append(p)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    for p in paths:
        assert [e.response_format for e in read_journal(p).incomplete()] == \
            [b["response_format"] for b in JOURNAL_BODIES]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_constrained_journal_recovers_in_the_other_package(pstack, jstack, tmp_path, writer):
    """Constrained admissions journaled by one package recover in the
    other's scheduler, regenerating the recovering package's uninterrupted
    answers (the two packages' answers are equal, above)."""
    p = str(tmp_path / "j.bin")
    cls = j_journal.RequestJournal if writer == "jax" else RequestJournal
    j = cls(p, fsync=False)
    ids = [2000 + i for i in range(len(JOURNAL_BODIES))]
    for rid, b in zip(ids, JOURNAL_BODIES):
        _admit_constrained(j, ByteJsonTokenizer(), rid, b)
    assert j.flush()
    j.close()
    if writer == "jax":  # the port recovers
        sched, make, recover = _psched(pstack), Request, recover_scheduler
    else:
        sched = JaxScheduler(_jengine(jstack), JaxByteTokenizer(), prefix_min_tokens=0)
        sched.start()
        make, recover = JaxRequest, j_recover
    try:
        coordinator = recover(sched, p)
        assert coordinator.join(120)
        assert [r.id for r in coordinator.requests] == ids
        got = [r.future.result(timeout=120) for r in coordinator.requests]
        ref = [sched.submit(make(topp=0.9, seed=b.get("seed", 0),
                                 **{k: v for k, v in b.items() if k != "seed"}))
               for b in JOURNAL_BODIES]
        want = [r.future.result(timeout=120) for r in ref]
    finally:
        sched.stop()
    assert got == want and all(got)


def test_constrained_crash_recovery_byte_identical(pstack, tmp_path):
    """A constrained request killed mid-stream (the journal detached, the
    scheduler stopped) regenerates from the journal to its uninterrupted
    text, which starts with what its client saw before the crash."""
    body = JOURNAL_BODIES[0]
    sched = _psched(pstack)
    try:
        ref = sched.submit(Request(**body)).future.result(timeout=120)
    finally:
        sched.stop()
    p = str(tmp_path / "j.bin")
    journal = RequestJournal(p, progress_every=1, fsync=False)
    sched = _psched(pstack, journal=journal)
    req = Request(**body)
    seen = []

    def on_delta(d):
        seen.append(d)
        time.sleep(0.01)

    req.on_delta = on_delta
    sched.submit(req)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and len(seen) < 5:
        time.sleep(0.002)
    sched.journal = None  # the kill: no finish record lands from here
    journal.flush()
    journal.close()
    sched.stop()
    assert 5 <= len(seen) and len(req.generated_tokens) < body["max_tokens"]
    incomplete = read_journal(p).incomplete()
    assert [e.request_id for e in incomplete] == [req.id]
    assert incomplete[0].response_format == FLAGS_RF
    sched2 = _psched(pstack, {"n_lanes": 2})
    try:
        coordinator = recover_scheduler(sched2, p)
        assert coordinator.join(60)
        got = coordinator.requests[0].future.result(timeout=120)
    finally:
        sched2.stop()
    assert got == ref and got.startswith("".join(seen))
    json.loads(got)
