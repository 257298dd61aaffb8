"""JSON / JSON-Schema subset -> token-level DFA over the tokenizer vocab
(the JAX package's ``grammar/automaton.py``, copied: same machine, same
tables byte for byte; numpy and the standard library only).

Two layers:

1. A byte-level CHARACTER machine for the requested format — generic JSON
   (``{"type": "json_object"}``: any object, bounded nesting) or a
   JSON-Schema subset (types object/array/string/number/integer/boolean/
   null, ``properties`` + ``required`` with declaration-order emission,
   ``enum`` of scalars, ``items``). States are hashable tuples
   ``(stack, mode)`` generated by BFS over a pure successor function, so
   the machine is exactly as large as its reachable state set.

2. A TOKEN closure: every vocab piece (its raw bytes) is walked through
   the character machine from every state at once — the per-byte
   transition tables compose as numpy gathers, so the closure is
   O(total piece bytes x states) vectorized, not a per-(state, token)
   Python walk. The result is the compiled artifact the device enforces:
   a packed ``[n_states, ceil(vocab/32)]`` uint32 legal-token mask table
   and a compact default-target + sparse-exception transition encoding
   (``next = edges.get((state, token), default[state])``), both exact
   per (state, token).

EOS tokens are legal exactly in ACCEPTING states (top-level value
complete), so a constrained greedy lane terminates the moment the model
wants to and cannot terminate earlier; whitespace may trail. Compiles are
cached per (vocab fingerprint, canonical schema hash) under a lock —
admission of a repeated schema is a dict hit.

The compiled masks/edges are byte-level EXACT: the host mirror
(``next_state`` / ``filter_prefix``) and the device tables are the same
arrays, which is what makes journal replay of constrained streams
deterministic from (prompt, seed, schema).
"""

from __future__ import annotations

import hashlib
import json
import threading

import numpy as np

from ..lockcheck import make_lock

# nesting bound for generic JSON (schema-directed nesting is bounded by
# the schema itself, but the same guard applies): containers deeper than
# this are not generatable — the documented "bounded nesting" subset.
# 4 keeps the generic json_object machine under ~500 states (the state
# count grows ~4x per extra level); schemas may nest to 6 (compile-time
# checked) since their state count is linear in the schema, not in depth
DEFAULT_MAX_DEPTH = 4
SCHEMA_MAX_DEPTH = 6
# bound on CONSECUTIVE whitespace bytes between tokens: unbounded ws
# self-loops would let a model burn its whole token budget on
# whitespace (never reaching the value, never reaching EOS) — with the
# cap, every masked-greedy walk terminates in O(value length) tokens
MAX_WS_RUN = 2

_WS = frozenset(b" \t\n\r")
_DIGITS = frozenset(b"0123456789")
_HEX = frozenset(b"0123456789abcdefABCDEF")
_ESCAPES = frozenset(b'"\\/bfnrtu')
_QUOTE, _BACKSLASH = 0x22, 0x5C

# node sentinel for "any JSON value" (generic mode / missing items)
_ANY = -1


class GrammarError(ValueError):
    """Invalid or unsupported ``response_format`` — the typed-400 class
    (ValueError family: request-scoped by the scheduler's containment
    classification, never an engine failure)."""


def validate_response_format(rf) -> dict:
    """Structural validation WITHOUT a tokenizer (the HTTP parse-time
    gate): raises :class:`GrammarError` on malformed input, returns the
    canonical ``{"type": ..., "schema": ...}`` form. The full token
    closure still happens at admission (it needs the vocab)."""
    if not isinstance(rf, dict):
        raise GrammarError("response_format must be an object")
    kind = rf.get("type")
    if kind == "json_object":
        return {"type": "json_object"}
    if kind != "json_schema":
        raise GrammarError(
            f"unsupported response_format type {kind!r} "
            "(supported: json_object, json_schema)"
        )
    js = rf.get("json_schema")
    if isinstance(js, dict) and "schema" in js:
        schema = js["schema"]  # OpenAI shape: {name, schema, strict}
    elif js is None and isinstance(rf.get("schema"), dict):
        # the CANONICAL form this function returns — must round-trip:
        # journal records carry it and recovery re-validates it
        schema = rf["schema"]
    else:
        schema = js
    if not isinstance(schema, dict):
        raise GrammarError("json_schema needs a schema object")
    # build the node tree now purely for validation (cheap, no vocab)
    _build_nodes(schema)
    return {"type": "json_schema", "schema": schema}


def canonical_key(rf: dict) -> str:
    """Stable hash of a validated response_format — the schema half of
    the compile-cache key and the slab entry key. ORDER-PRESERVING by
    design (no sort_keys): property declaration order is load-bearing
    (keys emit in that order), so two schemas differing only in
    property order are DIFFERENT grammars and must not share a cache
    entry or a slab installation."""
    canon = validate_response_format(rf)
    blob = json.dumps(canon, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def vocab_fingerprint(token_table) -> str:
    """Stable hash of the vocab piece table (the tokenizer half of the
    compile-cache key)."""
    h = hashlib.sha256()
    for piece in token_table:
        if piece is None:
            h.update(b"\0")
        else:
            p = bytes(piece)
            # length-prefixed: piece bytes may contain any value, so a
            # bare tag would let [b"a\x01b"] and [b"a", b"b"] collide
            h.update(b"\1" + len(p).to_bytes(4, "little") + p)
    return h.hexdigest()[:24]


# -- schema nodes ------------------------------------------------------------
#
# node := ("obj", ((name_bytes, child_id, required), ...))
#       | ("arr", child_id) | ("str",) | ("num",) | ("int",)
#       | ("bool",) | ("null",) | ("enum", (alt_bytes, ...)) | ("anyobj",)
# child_id == _ANY means "any JSON value" (generic machine).


def _build_nodes(schema, nodes=None, depth=0) -> int:
    """Compile a JSON-Schema subset into the node table; returns the root
    node id. Raises :class:`GrammarError` on anything outside the subset
    (docs/SERVING.md "Structured output" documents it)."""
    if nodes is None:
        nodes = []
    if depth > SCHEMA_MAX_DEPTH:
        raise GrammarError(
            f"schema nesting deeper than {SCHEMA_MAX_DEPTH} is unsupported"
        )
    if not isinstance(schema, dict):
        raise GrammarError("schema entries must be objects")
    if "enum" in schema:
        alts = []
        for v in schema["enum"]:
            if not isinstance(v, (str, int, float, bool)) and v is not None:
                raise GrammarError("enum values must be JSON scalars")
            alts.append(
                json.dumps(v, separators=(",", ":"), ensure_ascii=False)
                .encode()
            )
        if not alts:
            raise GrammarError("enum needs at least one value")
        nodes.append(("enum", tuple(alts)))
        return len(nodes) - 1
    kind = schema.get("type")
    if kind == "object":
        props = schema.get("properties")
        if props is None:
            nodes.append(("anyobj",))  # free-form object, ANY values
            return len(nodes) - 1
        if not isinstance(props, dict):
            raise GrammarError("properties must be an object")
        if schema.get("additionalProperties") not in (None, False):
            raise GrammarError("additionalProperties is unsupported")
        required = schema.get("required", [])
        if not isinstance(required, list) or any(
            r not in props for r in required
        ):
            raise GrammarError("required must list declared properties")
        entries = []
        for name, sub in props.items():
            nb = str(name).encode()
            if any(c in nb for c in (b'"'[0], b"\\"[0])) or any(
                c < 0x20 for c in nb
            ):
                raise GrammarError(
                    f"property name {name!r} needs JSON escapes (unsupported)"
                )
            entries.append((nb, _build_nodes(sub, nodes, depth + 1), name in required))
        nodes.append(("obj", tuple(entries)))
        return len(nodes) - 1
    if kind == "array":
        items = schema.get("items")
        child = _ANY if items is None else _build_nodes(items, nodes, depth + 1)
        nodes.append(("arr", child))
        return len(nodes) - 1
    if kind in ("string", "number", "integer", "boolean", "null"):
        nodes.append({
            "string": ("str",), "number": ("num",), "integer": ("int",),
            "boolean": ("bool",), "null": ("null",),
        }[kind])
        return len(nodes) - 1
    raise GrammarError(f"unsupported schema type {kind!r}")


# -- the character machine ---------------------------------------------------
#
# state := (stack, mode)
#   stack frames: ("AO",)         generic object
#                 ("AA",)         generic array
#                 ("O", oid, j)   schema object oid, last emitted prop j
#                 ("A", aid)      schema array aid
#   modes:  ("val", nid)          expect a value of node nid (ws ok)
#           ("str",)/("esc",)/("u",k)        value string internals
#           ("kstr",)/("kesc",)/("ku",k)     generic key string internals
#           ("oopen",)            after generic '{': ws | '"' | '}'
#           ("okeypre",)          after generic ',': ws | '"'
#           ("colon", nid)        after key close: ws | ':'
#           ("sopen", oid)        after schema '{': ws | '"' | maybe '}'
#           ("skeypre", oid, lo)  after schema ',': ws | '"'
#           ("skey", oid, lo, consumed_bytes)   schema key trie
#           ("num", sub, k)       sub in -0i.fesx, k "num"|"int"|"any"
#           ("lit", word, i)      literal progress
#           ("enum", nid, consumed_bytes)
#           ("post",)             value complete inside a container
#           ("end",)              top-level complete (accepting; ws loops)


class _CharMachine:
    """Public states are ``(core, ws_run)`` where core = (stack, mode):
    the wrapper counts CONSECUTIVE whitespace self-loops and cuts them at
    MAX_WS_RUN, so the token DFA cannot offer a model an unbounded
    whitespace sink (see MAX_WS_RUN). All grammar logic lives on cores."""

    def __init__(self, nodes, root: int, max_depth: int | None = None):
        self.nodes = nodes
        self.root = root
        # read the module default at CALL time (tests tune it)
        self.max_depth = (
            DEFAULT_MAX_DEPTH if max_depth is None else max_depth
        )
        self.start = (((), ("val", root)), 0)

    def step(self, state, c: int):
        """Successor of a PUBLIC state for byte ``c``, or None."""
        core, run = state
        nxt = self._step_core(core, c)
        if nxt is None:
            return None
        if c in _WS:
            if nxt == core:  # pure whitespace self-loop: count it
                if run >= MAX_WS_RUN:
                    return None
                return (nxt, run + 1)
            return (nxt, 1)  # ws consumed as a delimiter opens a run
        return (nxt, 0)

    def accepting(self, state) -> bool:
        return self._accepting_core(state[0])

    def _node(self, nid):
        return ("any",) if nid == _ANY else self.nodes[nid]

    # first required property index >= lo, or a big sentinel: keys may be
    # emitted in declaration order only, and no required one may be skipped
    @staticmethod
    def _req_bound(props, lo: int) -> int:
        for k in range(lo, len(props)):
            if props[k][2]:
                return k
        return len(props)

    def _complete(self, stack):
        return (stack, ("post",)) if stack else (stack, ("end",))

    def _value_start(self, stack, nid, c):
        """Transition for byte ``c`` opening a value of node ``nid``
        (whitespace handled by the caller). None = illegal."""
        node = self._node(nid)
        kind = node[0]
        if kind == "any":
            if c == ord("{"):
                if len(stack) >= self.max_depth:
                    return None
                return (stack + (("AO",),), ("oopen",))
            if c == ord("["):
                if len(stack) >= self.max_depth:
                    return None
                return (stack + (("AA",),), ("aopen",))
            if c == _QUOTE:
                return (stack, ("str",))
            if c == ord("-") or c in _DIGITS:
                return self._num_start(stack, c, "any")
            for word in (b"true", b"false", b"null"):
                if c == word[0]:
                    return (stack, ("lit", word, 1))
            return None
        if kind == "anyobj":
            if c == ord("{"):
                if len(stack) >= self.max_depth:
                    return None
                return (stack + (("AO",),), ("oopen",))
            return None
        if kind == "obj":
            if c == ord("{"):
                if len(stack) >= self.max_depth:
                    return None
                return (stack + (("O", nid, -1),), ("sopen", nid))
            return None
        if kind == "arr":
            if c == ord("["):
                if len(stack) >= self.max_depth:
                    return None
                return (stack + (("A", nid),), ("aopen",))
            return None
        if kind == "str":
            return (stack, ("str",)) if c == _QUOTE else None
        if kind in ("num", "int"):
            if c == ord("-") or c in _DIGITS:
                return self._num_start(stack, c, kind)
            return None
        if kind == "bool":
            if c == ord("t"):
                return (stack, ("lit", b"true", 1))
            if c == ord("f"):
                return (stack, ("lit", b"false", 1))
            return None
        if kind == "null":
            return (stack, ("lit", b"null", 1)) if c == ord("n") else None
        if kind == "enum":
            alts = node[1]
            if any(a and a[0] == c for a in alts):
                return self._enum_state(stack, nid, bytes([c]))
            return None
        raise AssertionError(f"unknown node kind {kind}")

    def _num_start(self, stack, c, k):
        if c == ord("-"):
            return (stack, ("num", "-", k))
        if c == ord("0"):
            return (stack, ("num", "0", k))
        return (stack, ("num", "i", k))  # 1-9

    def _enum_state(self, stack, nid, consumed):
        alts = self._node(nid)[1]
        if consumed in alts and not any(
            len(a) > len(consumed) and a.startswith(consumed) for a in alts
        ):
            # uniquely complete: the value ends here
            return self._complete(stack)
        return (stack, ("enum", nid, consumed))

    def _step_core(self, state, c: int):
        """Successor CORE state for byte ``c``, or None (illegal)."""
        stack, mode = state
        m = mode[0]

        if m == "end":
            return state if c in _WS else None

        if m == "val":
            if c in _WS:
                return state
            return self._value_start(stack, mode[1], c)

        # ---- strings (value and generic-key) ----
        if m in ("str", "kstr"):
            if c == _QUOTE:
                if m == "kstr":
                    return (stack, ("colon", _ANY))
                return self._complete(stack)
            if c == _BACKSLASH:
                return (stack, ("esc" if m == "str" else "kesc",))
            return state if c >= 0x20 else None
        if m in ("esc", "kesc"):
            if c not in _ESCAPES:
                return None
            base = "str" if m == "esc" else "kstr"
            if c == ord("u"):
                return (stack, ("u" if m == "esc" else "ku", 4))
            return (stack, (base,))
        if m in ("u", "ku"):
            if c not in _HEX:
                return None
            left = mode[1] - 1
            base = "str" if m == "u" else "kstr"
            if left == 0:
                return (stack, (base,))
            return (stack, (m, left))

        # ---- generic object/array structure ----
        if m == "oopen":
            if c in _WS:
                return state
            if c == _QUOTE:
                return (stack, ("kstr",))
            if c == ord("}"):
                return self._complete(stack[:-1])
            return None
        if m == "okeypre":
            if c in _WS:
                return state
            return (stack, ("kstr",)) if c == _QUOTE else None
        if m == "aopen":
            if c in _WS:
                return state
            if c == ord("]"):
                return self._complete(stack[:-1])
            top = stack[-1]
            nid = _ANY if top[0] == "AA" else self._node(top[1])[1]
            return self._value_start(stack, nid, c)
        if m == "colon":
            if c in _WS:
                return state
            return (stack, ("val", mode[1])) if c == ord(":") else None

        # ---- schema object keys ----
        if m == "sopen":
            oid = mode[1]
            props = self._node(oid)[1]
            if c in _WS:
                return state
            if c == _QUOTE and props:
                return (stack, ("skey", oid, 0, b""))
            if c == ord("}") and self._req_bound(props, 0) == len(props):
                return self._complete(stack[:-1])
            return None
        if m == "skeypre":
            _, oid, lo = mode
            if c in _WS:
                return state
            return (stack, ("skey", oid, lo, b"")) if c == _QUOTE else None
        if m == "skey":
            _, oid, lo, consumed = mode
            props = self._node(oid)[1]
            hi = self._req_bound(props, lo)  # may not skip past a required
            cands = range(lo, min(hi, len(props) - 1) + 1)
            if c == _QUOTE:
                for k in cands:
                    if props[k][0] == consumed:
                        # frame remembers the emitted property index
                        frame = ("O", oid, k)
                        return (
                            stack[:-1] + (frame,),
                            ("colon", props[k][1]),
                        )
                return None
            nxt = consumed + bytes([c])
            if any(props[k][0].startswith(nxt) for k in cands):
                return (stack, ("skey", oid, lo, nxt))
            return None

        # ---- numbers (implicitly terminated: delimiters re-dispatch) ----
        if m == "num":
            _, sub, k = mode
            frac_ok = k != "int"
            if sub == "-":
                if c == ord("0"):
                    return (stack, ("num", "0", k))
                if c in _DIGITS:
                    return (stack, ("num", "i", k))
                return None
            if sub in ("0", "i", "f", "x"):
                if c in _DIGITS and sub != "0":
                    return (stack, ("num", sub, k))
                if c in _DIGITS and sub == "0":
                    return None  # no leading zeros
                if c == ord(".") and sub in ("0", "i") and frac_ok:
                    return (stack, ("num", ".", k))
                if c in b"eE" and sub in ("0", "i", "f") and frac_ok:
                    return (stack, ("num", "e", k))
                # number complete: the delimiter belongs to the container
                return self._step_core(self._complete(stack), c)
            if sub == ".":
                return (stack, ("num", "f", k)) if c in _DIGITS else None
            if sub == "e":
                if c in b"+-":
                    return (stack, ("num", "es", k))
                return (stack, ("num", "x", k)) if c in _DIGITS else None
            if sub == "es":
                return (stack, ("num", "x", k)) if c in _DIGITS else None
            return None

        if m == "lit":
            _, word, i = mode
            if c != word[i]:
                return None
            if i + 1 == len(word):
                return self._complete(stack)
            return (stack, ("lit", word, i + 1))

        if m == "enum":
            _, nid, consumed = mode
            alts = self._node(nid)[1]
            nxt = consumed + bytes([c])
            if any(a.startswith(nxt) for a in alts):
                return self._enum_state(stack, nid, nxt)
            if consumed in alts:
                # a shorter alternative completed here; delimiter follows
                return self._step_core(self._complete(stack), c)
            return None

        # ---- value complete inside a container ----
        if m == "post":
            if c in _WS:
                return state
            top = stack[-1]
            if top[0] == "AO":
                if c == ord(","):
                    return (stack, ("okeypre",))
                if c == ord("}"):
                    return self._complete(stack[:-1])
                return None
            if top[0] == "AA":
                if c == ord(","):
                    return (stack, ("val", _ANY))
                if c == ord("]"):
                    return self._complete(stack[:-1])
                return None
            if top[0] == "A":
                if c == ord(","):
                    return (stack, ("val", self._node(top[1])[1]))
                if c == ord("]"):
                    return self._complete(stack[:-1])
                return None
            # ("O", oid, j)
            _, oid, j = top
            props = self._node(oid)[1]
            if c == ord(",") and j + 1 < len(props):
                # something must still be emittable after the comma
                return (stack, ("skeypre", oid, j + 1))
            if c == ord("}") and self._req_bound(props, j + 1) == len(props):
                return self._complete(stack[:-1])
            return None

        raise AssertionError(f"unknown mode {mode}")

    def _accepting_core(self, state) -> bool:
        """Top-level value complete: EOS is legal here (and only here)."""
        stack, mode = state
        if stack:
            return False
        m = mode[0]
        if m == "end":
            return True
        if m == "num":
            return mode[1] in ("0", "i", "f", "x")
        if m == "enum":
            alts = self._node(mode[1])[1]
            return mode[2] in alts
        return False


# -- token closure -----------------------------------------------------------


class GrammarAutomaton:
    """The compiled artifact: per-state packed legal-token masks + the
    compact (default target, sparse exceptions) transition encoding —
    identical arrays on host (mirror) and device (slab upload)."""

    def __init__(self, key: str, n_states: int, vocab_size: int,
                 masks: np.ndarray, default_next: np.ndarray,
                 edge_keys: np.ndarray, edge_next: np.ndarray,
                 accepting: np.ndarray):
        self.key = key
        self.n_states = int(n_states)
        self.vocab_size = int(vocab_size)
        self.masks = masks  # [S, ceil(V/32)] uint32, little bit order
        self.default_next = default_next  # [S] int32 (LOCAL state ids)
        self.edge_keys = edge_keys  # [E] int64 sorted: s * V + tok
        self.edge_next = edge_next  # [E] int32 (LOCAL state ids)
        self.accepting = accepting  # [S] bool
        self.start = 0

    # -- host mirror (draft filtering, replay determinism) ------------------

    def is_legal(self, state: int, tok: int) -> bool:
        word = int(self.masks[state, tok >> 5])
        return bool((word >> (tok & 31)) & 1)

    def legal_ids(self, state: int) -> np.ndarray:
        """All legal token ids in ``state`` (unpacked mask row) — the
        parity-test oracle."""
        bits = np.unpackbits(
            self.masks[state].view(np.uint8), bitorder="little"
        )[: self.vocab_size]
        return np.nonzero(bits)[0]

    def next_state(self, state: int, tok: int) -> int:
        """LOCAL-state transition; the caller guarantees legality (the
        device mask did). Illegal tokens return the default target —
        bounded junk, same as the device rule."""
        key = state * self.vocab_size + tok
        i = int(np.searchsorted(self.edge_keys, key))
        if i < len(self.edge_keys) and int(self.edge_keys[i]) == key:
            return int(self.edge_next[i])
        return int(self.default_next[state])

    def filter_prefix(self, state: int, tokens) -> int:
        """Longest prefix of ``tokens`` legal from ``state`` — the host
        pre-filter for speculative drafts (a rejected draft is simply not
        proposed; device verification stays exact either way)."""
        n = 0
        for t in tokens:
            if not self.is_legal(state, int(t)):
                break
            state = self.next_state(state, int(t))
            n += 1
        return n


def _compile_char_machine(rf: dict, max_depth: int | None = None):
    canon = validate_response_format(rf)
    if canon["type"] == "json_object":
        nodes = [("anyobj",)]
        root = 0
    else:
        nodes = []
        root = _build_nodes(canon["schema"], nodes)
        if max_depth is None:
            # schema-directed nesting is schema-bounded; the runtime bound
            # only has to cover it (plus any free-form anyobj tail)
            max_depth = SCHEMA_MAX_DEPTH
    return _CharMachine(nodes, root, max_depth=max_depth)


# compile cache: (vocab fingerprint, schema hash) -> GrammarAutomaton.
# Shared across engines/schedulers (admissions of a repeated schema are a
# dict hit); every read and write of _cache holds _cache_lock.
_cache_lock = make_lock("automaton._cache_lock")
_cache: dict = {}


def compile_automaton(rf: dict, token_table, eos_ids,
                      vocab_key: str | None = None,
                      max_states: int = 4096,
                      max_depth: int | None = None) -> GrammarAutomaton:
    """Compile ``response_format`` against a vocab piece table
    (``token_table[i]`` = raw bytes of token i, None for special tokens,
    which are illegal everywhere; ``eos_ids`` become legal exactly in
    accepting states). Cached per (vocab, schema, nesting bound)."""
    if vocab_key is None:
        vocab_key = vocab_fingerprint(token_table)
    skey = canonical_key(rf)
    ckey = (vocab_key, skey, max_depth)
    with _cache_lock:
        hit = _cache.get(ckey)
    if hit is not None:
        return hit

    machine = _compile_char_machine(rf, max_depth=max_depth)
    states, ids = [machine.start], {machine.start: 0}
    trans_rows = []  # per state: [256] int32 of successor ids (DEAD later)
    i = 0
    while i < len(states):
        st = states[i]
        row = np.full(256, -1, np.int64)
        for c in range(256):
            nxt = machine.step(st, c)
            if nxt is None:
                continue
            j = ids.get(nxt)
            if j is None:
                if len(states) >= max_states:
                    raise GrammarError(
                        f"schema compiles to more than {max_states} "
                        "character states"
                    )
                j = len(states)
                ids[nxt] = j
                states.append(nxt)
            row[c] = j
        trans_rows.append(row)
        i += 1

    S = len(states)
    V = len(token_table)
    DEAD = S
    char_trans = np.full((256, S + 1), DEAD, np.int32)
    for s, row in enumerate(trans_rows):
        live = row >= 0
        char_trans[live, s] = row[live]
    # DEAD column self-loops by construction (initialized to DEAD)

    # token closure: compose per-byte maps, all tokens in parallel.
    # maps[t, s] = state after feeding token t's bytes from state s
    maps = np.tile(np.arange(S + 1, dtype=np.int32), (V, 1))
    pieces = [
        None if p is None else bytes(p) for p in token_table
    ]
    max_len = max((len(p) for p in pieces if p), default=0)
    for pos in range(max_len):
        sel = np.fromiter(
            (p is not None and len(p) > pos for p in pieces),
            np.bool_, count=V,
        )
        if not sel.any():
            break
        b = np.fromiter(
            (p[pos] if (p is not None and len(p) > pos) else 0
             for p in pieces),
            np.int32, count=V,
        )
        rows = char_trans[b[sel]]  # [n_sel, S+1]
        maps[sel] = np.take_along_axis(rows, maps[sel], axis=1)
    # special / empty pieces are illegal everywhere
    dead_tok = np.fromiter(
        (p is None or len(p) == 0 for p in pieces), np.bool_, count=V
    )
    maps[dead_tok] = DEAD
    # EOS: legal exactly in accepting states, self-loop target (the lane
    # finishes on it; the state no longer matters but must stay in range)
    acc = np.fromiter(
        (machine.accepting(st) for st in states), np.bool_, count=S
    )
    for e in eos_ids:
        if 0 <= int(e) < V:
            row = np.full(S + 1, DEAD, np.int32)
            row[:S][acc] = np.arange(S, dtype=np.int32)[acc]
            maps[int(e)] = row

    legal = maps[:, :S] != DEAD  # [V, S]

    # reachability over TOKEN transitions from the start state: a state
    # only matters if some legal token sequence reaches it, and every
    # reachable state must offer at least one legal token (else masked
    # sampling would face an all--inf row mid-request)
    reach = np.zeros(S, np.bool_)
    frontier = [0]
    reach[0] = True
    while frontier:
        s = frontier.pop()
        # vectorized successor set: a string-interior state has ~vocab
        # legal tokens, and a per-token Python walk would put tens of
        # millions of iterations on the admission path for real vocabs
        for n in np.unique(maps[:, s][legal[:, s]]):
            n = int(n)
            if n < S and not reach[n]:
                reach[n] = True
                frontier.append(n)
    bad = reach & ~legal.any(axis=0)
    if bad.any():
        s = int(np.nonzero(bad)[0][0])
        raise GrammarError(
            "grammar dead-ends under this tokenizer: reachable state "
            f"{s} ({states[s]!r}) has no legal token"
        )
    # co-reachability: a reachable state from which ACCEPTANCE (an EOS
    # emission) can never be reached is a livelock — the lane would
    # generate forever and every completion would truncate at
    # max_tokens. Classic example: a vocab whose pieces can open a JSON
    # string but never close one. Fixpoint over the token graph.
    co = acc.copy()
    targets = maps[:, :S]  # [V, S]; DEAD == S indexes the padded False
    while True:
        co_ext = np.concatenate([co, [False]])
        new = co | (legal & co_ext[targets]).any(axis=0)
        if np.array_equal(new, co):
            break
        co = new
    stuck = reach & ~co
    if stuck.any():
        s = int(np.nonzero(stuck)[0][0])
        raise GrammarError(
            "grammar cannot complete under this tokenizer: reachable "
            f"state {s} ({states[s]!r}) has no path to a legal EOS"
        )

    # packed masks: bit t of word t>>5, little bit order (matches the
    # device unpack (word >> (t & 31)) & 1)
    W = (V + 31) // 32
    bits = np.zeros((S, W * 32), np.uint8)
    bits[:, :V] = legal.T
    masks = np.ascontiguousarray(
        np.packbits(bits, axis=1, bitorder="little")  # [S, W*4] uint8
    ).view(np.uint32).reshape(S, W)

    # compact transitions: per-state majority target as the default, the
    # rest as sorted sparse exceptions keyed s * V + tok
    default_next = np.zeros(S, np.int32)
    ek, en = [], []
    for s in range(S):
        col = maps[:, s]
        toks = np.nonzero(legal[:, s])[0]
        if len(toks) == 0:
            continue  # unreachable (checked above for reachable states)
        targets = col[toks]
        counts = np.bincount(targets, minlength=S)
        d = int(np.argmax(counts))
        default_next[s] = d
        exc = toks[targets != d]
        ek.extend((int(s) * V + int(t) for t in exc))
        en.extend((int(col[t]) for t in exc))
    edge_keys = np.asarray(ek, np.int64)
    edge_next = np.asarray(en, np.int32)
    order = np.argsort(edge_keys, kind="stable")
    auto = GrammarAutomaton(
        key=skey, n_states=S, vocab_size=V, masks=masks,
        default_next=default_next, edge_keys=edge_keys[order],
        edge_next=edge_next[order], accepting=acc,
    )
    with _cache_lock:
        _cache[ckey] = auto
    return auto
