"""Per-site dequant mode selection for ``DLLAMA_DEQUANT=auto``.

"auto" resolves each matmul site's mode deterministically from a small
table keyed by (d_in, d_out, m-class): ``dequant_table.json`` beside this
file, loaded once on first use. m-class "decode" is m <= BLOCKDOT_MAX_M (the
blockdot family's own cap), "prefill" everything wider.
"""

from __future__ import annotations

import json
import os
import threading

_DEFAULT_TABLE = os.path.join(os.path.dirname(__file__), "dequant_table.json")

M_CLASSES = ("decode", "prefill")

# when no table rule matches at all (the shipped table always matches via
# wildcards): the bf16 chain every mode falls back to
FALLBACK_MODE = "bf16chain"


def m_class_of(m: int) -> str:
    from .cuda_q40 import BLOCKDOT_MAX_M

    return "decode" if m <= BLOCKDOT_MAX_M else "prefill"


class DequantTable:
    """The (d_in, d_out, m-class) -> mode table. Rules match exact values or
    "*"; the most specific matching rule wins (each exact field scores one,
    ties keep the earlier row). Unknown modes or m-classes fail the load."""

    def __init__(self, path: str = _DEFAULT_TABLE):
        from .cuda_q40 import DEQUANT_MODES

        self.path = path
        with open(self.path) as f:
            data = json.load(f)
        rules = data.get("rules", [])
        for r in rules:
            if r.get("mode") not in DEQUANT_MODES:
                raise ValueError(
                    f"{self.path}: rule {r!r} has unknown mode "
                    f"{r.get('mode')!r}; one of {DEQUANT_MODES}"
                )
            if r.get("m_class", "*") not in M_CLASSES + ("*",):
                raise ValueError(
                    f"{self.path}: rule {r!r} has unknown m_class "
                    f"{r.get('m_class')!r}; one of {M_CLASSES + ('*',)}"
                )
        self.rules = rules
        self.provenance = {
            "path": self.path,
            "version": data.get("version"),
            "updated": data.get("updated"),
            "rows": len(rules),
            "provenance": data.get("provenance"),
        }

    def resolve(self, d_in: int, d_out: int, m_class: str) -> str:
        best, best_score = None, -1
        for r in self.rules:
            score = 0
            for key, val in (("d_in", d_in), ("d_out", d_out),
                             ("m_class", m_class)):
                rv = r.get(key, "*")
                if rv == "*":
                    continue
                if rv != val:
                    score = -1
                    break
                score += 1
            if score > best_score:
                best, best_score = r, score
        if best is None:
            return FALLBACK_MODE
        return best["mode"]


_lock = threading.Lock()
_table: DequantTable | None = None
_sites: dict[str, str] = {}  # "d_inxd_out/m_class" -> resolved mode


def _get_table() -> DequantTable:
    global _table
    with _lock:
        if _table is None:
            _table = DequantTable()
        return _table


def resolve_mode(d_in: int, d_out: int, m: int) -> str:
    """The table's mode for this site, recorded into the site map that
    ``/stats`` serves."""
    cls = m_class_of(m)
    mode = _get_table().resolve(d_in, d_out, cls)
    with _lock:
        _sites[f"{d_in}x{d_out}/{cls}"] = mode
    return mode


def table_provenance() -> dict:
    """The table's provenance (path, version, rows), loading it if needed."""
    return dict(_get_table().provenance)


def _reset_for_tests() -> None:
    global _table
    with _lock:
        _table = None
        _sites.clear()


def dequant_stats() -> dict:
    """The configured mode, the per-site resolutions (auto) and the table's
    provenance when one is loaded — for ``/stats``."""
    from . import cuda_q40

    out = {"dequant_mode": cuda_q40.DEQUANT_MODE}
    with _lock:
        if _sites:
            out["dequant_sites"] = dict(_sites)
        if _table is not None:
            out["dequant_table"] = dict(_table.provenance)
    return out
