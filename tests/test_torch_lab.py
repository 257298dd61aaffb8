"""The kernel lab's port (``lab/``, ``ops/cuda_lab.py``) against the JAX lab
scripts' Pallas kernels in interpret mode, at small sizes.

The scripts are imported by path and left as they are: ``pl.pallas_call``
is patched to ``interpret=True`` for this module, and the kernels built
inside each script's ``main()`` are reached by replacing its ``timeit``
with a function that keeps each ``build_call`` closure; the closures'
operands are read from their defaults and cells and handed, as numpy, to
the port's plain versions. ``main()`` runs at the smallest shape its grids
allow (d_in 2048, d_out 2048, L 1: one plane, one step along each grid axis
whose step overwrites the output), where the JAX probes' last-step output
equals the port's sum over the whole stack.

Tolerances: exact for the integer probes and the DMA stage; max|Δ| ≤
1e-4·max|y_jax| for the products and the scale probe (the same operand
roundings, only the f32 summation order differs).
"""

import functools
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from distributed_llama_multiusers_tpu_torch.lab import (
    kernel_lab,
    kernel_lab3,
    stage_probe,
    stage_probe2,
)
from distributed_llama_multiusers_tpu_torch.ops import cuda_lab as lab
from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
from distributed_llama_multiusers_tpu_torch.ops import dequant_select
from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
MAIN_ARGV = ["2048", "2048", "1"]


@pytest.fixture(scope="module", autouse=True)
def interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        yield


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_lab_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(mod, argv):
    """Run ``mod.main()`` with ``timeit`` keeping each build_call closure."""
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "timeit", lambda name, build_call, *a, **k: calls.setdefault(
            name, build_call))
        if hasattr(mod, "timeit_xla"):
            mp.setattr(mod, "timeit_xla", lambda *a, **k: None)
        mp.setattr(sys, "argv", ["lab", *argv])
        mod.main()
    return calls


def _env(fn) -> dict:
    """A closure's operands: its cells, its defaults, a partial's keywords."""
    if isinstance(fn, functools.partial):
        return {**_env(fn.func), **fn.keywords}
    env = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__ or ())))
    env.update({k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty})
    return env


def _run(fn):
    return np.asarray(fn(jnp.zeros((1, 128), jnp.float32)), np.float32)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.int16:  # f16 scale bits
        a = a.view(np.float16)
    return torch.from_numpy(np.array(a, copy=True))


def _join(x_lo, x_hi) -> torch.Tensor:
    """Block-local halves [m, d_in/2] back to x [m, d_in] (f32)."""
    lo, hi = np.asarray(x_lo, np.float32), np.asarray(x_hi, np.float32)
    m, half = lo.shape
    x = np.stack([lo.reshape(m, half // 16, 16), hi.reshape(m, half // 16, 16)], axis=2)
    return torch.from_numpy(x.reshape(m, 2 * half).copy())


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32).reshape(-1), np.asarray(want, np.float32).reshape(-1)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).reshape(-1),
                                  np.asarray(want, np.float32).reshape(-1))


# ---------------------------------------------------------------------------
# scripts/kernel_lab.py: q40_matmul_v1, q40_matmul_v2, read_probe
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def klab():
    return _script("kernel_lab")


@pytest.fixture(scope="module")
def plane():
    rng = np.random.default_rng(3)
    d_in, d_out = 1024, 1024
    packed = rng.integers(0, 256, (d_in // 2, d_out), np.uint8)
    scales = (rng.random((d_in // 32, d_out), np.float32) * 0.01 + 1e-3).astype(np.float16)
    x = rng.standard_normal((3, d_in), np.float32)
    return x, packed, scales


@pytest.mark.parametrize("w_dtype,x_dtype,w_round,x_round", [
    ("float32", "float32", "f32", False),
    ("bfloat16", "float32", "product_bf16", False),  # v1_bf16w: x stays f32
    ("bfloat16", "bfloat16", "product_bf16", True),  # v1_bf16wx
])
def test_v1_matches_jax(klab, plane, w_dtype, x_dtype, w_round, x_round):
    x, packed, scales = plane
    y = klab.q40_matmul_v1(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                           din_chunk=512, dout_tile=512, w_dtype=getattr(jnp, w_dtype),
                           x_dtype=getattr(jnp, x_dtype))
    got = lab.q40_lab_twodot(torch.from_numpy(x), _t(packed), _t(scales), w_round, x_round)
    _close(got, y)


@pytest.mark.parametrize("w_dtype,w_round,x_round", [("float32", "f32", False),
                                                     ("bfloat16", "chain_bf16", True)])
def test_v2_matches_jax(klab, plane, w_dtype, w_round, x_round):
    x, packed, scales = plane
    pt, st = klab.retile(jnp.asarray(packed), jnp.asarray(scales))
    tp, ts = lab.retile(_t(packed), _t(scales))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(pt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(st).view(np.float16))
    y = klab.q40_matmul_v2(jnp.asarray(x), pt, st, din_chunk=512,
                           w_dtype=getattr(jnp, w_dtype), x_dtype=getattr(jnp, w_dtype))
    _close(lab.q40_lab_twodot(torch.from_numpy(x), tp, ts, w_round, x_round), y)


def test_read_probe_matches_jax(klab, plane):
    _, packed, _ = plane
    y = klab.read_probe(jnp.asarray(packed), chunk=512, tile=512)
    _exact(lab.q40_probe(_t(packed)[None], "bytes"), y)


# ---------------------------------------------------------------------------
# scripts/stage_probe.py: staged, staged32, the dot-only and full closures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sprobe():
    return _capture(_script("stage_probe"), MAIN_ARGV)


def test_stage_probe_variants_are_the_ports(sprobe):
    assert list(sprobe) == ([n for n, _, _ in stage_probe.U8_STAGES]
                            + [n for n, _, _ in stage_probe.U32_STAGES]
                            + ["dot_only bf16", "dot_only f32"]
                            + [n for n, _, _ in stage_probe.FULL])


@pytest.mark.parametrize("name,stage", [(n, s) for n, s, _ in stage_probe.U8_STAGES])
def test_stage_probe_u8_stages(sprobe, name, stage):
    env = _env(sprobe[name])
    packed = _t(env["packed"])
    scales = _t(env["sbits"]) if stage == "scale" else None
    got = lab.q40_probe(packed, stage, scales, tile_rows=stage_probe.CHUNK // 2)
    (_close if stage == "scale" else _exact)(got, _run(sprobe[name]))


@pytest.mark.parametrize("name,stage", [(n, s) for n, s, _ in stage_probe.U32_STAGES])
def test_stage_probe_u32_stages(sprobe, name, stage):
    env = _env(sprobe[name])
    p32 = _t(env["p32"])
    # the port's words are a view of the packed bytes, as stage_probe.py:235 bitcasts them
    assert torch.equal(_t(_env(sprobe["u8 dma"])["packed"]).view(torch.int32), p32)
    _exact(lab.q40_probe(p32, stage), _run(sprobe[name]))


@pytest.mark.parametrize("name", ["dot_only bf16", "dot_only f32"])
def test_stage_probe_dot_only(sprobe, name):
    env = _env(sprobe[name])
    x = torch.from_numpy(np.array(env["x_op"], np.float32))
    w = torch.from_numpy(np.array(env["w_stack"], np.float32)[0])
    dt = torch.bfloat16 if "bf16" in name else torch.float32
    _close(lab.dense_dot(x.to(dt), w.to(dt)), _run(sprobe[name]))


@pytest.mark.parametrize("name,w_round,x_round", stage_probe.FULL)
def test_stage_probe_full(sprobe, name, w_round, x_round):
    env = _env(sprobe[name])
    x = _join(env["xl"], env["xh"])
    got = lab.q40_lab_twodot(x, _t(env["packed"])[0], _t(env["sbits"])[0], w_round, x_round,
                             correction=False)
    _close(got, _run(sprobe[name]))


# ---------------------------------------------------------------------------
# scripts/stage_probe2.py: dma_call, scale_call, full_call, dma_wide
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sprobe2():
    return _capture(_script("stage_probe2"), MAIN_ARGV)


SLAB_NAMES = [f"slab T={T} {k}" for T in stage_probe2.SLABS
              for k in ("dma", "dequant+scale", "full f32", "full bf16")]


@pytest.mark.parametrize("name", SLAB_NAMES + [f"wide rows={r} dma" for r in
                                               stage_probe2.WIDE_ROWS])
def test_stage_probe2(sprobe2, name):
    fn = sprobe2[name]
    env = _env(fn)
    want = _run(fn)
    if name.startswith("wide"):
        got = lab.q40_probe(_t(env["stacked"]), "dma", tile_rows=int(name.split("=")[1][:-4]))
        return _exact(got, want)
    slab = _t(env["slab"])
    if name.endswith("dma"):
        return _exact(lab.q40_probe(slab, "dma"), want)
    if name.endswith("scale"):
        return _close(lab.q40_probe(slab, "scale", _t(env["slab_s"])), want)
    bf16 = env["w_dt"] == jnp.bfloat16
    got = lab.q40_lab_twodot(_join(env["x_lo"], env["x_hi"]), slab[0], _t(env["slab_s"])[0],
                             "product_bf16" if bf16 else "f32", bf16, correction=False)
    _close(got, want)


def test_stage_probe2_slab_is_retile(sprobe2):
    """The JAX slab is the port's ``retile`` of one plane."""
    env = _env(sprobe2["slab T=1024 full f32"])
    slab, slab_s = _t(env["slab"]), _t(env["slab_s"])
    plane = _t(_env(sprobe2["wide rows=256 dma"])["stacked"])[0]
    n_blk, d_out = plane.shape[0] // 16, plane.shape[1]
    flat_s = slab_s[0].permute(1, 0, 2).reshape(n_blk, d_out)
    tp, ts = lab.retile(plane, flat_s, 1024)
    assert torch.equal(tp, slab[0]) and torch.equal(ts, slab_s[0])


# ---------------------------------------------------------------------------
# scripts/kernel_lab3.py: _call_kernel, _call_i8blockdot and main's closures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def klab3():
    return _script("kernel_lab3")


@pytest.fixture(scope="module")
def klab3_main(klab3):
    return _capture(klab3, MAIN_ARGV)


@pytest.fixture(scope="module")
def check_inputs():
    """kernel_lab3.check()'s inputs (numpy seed 0), with one zero x block."""
    chunk, tile = 512, 256
    d_in, d_out = chunk, tile * 2
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, (d_in // 2, d_out), np.uint8)
    scales = (rng.random((d_in // 32, d_out), np.float32) * 0.01 + 1e-3).astype(np.float16)
    xf = rng.standard_normal((kernel_lab3.M, d_in), np.float32)
    xf[2, 32:64] = 0.0
    return xf, packed, scales, chunk, tile


def _port_product(name, xf, packed, scales):
    x = torch.from_numpy(np.ascontiguousarray(xf))
    w = PackedQ40(_t(packed), _t(scales))
    return kernel_lab3.product(name, q.make_q80_acts(x), lab.lab_acts(x), w)


@pytest.mark.parametrize("name", list(kernel_lab3.VARIANTS)[:5])
def test_kernel_lab3_call_kernel(klab3, check_inputs, monkeypatch, name):
    xf, packed, scales, chunk, tile = check_inputs
    monkeypatch.setattr(klab3, "_INTERPRET", True)
    sbits = jax.lax.bitcast_convert_type(jnp.asarray(scales), jnp.int16)
    y = klab3._call_kernel(name, jnp.asarray(xf), jnp.asarray(packed), sbits, chunk, 2 * tile,
                           chunk, tile)
    _close(_port_product(name, xf, packed, scales), y)


def test_kernel_lab3_call_i8blockdot(klab3, check_inputs, monkeypatch):
    """The serving i8blockdot fed the lab's operands against _k_i8blockdot,
    and the same as it fed the serving Q80Acts (a zero block gives xq = 0
    under both quantizations)."""
    xf, packed, scales, chunk, tile = check_inputs
    monkeypatch.setattr(klab3, "_INTERPRET", True)
    sbits = jax.lax.bitcast_convert_type(jnp.asarray(scales), jnp.int16)
    y = klab3._call_i8blockdot(jnp.asarray(xf), jnp.asarray(packed), sbits, chunk, 2 * tile,
                               chunk, tile)
    got = _port_product("full_i8blockdot", xf, packed, scales)
    _close(got, y)
    x = torch.from_numpy(xf)
    serving = q.q40_i8blockdot_plain(q.make_q80_acts(x), PackedQ40(_t(packed), _t(scales)))
    assert torch.equal(got, serving)


def test_quantize_x_blocks_matches_jax(klab3, check_inputs):
    xf = check_inputs[0]
    xq_lo_t, xq_hi_t, aux = klab3._quantize_x_blocks(xf, xf.shape[1])
    xq, sx = lab.quantize_x_blocks(torch.from_numpy(xf))
    m, d_in = xf.shape
    lo = torch.from_numpy(np.asarray(xq_lo_t).T.copy())
    hi = torch.from_numpy(np.asarray(xq_hi_t).T.copy())
    assert torch.equal(_join(lo.float(), hi.float()).to(torch.int8), xq)
    np.testing.assert_array_equal(np.asarray(aux)[1::2], sx.numpy().T)
    assert float(sx[2, 1]) == np.float32(1e-8)  # the zero block
    _close(q.make_q80_acts(torch.from_numpy(xf)).bsum.numpy().T, np.asarray(aux)[0::2])


@pytest.mark.parametrize("name", list(kernel_lab3.VARIANTS))
def test_kernel_lab3_main_closures(klab3_main, name):
    fn = klab3_main[name]
    env = _env(fn)
    if name == "full_i8blockdot":
        xf = _join(*(np.asarray(a) for a in (_env(klab3_main["full_v4"])["xa"],
                                              _env(klab3_main["full_v4"])["xb_"])))
    else:
        xa, xb = np.asarray(env["xa"]), np.asarray(env["xb_"])
        if xa.shape[0] != kernel_lab3.M:  # the blockdot operands are transposed
            xa, xb = xa.T, xb.T
        xf = _join(xa, xb)
    got = _port_product(name, xf.numpy(), np.asarray(env["packed"])[0],
                        np.asarray(env["sbits"])[0].view(np.float16))
    _close(got, _run(fn))


def test_kernel_lab3_variants_run_the_serving_plain_versions(check_inputs):
    """Rows 6-7: each lab variant is its serving mode's plain version."""
    xf, packed, scales, _, _ = check_inputs
    x = torch.from_numpy(xf)
    w = PackedQ40(_t(packed), _t(scales))
    acts = q.make_q80_acts(x)
    for name, (kernel, mode, _) in kernel_lab3.VARIANTS.items():
        got = _port_product(name, xf, packed, scales)
        if kernel == "q40_slab":
            ref = q.q40_slab_plain(x, w, torch.bfloat16, mode)
        elif kernel == "q40_blockdot":
            ref = q.q40_blockdot_plain(x, w)
        else:
            ref = q.q40_i8blockdot_plain(acts, w)
        assert torch.equal(got, ref), name
    assert set(kernel_lab3.ADOPT_MODES.values()) == set(q.DEQUANT_MODES)


def test_ref_dequant_matches_jax(klab3, check_inputs):
    _, packed, scales, _, _ = check_inputs
    np.testing.assert_array_equal(lab.ref_dequant(packed, scales),
                                  klab3._ref_dequant(packed, scales))


def test_split_x_matches_jax(klab3, check_inputs):
    xf = check_inputs[0]
    want = klab3._split_x(xf, xf.shape[1])
    got = lab.split_x(torch.from_numpy(xf))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_kernel_lab3_check_matches_jax_check(klab3, capsys):
    """The port's --check on the CPU runs the JAX check's own inputs: the
    same errors against the oracle, within the f32 summation order."""
    klab3.check()
    jax_rel = {ln.split()[0]: float(ln.split()[2]) for ln in capsys.readouterr().out.splitlines()
               if "max-rel-err" in ln}
    rows = kernel_lab3.check("cpu", out=lambda s: None)
    for r in rows:
        assert r["ok"] and abs(r["rel_err_vs_oracle"] - jax_rel[r["name"]]) <= 1e-3, r


# ---------------------------------------------------------------------------
# --adopt, the CLIs
# ---------------------------------------------------------------------------


def test_record_win_upserts(tmp_path):
    path = str(tmp_path / "table.json")
    dequant_select.record_win(4096, 14336, "decode", "blockdot", source="a", path=path)
    dequant_select.record_win(4096, 14336, "decode", "v4", source="b", path=path)
    dequant_select.record_win(2048, 512, "prefill", "bf16chain", source="c", path=path)
    rules = json.load(open(path))["rules"]
    assert [(r["d_in"], r["d_out"], r["m_class"], r["mode"], r["source"]) for r in rules] == [
        (4096, 14336, "decode", "v4", "b"), (2048, 512, "prefill", "bf16chain", "c")]
    assert dequant_select.DequantTable(path).resolve(4096, 14336, "decode") == "v4"
    with pytest.raises(ValueError):
        dequant_select.record_win(1, 2, "decode", "nope", source="x", path=path)


def test_adopt_records_the_fastest_verified_mode(tmp_path):
    path = str(tmp_path / "dequant_table.json")
    with open(dequant_select._DEFAULT_TABLE) as f:
        shipped = f.read()
    open(path, "w").write(shipped)
    times = {"full_v4": 3.0, "full_blockdot": 1.5, "full_i8blockdot": 2.0,
             "torch_int4_raw": 0.1}
    mode, got = kernel_lab3.adopt(times, 4096, 14336, "cpu", path=path, out=lambda s: None)
    assert (mode, got) == ("blockdot", path)
    table = dequant_select.DequantTable(path)
    assert table.resolve(4096, 14336, "decode") == "blockdot"
    assert table.resolve(2048, 2048, "decode") == "i8blockdot"  # the wildcard rows stay
    with open(dequant_select._DEFAULT_TABLE) as f:
        assert f.read() == shipped


@pytest.mark.parametrize("module,argv", [
    (kernel_lab, ["2", "256", "1024", "2"]),
    (kernel_lab3, ["256", "1024", "2", "1"]),
    (stage_probe, ["2048", "1024", "1", "1"]),
    (stage_probe2, ["2048", "2048", "1"]),
])
def test_lab_cli_on_cpu(module, argv, capsys):
    """Each lab CLI runs its plain versions with --device cpu, prints a row
    per variant with its working set, and launches no kernel."""
    lab.reset_counts()
    q.reset_counts()
    assert module.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("cpu:") and "FAILED" not in out
    rows = [ln for ln in out.splitlines() if "working set" in ln]
    assert len(rows) >= 8
    assert sum(lab.LAUNCHES.values()) + sum(q.LAUNCHES.values()) == 0
    assert sum(lab.PLAIN_CALLS.values()) + sum(q.PLAIN_CALLS.values()) > 0


@pytest.mark.parametrize("name", ["kernel_lab", "kernel_lab3", "stage_probe", "stage_probe2"])
def test_lab_cli_refuses_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", f"distributed_llama_multiusers_tpu_torch.lab.{name}",
                        "256", "512", "1", "--device", "cuda"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA device requested" in r.stderr and "working set" not in r.stdout
