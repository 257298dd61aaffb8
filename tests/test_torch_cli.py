"""The port's ``dllama`` CLI (``app/dllama.py``) and its single-stream
speculation (``runtime/spec.py``'s ``SpecStream``) on the CPU, against the
JAX package's.

Both CLIs load the same synthetic tiny model (seq_len 256) and tokenizer
from disk and run in this process (the JAX one on the CPU platform, its
dense f32 weights; the port with ``--device cpu``, dense f32 as well):
the text each prints, greedy and seeded, with and without speculation, and
over two chat turns read from stdin, must be equal, as must the number of
``Pred`` lines under ``--benchmark``. For the two-turn chat the tokenizer
lists every reserved token as an end-of-turn token as well, so that the
random model's first reply ends and the second turn runs at the carried
position. ``SpecStream`` runs on the JAX engine and on the port's (the
JAX weights through ``params_from_jax_numpy``): the tokens, which of them
took a forward, and the acceptance counters must be equal, including
``discard_pending``'s retraction. Tolerance: none (text, tokens and
counters compared for equality).
"""

import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.app import dllama as j_dllama
from distributed_llama_multiusers_tpu.app.args import build_parser as j_build_parser
from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.formats.synthetic import (
    tiny_header,
    write_synthetic_model,
    write_synthetic_tokenizer,
)
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.runtime import InferenceEngine as JaxEngine
from distributed_llama_multiusers_tpu.runtime.spec import SpecStream as JaxSpecStream
from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_multiusers_tpu_torch.app import dllama
from distributed_llama_multiusers_tpu_torch.app.args import build_parser
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.formats.tokenizer_file import (
    load_tokenizer_file,
    write_tokenizer_file,
)
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m
from distributed_llama_multiusers_tpu_torch.models.loader import params_from_jax_numpy
from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine
from distributed_llama_multiusers_tpu_torch.runtime.spec import SpecStream


@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    """A tiny Q40 model with a 256-token context, its tokenizer, and the
    same tokenizer with every reserved token also ending a turn."""
    d = tmp_path_factory.mktemp("cli_model")
    header = tiny_header(seq_len=256)
    model = str(d / "model.m")
    tok = str(d / "tokenizer.t")
    write_synthetic_model(model, header, seed=0)
    write_synthetic_tokenizer(tok, vocab_size=header.vocab_size)
    data = load_tokenizer_file(tok)
    reserved = [i for i, t in enumerate(data.vocab) if t.startswith(b"<|reserved_")]
    data.eos_token_ids = list(data.eos_token_ids) + reserved
    chat_tok = str(d / "chat.t")
    with open(chat_tok, "wb") as f:
        write_tokenizer_file(f, data)
    return {"model": model, "tokenizer": tok, "chat_tokenizer": chat_tok}


def jax_main(argv):
    """The JAX dllama's ``main`` past its platform setup (this process
    already runs JAX on the CPU, tests/conftest.py)."""
    args = j_build_parser("dllama").parse_args(argv)
    {"inference": j_dllama.run_inference, "chat": j_dllama.run_chat}[args.mode](args)


def _run(main_fn, argv, capsys, stdin: str | None = None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    capsys.readouterr()
    main_fn(argv)
    return capsys.readouterr().out


def _generated(out: str) -> tuple[str, int]:
    """(the generated text, the number of Pred lines) of an inference run:
    what follows the Eval line up to the summary, Pred lines taken out."""
    body = out.split("🔷 Eval", 1)[1].split("\n", 1)[1]
    body = body.split("\n⏱ Evaluation", 1)[0]
    preds = re.findall(r"🔶 Pred [^\n]*\n", body)
    return re.sub(r"🔶 Pred [^\n]*\n", "", body), len(preds)


INFERENCE_CASES = {
    "greedy": ["--temperature", "0"],
    "greedy-no-spec": ["--temperature", "0", "--no-spec"],
    "seeded": ["--temperature", "0.8", "--seed", "7"],
    "seeded-topp": ["--temperature", "1.2", "--topp", "0.5", "--seed", "0"],
}


@pytest.mark.parametrize("case", sorted(INFERENCE_CASES))
def test_run_inference_equals_jax(cli_model, capsys, case):
    """The same prompt and flags: the printed text and the Pred lines equal
    the JAX dllama's. A sampled run takes a forward, and prints a Pred line,
    for every token; a greedy one fewer where speculation or a horizon ran
    ahead."""
    common = ["inference", "--model", cli_model["model"], "--tokenizer",
              cli_model["tokenizer"], "--prompt", "hello world hello world hello",
              "--steps", "40", "--benchmark", *INFERENCE_CASES[case]]
    got = _run(dllama.main, common + ["--device", "cpu"], capsys)
    want = _run(jax_main, common, capsys)
    text, preds = _generated(got)
    assert (text, preds) == _generated(want)
    assert text.strip()
    if case.startswith("seeded"):
        assert preds == 40
    else:
        assert preds < 40
    summary = re.search(r"Prediction: [0-9.]+ ms \(([0-9.]+) tok/s\)", got)
    assert summary is not None and float(summary.group(1)) > 0
    if case == "greedy":
        assert re.search(r"Speculation: \d+ verify steps", got)


def test_run_inference_on_a_tp2_mesh_equals_one_rank(cli_model, capsys):
    """``--workers 2`` on two CPU ranks: the same greedy text as one rank;
    every Pred line carries the Sync readout (the hop bytes of a decode
    step), and the Measured/step line is printed (wall only: the profiler
    records no device time on the CPU)."""
    common = ["inference", "--model", cli_model["model"], "--tokenizer",
              cli_model["tokenizer"], "--prompt", "hello world", "--steps", "16",
              "--benchmark", "--temperature", "0", "--no-spec", "--multi-step", "0",
              "--device", "cpu"]
    one = _run(dllama.main, common, capsys)
    two = _run(dllama.main, common + ["--workers", "2"], capsys)
    assert _generated(two)[0] == _generated(one)[0]
    preds = re.findall(r"🔶 Pred [^\n]*", two)
    assert len(preds) == 16
    assert all(re.search(r"Sync +[0-9.]+ kB/chip \(\d+ collectives\)", p) for p in preds)
    assert float(re.search(r"Sync +([0-9.]+) kB", preds[-1]).group(1)) > 0
    assert "Measured/step:" in two and "Sync" not in _generated(one)[0]


@pytest.mark.parametrize("flags", [["--temperature", "0"],
                                   ["--temperature", "0.9", "--seed", "5"]])
def test_run_chat_two_turns_equals_jax(cli_model, capsys, monkeypatch, flags):
    """Two turns piped on stdin: the second is prefilled at the position the
    first left, and the whole conversation prints as the JAX dllama's."""
    argv = ["chat", "--model", cli_model["model"], "--tokenizer",
            cli_model["chat_tokenizer"], "--chat-template", "llama3", *flags]
    turns = "hi there\nwhat else\n"
    got = _run(dllama.main, argv + ["--device", "cpu"], capsys, turns, monkeypatch)
    want = _run(jax_main, argv, capsys, turns, monkeypatch)
    conv = got.split("💬 Chat mode. Ctrl-D to exit.", 1)[1]
    assert conv == want.split("💬 Chat mode. Ctrl-D to exit.", 1)[1]
    assert conv.count("\n> ") == 3 and "Context window full" not in conv


def test_prompt_too_long_exits_2(cli_model, capsys):
    argv = ["inference", "--model", cli_model["model"], "--tokenizer", cli_model["tokenizer"],
            "--prompt", "x" * 300, "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        dllama.main(argv)
    assert e.value.code == 2
    assert "does not fit the context window" in capsys.readouterr().out


def test_worker_and_train_modes(capsys):
    """``worker``: the single-process guidance, exit 0 (the JAX dllama's
    answer without pod flags); ``train``: refused, naming ROADMAP A9."""
    dllama.main(["worker"])
    assert "no pod to join" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dllama.main(["train", "--model", "m", "--tokenizer", "t"])
    assert e.value.code == 2 and "ROADMAP A9" in capsys.readouterr().err


def test_cli_flags_parse_like_jax():
    """dllama's command line parses with both parsers to the same values;
    the server's parser has no mode and hides the sampling flags it
    ignores."""
    argv = ["inference", "--model", "m.m", "--tokenizer", "t.t", "--prompt", "p", "--steps",
            "9", "--temperature", "0.3", "--topp", "0.7", "--seed", "0", "--benchmark",
            "--no-spec", "--max-seq-len", "32", "--chat-template", "llama3"]
    got = build_parser("dllama").parse_args(argv)
    want = j_build_parser("dllama").parse_args(argv)
    for key in ("mode", "model", "tokenizer", "prompt", "steps", "temperature", "topp", "seed",
                "benchmark", "no_spec", "max_seq_len", "chat_template"):
        assert getattr(got, key) == getattr(want, key), key
    api = ["--model", "m", "--tokenizer", "t", "--journal-path", "j", "--recover-journal",
           "--reconnect-grace", "2.5"]
    got = build_parser("dllama-api", api=True).parse_args(api)
    want = j_build_parser("dllama-api", api=True).parse_args(api)
    for key in ("journal_path", "recover_journal", "reconnect_grace", "temperature", "seed"):
        assert getattr(got, key) == getattr(want, key), key
    help_text = build_parser("dllama-api").format_help()
    assert "--reconnect-grace" in help_text and "--temperature" not in help_text
    assert "--temperature" in build_parser("dllama").format_help()


# ---------------------------------------------------------------------------
# SpecStream against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stacks(tiny_model):
    path = tiny_model["model"]
    jconfig, jparams = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    config, _ = load_params_from_m(path, load_model_header(path), dtype=torch.float32,
                                   device="cpu")
    params = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return (jconfig, jparams), (config, params), JaxTokenizer(tiny_model["tokenizer"])


def _drive(stream_cls, engine, config, prompt, n, enabled=True, multi_h=0,
           discard_at=None):
    """Greedy tokens through a SpecStream: (tokens, forward flags, counters
    snapshots after the run and after ``discard_pending`` at step
    ``discard_at``)."""
    _, g0, pos = engine.prefill(0, prompt)
    engine.stats.reset()
    spec = stream_cls(engine, config, enabled=enabled, prompt_tokens=prompt, multi_h=multi_h)
    cur, out, flags, retract = int(g0), [int(g0)], [], None
    keys = ("spec_steps", "spec_lane_steps", "spec_emitted", "multi_dispatches")
    while len(out) < n and pos < config.seq_len - 1:
        nxt, used = spec.advance(cur, pos)
        flags.append(bool(used))
        pos += 1
        cur = nxt
        out.append(cur)
        if discard_at is not None and len(out) == discard_at:
            before = {k: engine.stats.snapshot()[k] for k in keys}
            pending = len(spec.pending)
            spec.discard_pending()
            retract = (before, pending, {k: engine.stats.snapshot()[k] for k in keys})
            break
    return out, flags, {k: engine.stats.snapshot()[k] for k in keys}, retract


@pytest.mark.parametrize("enabled,multi_h", [(True, 0), (False, 4), (True, 8)])
def test_spec_stream_equals_jax(stacks, enabled, multi_h):
    """Greedy tokens, which of them took a forward, and the counters (verify
    steps, drafted lane steps, tokens consumed, horizons) equal the JAX
    SpecStream's, on a draftable prompt and to seq_len's edge."""
    (jconfig, jparams), (config, params), tok = stacks
    prompt = tok.encode("aa bb aa bb aa bb aa bb")
    n = config.seq_len  # runs into the context's end: drafts clamp there
    got = _drive(SpecStream, InferenceEngine(config, params, n_lanes=1, device="cpu"),
                 config, prompt, n, enabled, multi_h)
    want = _drive(JaxSpecStream, JaxEngine(jconfig, jparams, n_lanes=1), jconfig, prompt, n,
                  enabled, multi_h)
    assert got[:3] == want[:3]
    assert not all(got[1]), "every token took a forward"
    if enabled:
        assert got[2]["spec_lane_steps"] > 0
    if multi_h:
        assert got[2]["multi_dispatches"] > 0


def test_discard_pending_retracts_like_jax(stacks):
    """A turn that ends with a verify step's lookahead partly used retracts
    that step from the counters, as the JAX SpecStream does."""
    (jconfig, jparams), (config, params), tok = stacks
    prompt = tok.encode("aa bb aa bb aa bb aa bb")
    engine = InferenceEngine(config, params, n_lanes=1, device="cpu")
    probe = _drive(SpecStream, engine, config, prompt, 32)
    # the first token consumed from a lookahead, with lookahead still pending
    at = next(i + 2 for i, f in enumerate(probe[1]) if not f)
    got = _drive(SpecStream, InferenceEngine(config, params, n_lanes=1, device="cpu"), config,
                 prompt, 32, discard_at=at)
    want = _drive(JaxSpecStream, JaxEngine(jconfig, jparams, n_lanes=1), jconfig, prompt, 32,
                  discard_at=at)
    assert got == want
    before, pending, after = got[3]
    assert pending > 0
    assert after["spec_lane_steps"] == before["spec_lane_steps"] - 1
    assert after["spec_emitted"] < before["spec_emitted"]
    assert after["spec_emitted"] >= after["spec_lane_steps"]
