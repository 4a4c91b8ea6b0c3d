"""bench_torch.py, the port's counterpart of bench.py, on the CPU.

Its section functions driven on a tiny CPU engine at reduced depth (their
keys together cover bench.py's result line, BENCH_r05.json's "parsed"); its
traffic constants against bench.py's (module constants by import, the ones
bench.py keeps inside its functions by reading its source); its imports (no
jax, nothing of the JAX package); and main() without a card: a non-zero exit
and no measured value."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import bench  # noqa: E402  (numpy only at module level)
import bench_torch  # noqa: E402
from helpers import build_tiny_tokenizer  # noqa: E402

from auralis_tpu_torch import TTS  # noqa: E402
from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer  # noqa: E402
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config  # noqa: E402
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine  # noqa: E402

PARSED = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
# the sections at reduced depth: 1 request x 2 chunks, 2 TTFA streams, 2
# short reps, 2 server requests, 2 sustained waves of 2
SECTIONS = {
    "rtf": lambda tts, sp: bench_torch.run_rtf(tts, sp, n_requests=1, chunks=2, reps=1),
    "ttfa": lambda tts, sp: bench_torch.run_ttfa(tts, sp, streams=2),
    "short_phrase": lambda tts, sp: bench_torch.run_short_phrase(tts, sp, reps=2),
    "server": lambda tts, sp: bench_torch.run_server_load(tts, n_requests=2),
    "sustained": lambda tts, sp: bench_torch.run_sustained(tts, sp, waves=2, concurrency=2),
}
SECTION_KEYS = {
    "rtf": {"metric", "value", "unit", "vs_baseline", "runs"},
    "ttfa": {"ttfa_p50_ms", "ttfa_p95_ms", "ttfa_ms"},
    "short_phrase": {"short_phrase_p50_ms", "short_phrase_p95_ms", "short_phrase_audio_s",
                     "short_phrase_uncapped_ms"},
    "server": {k for k in PARSED if k.startswith("server_")},
    "sustained": {"sustained"},
}
ATTEMPTED = {"rtf": 1, "ttfa": 1 + 2 + 2, "short_phrase": 1 + 2 + 1, "server": 2 + 2 + 2,
             "sustained": 2 * 2 + 2}


def tiny_engine() -> XTTSv2Engine:
    return XTTSv2Engine.random_init(
        tiny_test_config(), tokenizer=TTSTokenizer(build_tiny_tokenizer().tokenizer),
        dtype=torch.float32, device="cpu", vocoder_dtype=torch.float32,
        max_concurrency=bench_torch.CONCURRENCY)


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """Every section once, in main()'s order, on one warmed tiny engine."""
    tts = TTS(scheduler_max_concurrency=bench_torch.CONCURRENCY).with_engine(tiny_engine())
    speaker = bench_torch.write_speaker(str(tmp_path_factory.mktemp("bench") / "speaker.wav"))
    results = {"warmup": bench_torch.run_cold_and_warm(tts, speaker, warm_requests=1, chunks=2)}
    for name, run in SECTIONS.items():
        results[name] = run(tts, speaker)
    yield tts, speaker, results
    tts.loop.run_until_complete(tts.shutdown())


@pytest.mark.parametrize("name", list(SECTIONS))
def test_section_returns_its_keys(bench_run, name):
    sec = bench_run[2][name]
    assert SECTION_KEYS[name] <= set(sec.metrics), sorted(sec.metrics)
    assert (sec.attempted, sec.failed) == (ATTEMPTED[name], 0)
    # nothing is captured on the CPU
    assert (sec.captures_in_timed, sec.captured_keys) == (0, [])
    if name != "sustained":
        # the warmup's finished slots keep their lengths
        assert sec.idle_rows > 0
    numbers = [v for k, v in sec.metrics.items() if k in PARSED and k not in ("metric", "unit")]
    assert all(isinstance(v, (int, float, list)) for v in numbers), sec.metrics


def test_sections_cover_the_result_line(bench_run):
    got = set().union(*(s.metrics for s in bench_run[2].values()))
    assert set(PARSED) - {"skipped_sections"} <= got
    assert set(PARSED) == set(bench_torch.RESULT_KEYS)


def test_cold_and_warm_costs(bench_run):
    warm = bench_run[2]["warmup"]
    assert (warm.attempted, warm.failed) == (2, 0)
    m = warm.metrics
    assert m["cold_first_request_s"] > 0 and m["cold_first_request_audio_s"] > 0
    assert m["cold_first_request_capture_s"] == 0
    for part in ("precompile_decode", "warmup_batch", "precompile_vocoder"):
        assert m[f"{part}_s"] >= 0 and m[f"{part}_captures"] == 0


def test_idle_rows_are_the_finished_slots_lengths(bench_run):
    """After every section no slot decodes, and each finished slot still
    holds its length: the runner's idle rows are the sum of the lengths."""
    de = bench_run[0].tts_engine.decode_engine
    assert de.num_active == 0
    assert de.idle_rows() == int(de.state.seq_lens.sum()) > 0


def test_sustained_readings(bench_run):
    s = bench_run[2]["sustained"].metrics["sustained"]
    assert [w["wave"] for w in s["waves"]] == [0, 1]
    assert s["steady"] and s["captures_after_first"] == 0
    assert all(w["rss_mib"] > 0 and w["audio_s"] > 0 for w in s["waves"])


def test_failed_request_is_counted(bench_run, monkeypatch):
    """A request that raises is counted in `failed`; the section still
    reports the requests that succeeded."""
    tts, speaker, _ = bench_run
    real = tts.generate_speech_async
    calls = []

    async def flaky(request):
        calls.append(request)
        if len(calls) == 2:
            raise RuntimeError("injected failure")
        return await real(request)

    monkeypatch.setattr(tts, "generate_speech_async", flaky)
    sec = bench_torch.run_short_phrase(tts, speaker, reps=2)
    assert (sec.attempted, sec.failed) == (4, 1)
    assert sec.metrics["short_phrase_p50_ms"] is not None


# ------------------------------------------------ bench.py's traffic
def _bench_source_values() -> dict:
    """The traffic bench.py keeps inside its functions: the short phrase, the
    server texts and the RTF requests' sampling options."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}

    def assigned(func: str, name: str):
        for node in ast.walk(funcs[func]):
            if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == name):
                return ast.literal_eval(node.value)
        raise KeyError(name)

    sampling = next(
        {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords
         if kw.arg in ("temperature", "top_p", "top_k", "repetition_penalty")}
        for node in ast.walk(funcs["run_rtf_section"])
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "TTSRequest")
    return {"phrase": assigned("run_short_phrase", "phrase"),
            "texts": assigned("run_server_load", "texts"), "sampling": sampling}


@pytest.mark.parametrize("name", ["BASELINE_RTF", "CONCURRENCY", "CHUNKS_PER_REQUEST",
                                  "N_REQUESTS", "SENTENCE", "SERVER_CONCURRENCY",
                                  "SERVER_REQUESTS", "BUDGET_S"])
def test_module_constants_equal_bench(name):
    assert getattr(bench_torch, name) == getattr(bench, name)


def test_traffic_in_functions_equals_bench():
    src = _bench_source_values()
    assert bench_torch.SHORT_PHRASE == src["phrase"]
    assert bench_torch.SERVER_TEXTS == src["texts"]
    assert bench_torch.SAMPLING == src["sampling"]


def test_bench_imports_only_numpy_at_module_level():
    tree = ast.parse((ROOT / "bench.py").read_text())
    top = {alias.name for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))
           for alias in node.names} | {node.module for node in tree.body
                                       if isinstance(node, ast.ImportFrom)}
    assert top - {"__future__", "annotations", "asyncio", "json", "os", "sys", "time"} == {
        "numpy"}


# ------------------------------------------------ isolation and no-card exit
def test_imports_no_jax():
    code = ("import sys, bench_torch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax' or "
            "m.startswith('jaxlib') or m == 'auralis_tpu' or m.startswith('auralis_tpu.'))\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_main_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(["--config", "int8"]) != 0
    out, err = capsys.readouterr()
    assert "no CUDA device" in err
    for line in out.splitlines():
        if line.startswith("{"):
            assert not isinstance(json.loads(line).get("value"), (int, float))


def test_configs_name_their_kernels():
    """default sets no flag and runs K2 (the card's serving default on a
    bf16 cache) and K3 (bench.py's flagless engine);
    bf16 runs K1/K2 (flash_decode), int8 K1/K4 (ragged_decode, int8 KV),
    each with every engine flag pinned: int8 prefill and the W8A8 policy off
    on bf16, forced W8A8 on int8, slot bucketing off on both."""
    bf16, int8 = bench_torch.CONFIGS["bf16"], bench_torch.CONFIGS["int8"]
    assert bench_torch.CONFIGS["default"] == ({}, {})
    assert bench_torch.CONFIG_KERNELS["default"] == ("flash_decode_append", "mrf_stage")
    assert bf16 == ({"prefill_flash": True, "flash_decode": True},
                    {"kv_int8": False, "decode_w8a8": False, "prefill_w8a8": False,
                     "slot_bucketing": False})
    assert bench_torch.CONFIG_KERNELS["bf16"] == ("prefill_attention", "flash_decode_append",
                                                  "mrf_stage")
    assert int8[0] == {"prefill_flash": True, "ragged_decode": True}
    assert int8[1] == {"kv_int8": True, "decode_w8a8": True, "prefill_w8a8": True,
                       "slot_bucketing": False}
    assert bench_torch.CONFIG_KERNELS["int8"] == ("prefill_attention", "ragged_decode",
                                                  "mrf_stage")


def test_settings_follow_bench_environment(monkeypatch):
    monkeypatch.delenv("BENCH_SLOT_BUCKETING", raising=False)
    assert bench_torch.engine_settings() == {"decode_slots": 64, "steps_per_sync": 64,
                                             "slot_bucketing": None}
    monkeypatch.setenv("BENCH_DECODE_SLOTS", "16")
    monkeypatch.setenv("BENCH_SLOT_BUCKETING", "1")
    assert bench_torch.engine_settings()["decode_slots"] == 16
    assert bench_torch.engine_settings()["slot_bucketing"] is True
