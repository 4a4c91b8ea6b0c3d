"""The plain reference against auralis_tpu_torch at the fixture's tiny size
on the CPU, on seeded weights: with the engine in f32 (GPT, KV cache and
vocoder) the served greedy tokens are the reference's first choices and
the served audio is the reference's waveform to 16-bit rounding; and the
control, the reference through fp8, fails the limits. Only this file and
the harness import the port; the reference imports nothing of it."""
from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import FIXTURE, REPO
from portbench import check, generator, run, tokenizer, weights

SEED = 2**31 + 5


def _serve(config, mix, tmp_path, f32: bool):
    """Four requests of the mix (two streamed, all greedy) on the tiny
    engine; (records, voice paths, tokenizer json)."""
    tok = tokenizer.train(REPO)
    params, core = weights.make_weights(config, SEED, "cpu")
    kw = {}
    if f32:
        params = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.float()) for k, v in params.items()}
        kw = {"cache_dtype": torch.float32, "vocoder_dtype": None}
    engine, tts = run.build_engine(config, mix, params, core, tok, SEED, "cpu", **kw)
    run.record_chunks(engine.decode_engine)
    paths = []
    for i in range(mix["voices"]):
        paths.append(os.path.join(tmp_path, f"v{i}.wav"))
        run.write_wav_f32(paths[-1], generator.voice(mix, SEED, i), 22050)
    load = run.Load(tts, mix, paths)
    reqs = generator.requests(REPO, mix, SEED, 30)[:4]
    for i, r in enumerate(reqs):
        r.greedy, r.stream = True, i % 2 == 0
    tts.loop.run_until_complete(asyncio.gather(*(load.one(r) for r in reqs)))
    tts.loop.run_until_complete(tts.shutdown())
    run.chunk_lists(load.records)
    return load.records, paths, tok


@pytest.fixture(scope="module")
def tiny():
    config = json.loads((FIXTURE / "configs/tiny-flash.json").read_text())
    mix = json.loads((FIXTURE / "traffic/tiny-chat.json").read_text())
    return config, mix


def test_reference_is_the_port_in_f32(tiny, tmp_path):
    config, mix = tiny
    records, paths, tok = _serve(config, mix, tmp_path, f32=True)
    assert all(not r["failed"] and r["audio"].size for r in records)
    got = check.judge(REPO, config, mix, SEED, records, tok, paths, "cpu")
    assert got["ids"] == 0 and got["length"] == 0 and got["tokens"] > 40
    # greedy tokens are the reference's first choice up to f32 rounding
    assert got["logit_gap"] <= 1e-4
    # the waveform to the 16-bit rounding of the served PCM
    assert got["wave_err"] <= 2e-4


def test_control_fails_and_the_bf16_port_passes(tiny, tmp_path):
    """At the tiny size the served bf16 engine passes the fixture's limits
    and the control (the reference through fp8 products) fails one."""
    config, mix = tiny
    records, paths, tok = _serve(config, mix, tmp_path, f32=False)
    limits = json.loads((FIXTURE / "limits/tiny-chat.json").read_text())
    got = check.judge(REPO, config, mix, SEED, records, tok, paths, "cpu", control=True)
    ok, _ = check.verdict(got, limits, 0)
    assert ok, got
    assert (got["control_logit_gap"] > limits["logit_gap"]
            or got["control_wave_err"] > limits["wave_err"]), got


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.model, portbench.reference.audio, "
            "portbench.reference.frontend, portbench.check, portbench.weights\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'auralis_tpu', 'auralis_tpu_torch', 'jax', 'jaxlib', 'flax'}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
