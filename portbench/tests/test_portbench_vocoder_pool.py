"""The vocoder's captured programs under concurrent callers, on the card
(python -m pytest portbench/tests -m card).

The e-book and chat cells run up to three vocoder batches at once, in
worker threads, through `XTTSv2Engine._vocode_batch`. All vocoder programs
of an engine share one CUDA-graph memory pool, and a program captured
later keeps its output in blocks that a program captured earlier uses for
its temporaries (`vocoder_keys` captures the largest first). So a batch's
output is only safe until another program of the pool replays, whatever
lock its own program holds.

Here three threads call `_vocode_batch` on one engine at the flagless
configuration's widths: the largest row program (batch 4), the first
segment and the segment window (batch 1 each), 200 times each, every call
with other latents, lengths and d-vectors than the call before. Each
output must equal the eager run of its key's function on the same inputs,
as chip_smoke holds every vocoder program to 0 PCM steps from eager. It
fails while each vocoder program holds only a lock of its own from staging
to the host copy of its output (PERF.md, open question 1), and is marked
as a strict expected failure until the pool-wide lock lands: a run in
which every output is right then reads as a failure, and the marker goes.
"""
from __future__ import annotations

import json
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench import generator, run, tokenizer, weights

SEED = 2**31 + 207
CALLS = 200
INPUT_SETS = 8  # distinct inputs per key, taken in turn


def _inputs(engine, kind: str, b: int, bucket, rng: np.random.Generator, device) -> tuple:
    """(rows, ns, d-vectors, arg) of one batch: latent rows [T_audio, D]
    f32 on the card, lengths, host d-vectors and the kind's argument (a
    row program's bucket, a segment's window starts)."""
    t_max = engine.gpt_config.max_audio_tokens
    d = engine.gpt_config.hidden_size
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    rows = [torch.randn((t_max, d), generator=gen, device=device) for _ in range(b)]
    if kind == "seg_first":
        ns = [int(n) for n in rng.integers(16, 64, size=b)]
    else:
        ns = [int(n) for n in rng.integers(t_max // 2, t_max + 1, size=b)]
    gs = [rng.standard_normal((1, engine.hifi_config.d_vector_dim)).astype(np.float32) * 0.1
          for _ in range(b)]
    if kind == "row":
        arg = bucket
    elif kind == "seg":
        arg = [engine._seg_slice_start(int(rng.integers(0, 200))) for _ in range(b)]
    else:
        arg = None
    return rows, ns, gs, arg


def _eager(engine, kind: str, rows, ns, gs, arg) -> np.ndarray:
    """The key's function run eagerly on the rows as its program stages
    them (cut to the program's width)."""
    prog = engine._vocoder_program(kind, len(rows), arg if kind == "row" else None)
    width = prog.inputs["rows"].shape[1]
    stacked = torch.stack([r[:width] for r in rows])
    if kind == "row":
        pcm = engine._rows_pcm(stacked, engine._lanes(ns), engine._speaker_rows(gs), arg)
    elif kind == "seg":
        pcm = engine._vocode_seg(stacked, ns, arg, gs)
    else:
        pcm = engine._vocode_seg_first(stacked, ns, gs)
    return pcm.cpu().numpy()


@pytest.mark.card
@pytest.mark.xfail(strict=True, raises=AssertionError,
                   reason="PERF.md 7.1: the vocoder programs share one graph pool")
def test_three_threads_on_one_vocoder_pool_get_their_own_outputs(card):
    config = json.loads((REPO / "portbench/configs/xttsv2-flagless.json").read_text())
    mix = generator.load_mix(REPO, "ebook")
    tok = tokenizer.train(REPO)
    params, core = weights.make_weights(config, SEED, card)
    engine, _ = run.build_engine(config, mix, params, core, tok, SEED, card, decode_slots=8)
    del params, core
    engine.precompile_vocoder_buckets()
    t_max = engine.gpt_config.max_audio_tokens
    lanes = {"row": (4, engine.row_bucket(t_max)), "seg": (1, None), "seg_first": (1, None)}
    rng = np.random.default_rng(SEED)
    cases = {}
    with torch.no_grad():
        for kind, (b, bucket) in lanes.items():
            sets = []
            for _ in range(INPUT_SETS):
                rows, ns, gs, arg = _inputs(engine, kind, b, bucket, rng, card)
                sets.append((rows, ns, gs, arg, _eager(engine, kind, rows, ns, gs, arg)))
            cases[kind] = sets
    torch.cuda.synchronize(card)

    wrong = {kind: 0 for kind in cases}
    errors = []

    def caller(kind):
        try:
            with torch.no_grad():
                for i in range(CALLS):
                    rows, ns, gs, arg, want = cases[kind][i % INPUT_SETS]
                    got = engine._vocode_batch(kind, rows, ns, gs, arg)
                    wrong[kind] += int(not np.array_equal(got, want))
        except Exception as e:  # reported by the test below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(kind,)) for kind in cases]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    print(f"[vocoder pool] wrong outputs of {CALLS} calls each: {wrong}")
    assert wrong == {kind: 0 for kind in cases}, wrong
