"""The check sees the faults a serving cell can have: each test drives a
whole run of a fixture cell on the CPU (the harness's look for a GPU
skipped) with the timed path broken underneath, and `correct` comes out
false:
- a token altered where it is produced (the sampler's choice moved by one);
- a decode step that leaves its state unchanged (the KV cache the step
  appends to is a copy, so later steps attend over rows never written);
- an answer altered where it is produced (the vocoder's PCM scaled);
- one vocoded chunk in 20 carrying another chunk's waveform (what a
  graph output overwritten by another program's replay serves), judged
  at the sample size of the loaded mix the fixture cell stands in for;
  and the sample of that size, drawn from the seed, holds such a chunk
  in 95% of runs or more.
A training cell's faults (half of a batch left out of a mean) and the
exchange between chips (every cell runs on one) do not arise here."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench import check, generator, run

SEED = 2**31 + 9


def _token_altered(monkeypatch):
    from auralis_tpu_torch.runtime import decode_loop

    inner = decode_loop.sample_tokens

    def sample(*args, **kwargs):
        return (inner(*args, **kwargs) + 1) % 64

    monkeypatch.setattr(decode_loop, "sample_tokens", sample)


def _state_unchanged(monkeypatch):
    from auralis_tpu_torch.runtime import decode_loop

    inner = decode_loop.gpt_decode_step

    def step(params, cfg, tokens, audio_pos, seq_lens, cache, *args, **kwargs):
        copy = dataclasses.replace(cache, **{f: t.clone() for f, t in vars(cache).items()
                                             if torch.is_tensor(t)})
        return inner(params, cfg, tokens, audio_pos, seq_lens, copy, *args, **kwargs)

    monkeypatch.setattr(decode_loop, "gpt_decode_step", step)


def _answer_altered(monkeypatch):
    from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine

    monkeypatch.setattr(XTTSv2Engine, "_pcm",
                        staticmethod(lambda wav: torch.round(wav * 0.9 * 32767.0).to(torch.int16)))


def _waveform_swapped(monkeypatch):
    """One lane in 20 that the vocoder serves, the 10th, 30th, ... (or the
    next one that can), gets the PCM of an earlier lane of the same program
    shape: the first falls among the load's lanes, after the warm-up's."""
    from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine

    inner = XTTSv2Engine._vocode_batch
    seen = {"lanes": 0, "due": False, "last": {}}

    def vocode(self, kind, rows, *args, **kwargs):
        pcm = inner(self, kind, rows, *args, **kwargs)
        for lane in pcm:
            seen["lanes"] += 1
            seen["due"] |= seen["lanes"] % 20 == 10
            own, other = lane.copy(), seen["last"].get((kind, lane.shape[0]))
            if seen["due"] and other is not None and not np.array_equal(other, own):
                lane[:] = other
                seen["due"] = False
            seen["last"][(kind, lane.shape[0])] = own
        return pcm

    monkeypatch.setattr(XTTSv2Engine, "_vocode_batch", vocode)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _answer_altered])
@pytest.mark.parametrize("cell", ["tiny-ebook", "tiny-chat"])
def test_a_broken_path_is_not_correct(bench_root, monkeypatch, fault, cell):
    fault(monkeypatch)
    res = run.run_cell(bench_root, cell, SEED, 6.0, False, "cpu")
    assert res["correct"] is False, res["check"]


# the loaded mixes the fixture cells stand in for
LOADED = {"tiny-ebook": "ebook", "tiny-chat": "chat"}


@pytest.mark.parametrize("cell", ["tiny-ebook", "tiny-chat"])
def test_one_chunk_in_twenty_with_another_waveform_is_not_correct(bench_root, monkeypatch,
                                                                   cell):
    path = bench_root / "portbench" / "traffic" / f"{cell}.json"
    mix = json.loads(path.read_text())
    mix["check"] = generator.load_mix(REPO, LOADED[cell])["check"]
    path.write_text(json.dumps(mix))
    _waveform_swapped(monkeypatch)
    res = run.run_cell(bench_root, cell, SEED, 6.0, False, "cpu")
    assert res["correct"] is False, res["check"]
    got = res["check"]
    assert got["wave_err"]["value"] > got["wave_err"]["limit"], got
    assert got["ids"]["value"] == got["length"]["value"] == got["failed"]["value"] == 0, got


@pytest.mark.parametrize("name,finished", [("ebook", 330), ("chat", 450)])
def test_the_sample_holds_one_chunk_in_twenty(name, finished):
    """Of `finished` requests of the mix (about as many as a run of the cell
    ends on the H100), each chunk wrong with probability 1/20: over 400
    seeds the sample that `check.choose` draws holds a wrong chunk in 95%
    of them or more, so a fault at that rate fails at least 4 of 5 runs."""
    mix = generator.load_mix(REPO, name)
    reqs = generator.requests(REPO, mix, SEED, 120)[:finished]
    hits = 0
    for k in range(400):
        seed = 2**31 + 1000 + k
        rng = np.random.default_rng([seed, 7])
        records = [{"done": 1.0, "failed": False, "greedy": r.greedy,
                    "chunks": [{"n": r.cap, "wrong": rng.random() < 1 / 20} for _ in r.chunks]}
                   for r in reqs]
        chosen = check.choose(records, mix, seed)
        hits += any(c["wrong"] for r in chosen for c in r["chunks"])
    assert hits >= 0.95 * 400, hits
