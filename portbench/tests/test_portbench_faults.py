"""The check sees the faults a serving cell can have: each test drives a
whole run of a fixture cell on the CPU (the harness's look for a GPU
skipped) with the timed path broken underneath, and `correct` comes out
false:
- a token altered where it is produced (the sampler's choice moved by one);
- a decode step that leaves its state unchanged (the KV cache the step
  appends to is a copy, so later steps attend over rows never written);
- an answer altered where it is produced (the vocoder's PCM scaled).
A training cell's faults (half of a batch left out of a mean) and the
exchange between chips (every cell runs on one) do not arise here."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import run

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


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _answer_altered])
@pytest.mark.parametrize("cell", ["tiny-ebook", "tiny-chat"])
def test_a_broken_path_is_not_correct(bench_root, monkeypatch, fault, cell):
    fault(monkeypatch)
    res = run.run_cell(bench_root, cell, SEED, 6.0, False, "cpu")
    assert res["correct"] is False, res["check"]
