"""The yardstick on the CPU: the bounds of flops.py against the kernel
table's, and the traffic generator's schedules, texts, caps and lengths."""
from __future__ import annotations

import copy
import json
import math

import numpy as np
import pytest

from conftest import REPO
from portbench import flops, generator, tokenizer
from portbench.reference import frontend

FLAGLESS = json.loads((REPO / "portbench/configs/xttsv2-flagless.json").read_text())
MIXES = ("ebook", "chat")


def _mix(name):
    return generator.load_mix(REPO, name)


def test_k2_bound_is_the_kernel_tables():
    """K2 over one layer of 8 slots at the ragged write positions 0..1046:
    0.00452 ms, bound by bytes (PERF.md's kernel table)."""
    cfg = copy.deepcopy(FLAGLESS)
    cfg["model_args"]["gpt_layers"] = 1
    rows = sum(p + 1 for p in (0, 7, 255, 256, 511, 600, 1000, 1046))
    ms, by = flops.bound(flops.decode_attention_bytes(cfg, rows, 8),
                         flops.decode_attention_ops(cfg, rows), "bf16")
    assert by == "bytes" and round(ms, 5) == 0.00452


def test_k3_bound_is_the_kernel_tables():
    """K3's four stages for a 600-token chunk (2612 frames): 1.570 ms, bound
    by operations; 0.349 / 0.698 / 0.349 / 0.174 ms a stage."""
    frames = flops.frames_of(FLAGLESS, 600)
    assert frames == 2612
    ms, by = flops.bound(flops.mrf_bytes(FLAGLESS, frames), flops.mrf_ops(FLAGLESS, frames),
                         "bf16")
    assert by == "operations" and round(ms, 3) == 1.570
    hg = FLAGLESS["architecture"]["hifigan"]
    t, stages = frames, []
    for i, rate in enumerate(hg["upsample_rates"]):
        t *= rate
        c = 512 // 2 ** (i + 1)
        stages.append(2 * c * c * t * 126 / flops.PEAK_OPS_PER_S["bf16"] * 1e3)
    assert [round(s, 3) for s in stages] == [0.349, 0.698, 0.349, 0.174]


def test_step_operations_count_the_published_shapes():
    """A decoded token at full width: 30 layers x (2 x (4 D^2 + 2 D I) + 4 D
    x context) + the mel head; the vocoder's MRF part is K3's."""
    d, i = 1024, 4096
    assert flops.gpt_decode_ops(FLAGLESS, 100) == 30 * (2 * (4 * d * d + 2 * d * i) + 400 * d) \
        + 2 * d * 1026
    assert flops.vocoder_ops(FLAGLESS, 10) > flops.mrf_ops(FLAGLESS, 10) > 0
    assert flops.chunk_gpt_ops(FLAGLESS, 100, 1) == flops.gpt_prefill_ops(FLAGLESS, 100)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_schedule(name):
    mix = _mix(name)
    a = generator.requests(REPO, mix, 2**31 + 11, 60)
    b = generator.requests(REPO, mix, 2**31 + 11, 60)
    c = generator.requests(REPO, mix, 2**31 + 12, 60)
    assert [vars(r) for r in a] == [vars(r) for r in b]
    assert [r.text for r in a] != [r.text for r in c]
    # another seed: the same sizes in another order (a chat cap follows the
    # length of the words drawn, so only the e-book's caps are the same set)
    assert sorted(r.cap for r in a) == sorted(r.cap for r in c) or name == "chat"
    assert sum(r.greedy for r in a) == sum(r.greedy for r in c)
    assert len(a) == len(c)
    if name == "chat":
        # every calm and burst stretch holds the same arrivals in another order
        def per_stretch(reqs):
            b = mix["burst"]
            edge = [(r.due // b["period_s"], r.due % b["period_s"] >= b["period_s"] - b["length_s"])
                    for r in reqs]
            return {k: edge.count(k) for k in set(edge)}

        assert per_stretch(a) == per_stretch(c)
        assert [r.due for r in a] != [r.due for r in c]

        # the seed only reorders the spacings drawn from `master_seed`,
        # stretch by stretch (from its start through its arrivals to its end)
        def spacings(reqs, start, end):
            dues = [r.due for r in reqs if start <= r.due < end]
            return sorted(np.diff([start, *dues, end]).round(9))

        stretches = generator._stretches(mix, 60)
        assert len(stretches) == 12
        for start, end, _ in stretches:
            assert spacings(a, start, end) == spacings(c, start, end)
    assert np.array_equal(generator.voice(mix, 5, 1), generator.voice(mix, 5, 1))


@pytest.mark.parametrize("name", MIXES)
def test_texts_tokenize_as_the_port_splits_them(name):
    """Every chunk encodes without an unknown id and within the prompt's
    text limit, and the port's front end splits and encodes each text as
    the reference does."""
    from tokenizers import Tokenizer

    from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer

    mix = _mix(name)
    tok_json = tokenizer.train(REPO)
    tok = frontend.encoder(tok_json)
    port = TTSTokenizer(Tokenizer.from_str(tok_json))
    unk = tok.token_to_id("[UNK]")
    for r in generator.requests(REPO, mix, 77, 60)[:200]:
        ids = [frontend.prompt_ids(tok, c) for c in r.chunks]
        assert all(unk not in i and len(i) - 2 <= FLAGLESS["model_args"]["gpt_max_text_tokens"]
                   for i in ids)
        assert all(len(c) <= frontend.LIMIT_EN for c in r.chunks)
        assert [[port.bos_token_id, *i, port.eos_token_id]
                for i in port.encode_with_split(r.text, "en")] == ids


def test_ebook_sizes():
    mix = _mix("ebook")
    reqs = generator.requests(REPO, mix, 123, 60)
    assert len(reqs) == mix["clients"] * mix["requests_per_client"]
    for r in reqs:
        assert 2 <= len(r.chunks) <= 4
        assert all(218 <= len(c.strip()) <= 249 for c in r.chunks)
        assert 260 <= r.cap <= 480 and not r.stream and r.voice == 0
    assert sum(r.greedy for r in reqs) == len(reqs) // 8
    caps = [r.cap for r in reqs]
    assert min(caps) < 280 and max(caps) > 460


def test_chat_sizes_and_arrivals():
    mix = _mix("chat")
    reqs = generator.requests(REPO, mix, 321, 100)
    for r in reqs:
        n = len(r.text)
        assert 40 <= n <= 402 and r.stream and 0 <= r.voice < mix["voices"]
        assert 1 <= len(r.chunks) <= 3
        longest = max(len(c.strip()) for c in r.chunks)
        want = mix["cap_per_char"] * longest
        lo, hi = mix["cap_tokens"]
        assert lo <= r.cap <= hi
        if lo < r.cap < hi:
            assert 0.79 * want <= r.cap <= 1.21 * want
    assert len({r.voice for r in reqs}) == mix["voices"]
    # arrivals: the mean rate with the bursts, R x (1 + (factor - 1) x length / period)
    b = mix["burst"]
    rate = mix["rate_per_s"] * (1 + (b["factor"] - 1) * b["length_s"] / b["period_s"])
    dues = [r.due for r in reqs]
    assert dues == sorted(dues) and dues[-1] >= 99
    assert abs(len(dues) / dues[-1] - rate) < 0.1 * rate
    in_burst = [d for d in dues if d % b["period_s"] >= b["period_s"] - b["length_s"]]
    share = len(in_burst) / len(dues)
    assert abs(share - 2 * b["length_s"] / (b["period_s"] + b["length_s"])) < 0.06
    lengths = sorted(len(r.text) for r in reqs)
    assert math.isclose(lengths[len(lengths) // 2], mix["chars"]["median"], rel_tol=0.15)
