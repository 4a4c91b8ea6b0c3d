"""The one traffic generator: a mix's parameter file
(`portbench/traffic/<mix>.json`) and a seed -> the requests of a run.

Two loops:
- "closed": `clients` clients, each sending its next request when the last
  one has returned; client c sends the pool's requests c, c + clients, ...,
  starting c / clients of `stagger_s` seconds after the first (run.py);
- "open": requests due at Poisson arrivals of `rate_per_s`, multiplied by
  `burst.factor` for `burst.length_s` of every `burst.period_s` seconds.

So that every seed does the same work, the sizes come from the mix's own
`master_seed`: the pool of request sizes (text length and sentence count,
token cap, voice) and, in an open loop, the arrivals of each calm and each
burst stretch of each period. The run's seed only permutes them (the
spacings of the arrivals within their stretch, so each stretch holds the
same number of arrivals whatever the seed, and so does a window whose ends
fall on a period's edge; with `block`, the pool is `block` sizes repeated
and each run of `block` requests is permuted within itself, so any span of
requests holds nearly the same sizes) and draws the words. Every
1 / `greedy_share`-th request in the run's order, the first included, is
greedy.

A request's text is made of sentences of lower-case words from
`traffic/words.txt` with a comma now and then, each ending in a period;
`reference.frontend.chunks` gives the chunks it is decoded in. Texts:
- `sentence_chars: [lo, hi]` with `sentences: [a, b]`: that many
  sentences, each of lo..hi characters (the e-book's chunks);
- `chars: {median, sigma, min, max}` with `sentences: [a, b]`: a
  log-normal total length split unevenly over that many sentences (more
  where a sentence would pass 240 characters; the chat's).
Token caps: `cap_tokens: [lo, hi]` drawn uniformly, or with
`cap_per_char` about that many tokens a character of the longest chunk,
times U(1 - cap_jitter, 1 + cap_jitter), clipped to `cap_tokens`.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from .reference import frontend

SENTENCE_MAX = 240


@dataclasses.dataclass
class Request:
    idx: int
    text: str
    chunks: list
    cap: int
    greedy: bool
    voice: int
    stream: bool
    due: float | None = None  # seconds after the load starts (open loop)
    client: int | None = None  # closed loop


def load_mix(root: Path, name: str) -> dict:
    return json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())


def _sentence(rng, words: list, target: int) -> str:
    """Words up to `target` characters, a comma after one word in eight,
    and a period: at most target + 1 characters, at least target - 10."""
    out, n = [], -1
    while True:
        w = words[rng.integers(len(words))]
        if n + 1 + len(w) > target - (rng.random() < 0.125):
            break
        out.append(w)
        n += 1 + len(w)
        if n < target and rng.random() < 0.125:
            out[-1] += ","
            n += 1
    return " ".join(out).rstrip(",") + "."


def _sizes(mix: dict, n: int) -> list:
    """The pool of n request sizes from the mix's master seed:
    (sentence lengths, cap factor or cap, voice); with `block`, `block`
    sizes drawn once and repeated."""
    rng = np.random.default_rng(mix["master_seed"])
    lo_s, hi_s = mix["sentences"]
    out = []
    for i in range(min(n, mix.get("block", n))):
        k = int(rng.integers(lo_s, hi_s + 1))
        if "sentence_chars" in mix:
            lo, hi = mix["sentence_chars"]
            lens = [int(rng.integers(lo, hi + 1)) for _ in range(k)]
        else:
            c = mix["chars"]
            total = float(np.clip(c["median"] * math.exp(c["sigma"] * rng.standard_normal()),
                                  c["min"], c["max"]))
            k = max(k, math.ceil(total / SENTENCE_MAX))
            w = 0.8 + 0.4 * rng.random(k)
            lens = [int(np.clip(total * x / w.sum(), 20, SENTENCE_MAX)) for x in w]
        if "cap_per_char" in mix:
            cap = 1.0 + mix["cap_jitter"] * (2 * rng.random() - 1)
        else:
            cap = int(rng.integers(mix["cap_tokens"][0], mix["cap_tokens"][1] + 1))
        out.append((lens, cap, int(rng.integers(mix["voices"]))))
    return (out * (n // len(out) + 1))[:n]


def _stretches(mix: dict, duration: float) -> list:
    """The arrivals from the master seed over `duration` seconds: per calm
    and per burst stretch of each period, (start, end, arrival times), each
    stretch a Poisson process at its rate."""
    rng = np.random.default_rng(mix["master_seed"] + 1)
    b = mix["burst"]
    period, calm_s = b["period_s"], b["period_s"] - b["length_s"]
    out = []
    for k in range(math.ceil(duration / period)):
        t0 = k * period
        for start, end, factor in ((t0, t0 + calm_s, 1.0), (t0 + calm_s, t0 + period, b["factor"])):
            times, t = [], start
            while True:
                t += float(rng.exponential(1.0 / (mix["rate_per_s"] * factor)))
                if t >= end:
                    break
                times.append(t)
            out.append((start, end, times))
    return out


def requests(root: Path, mix: dict, seed: int, duration: float) -> list:
    """The run's requests: a closed loop's pool (the clients take them in
    turn), or an open loop's arrivals over `duration` seconds."""
    rng = np.random.default_rng(int(seed))
    words = (root / "portbench" / "traffic" / "words.txt").read_text().split()
    if mix["loop"] == "open":
        dues = []
        for start, end, times in _stretches(mix, duration):
            # the spacings (from the stretch's start to its end) in another order
            spacings = np.diff([start, *times, end])
            dues += [float(t) for t in
                     start + np.cumsum(spacings[rng.permutation(len(spacings))])[:-1]]
        n = len(dues)
    else:
        dues = None
        n = mix["clients"] * mix["requests_per_client"]
    block = mix.get("block", n)
    order = np.concatenate([b + rng.permutation(min(block, n - b)) for b in range(0, n, block)])
    sizes = _sizes(mix, n)
    sizes = [sizes[i] for i in order]
    every = round(1 / mix["greedy_share"])
    out = []
    for i, (lens, cap, voice) in enumerate(sizes):
        greedy = i % every == 0
        text = " ".join(_sentence(rng, words, ln) for ln in lens)
        chunks = frontend.chunks(text)
        if isinstance(cap, float):
            longest = max(len(c.strip()) for c in chunks)
            cap = int(round(mix["cap_per_char"] * longest * cap))
            cap = min(max(cap, mix["cap_tokens"][0]), mix["cap_tokens"][1])
        out.append(Request(i, text, chunks, cap, greedy, voice, mix["stream"],
                           due=None if dues is None else dues[i],
                           client=None if dues is not None else i % mix["clients"]))
    return out


def voice(mix: dict, seed: int, i: int) -> np.ndarray:
    """Voice i of the run: `voice_seconds` of a 22.05 kHz harmonic tone
    with a drifting pitch, a syllable-rate envelope and a little noise,
    amplitude under 0.6."""
    rng = np.random.default_rng([int(seed), i])
    sr = 22050
    t = np.arange(int(mix["voice_seconds"] * sr)) / sr
    f0 = rng.uniform(100, 240) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    amps = rng.uniform(0.2, 1.0, size=6) / np.arange(1, 7)
    wav = sum(a * np.sin((k + 1) * phase) for k, a in enumerate(amps))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    wav = wav * env + 0.01 * rng.standard_normal(t.shape)
    return (0.5 * wav / np.abs(wav).max()).astype(np.float32)
