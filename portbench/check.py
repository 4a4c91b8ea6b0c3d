"""Whether what the timed path served is correct, by the plain reference.

Once the window has closed and the program is freed, a sample of the
finished requests, drawn from the seed (`choose`): the one with the most
served tokens, `check.greedy_requests` greedy ones and
`check.other_requests` sampled ones. For each, the reference
(`portbench/reference/`, f32, TF32 off, its own weights drawn again from
the seed) conditions on the voice file, splits and tokenizes the text
itself, and runs the GPT teacher-forced over each chunk's prompt and
served tokens, then the vocoder over its latents (`judge`). Compared:
- `ids`: chunks whose prompt ids, as the program built them, differ from
  the reference's, or whose count differs (limit 0);
- `length`: requests whose audio is not the length of their chunks'
  waveforms (limit 0);
- `logit_gap`: over every position of every greedy chunk, the widest gap
  by which the served token's logit lies below the reference's best, both
  under the request's repetition penalty;
- `wave_err`: over every chunk, the widest relative L2 error of the
  served waveform against the reference's.
With `control`, the same readings of the control: the reference computed
through fp8 e4m3 products (`reference.model.Numerics(fp8=True)`), its
first choice at each position judged by the f32 reference's logits, and
its waveform against the f32 one.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import weights
from .reference import audio, frontend, model


def load_limits(root: Path, cell: str) -> dict:
    return json.loads((root / "portbench" / "limits" / f"{cell}.json").read_text())


def choose(requests: list, mix: dict, seed: int) -> list:
    """The finished requests to judge: the longest (by served tokens),
    then greedy and sampled ones drawn from the seed."""
    done = [r for r in requests if r["done"] is not None and not r["failed"] and r["chunks"]
            and all(c["n"] for c in r["chunks"])]
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 99])
    longest = max(done, key=lambda r: sum(c["n"] for c in r["chunks"]))
    out = [longest]
    for greedy, k in ((True, mix["check"]["greedy_requests"]),
                      (False, mix["check"]["other_requests"])):
        pool = [r for r in done if r["greedy"] == greedy and r is not longest]
        out += [pool[i] for i in rng.permutation(len(pool))[:k]]
    return out


def _rel_err(got: np.ndarray, want: torch.Tensor) -> float:
    want = want.double().cpu().numpy()
    return float(np.linalg.norm(got.astype(np.float64) - want) / max(np.linalg.norm(want), 1e-12))


@torch.no_grad()
def judge(root: Path, config: dict, mix: dict, seed: int, chosen: list, tokenizer_json: str,
          voice_paths: list, device, control: bool = False) -> dict:
    """The readings of the chosen requests (and of the control): {name:
    value}; logit_gap is None without a greedy chunk."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _judge(config, mix, seed, chosen, tokenizer_json, voice_paths, device, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _judge(config, mix, seed, chosen, tokenizer_json, voice_paths, device, control):
    a, arch = config["model_args"], config["architecture"]
    gpt, core = weights.make_weights(config, seed, device)
    tok = frontend.encoder(tokenizer_json)
    ref, ctl = model.Numerics(), model.Numerics(fp8=True)
    heads, start = a["gpt_n_heads"], a["gpt_start_audio_token"]
    voices = {}
    out = {"ids": 0, "length": 0, "logit_gap": None, "wave_err": 0.0, "tokens": 0}
    if control:
        out.update({"control_logit_gap": None, "control_wave_err": 0.0})
    for r in chosen:
        ids = [frontend.prompt_ids(tok, c) for c in frontend.chunks(r["text"])]
        if [c["ids"] for c in r["chunks"]] != ids:
            out["ids"] += 1
            continue
        if r["voice"] not in voices:
            wav, _ = audio.read_wav_f32(voice_paths[r["voice"]])
            voices[r["voice"]] = audio.conditioning(core, config, wav, 60, 30, 4, device)
        cond, dvec = voices[r["voice"]]
        waves, ctl_waves = [], []
        for c, chunk_ids in zip(r["chunks"], ids):
            toks = list(c["tokens"])
            if len(toks) < c["n"]:  # a trailing stop token the runner dropped
                toks.append(a["gpt_stop_audio_token"])
            logits, lat = model.gpt_outputs(gpt, heads, start, cond, chunk_ids, toks, ref)
            waves.append(model.vocode(core["hifigan"], a, arch["hifigan"], lat, dvec, ref))
            out["tokens"] += len(toks)
            pen = model.penalized(logits, toks, r["repetition_penalty"], start)
            best = pen.max(-1).values
            served = torch.tensor(toks, device=pen.device)[:, None]
            if r["greedy"]:
                gap = float((best - pen.gather(1, served)[:, 0]).max())
                out["logit_gap"] = max(out["logit_gap"] or 0.0, gap)
            if control:
                c_logits, c_lat = model.gpt_outputs(gpt, heads, start, cond, chunk_ids, toks, ctl)
                pick = model.penalized(c_logits, toks, r["repetition_penalty"], start).argmax(-1)
                gap = float((best - pen.gather(1, pick[:, None])[:, 0]).max())
                out["control_logit_gap"] = max(out["control_logit_gap"] or 0.0, gap)
                ctl_waves.append(model.vocode(core["hifigan"], a, arch["hifigan"], c_lat, dvec,
                                              ctl))
        served_audio = r["audio"]
        if served_audio.shape[0] != sum(w.shape[0] for w in waves):
            out["length"] += 1
            continue
        pos = 0
        for i, w in enumerate(waves):
            got = served_audio[pos:pos + w.shape[0]]
            pos += w.shape[0]
            err = _rel_err(got, w)
            out["wave_err"] = max(out["wave_err"], err)
            seg = max(1, w.shape[0] // 8)
            diff = got.astype(np.float64) - w.double().cpu().numpy()
            parts = [float(np.sqrt(np.mean(diff[k:k + seg] ** 2))) for k in range(0, len(diff), seg)]
            print(f"[check] request {r['idx']} ({'stream' if r['stream'] else 'row'}, "
                  f"{'greedy' if r['greedy'] else 'sampled'}) chunk {i}: n {r['chunks'][i]['n']}, "
                  f"wave_err {err:.4g}, rms error by eighths "
                  f"{[round(x, 5) for x in parts]}", file=sys.stderr)
            if control:
                c_wav = ctl_waves[i].double().cpu().numpy()
                out["control_wave_err"] = max(out["control_wave_err"], _rel_err(c_wav, w))
    return out


def verdict(readings: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every compared number within its
    limit, a greedy chunk judged, and no failed request."""
    shown = {"failed": {"value": failed, "limit": 0}}
    for name in ("ids", "length", "logit_gap", "wave_err"):
        shown[name] = {"value": readings.get(name), "limit": limits.get(name, 0)}
    ok = all(v["value"] is not None and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
