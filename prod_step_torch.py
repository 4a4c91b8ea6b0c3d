"""Time the production decode block and insert programs of the PyTorch/CUDA
port (auralis_tpu_torch) on one NVIDIA GPU, for the serving-default A/Bs:
the counterpart of tools/bench_prod_step.py (and of the insert A/B of
tools/bisect_prefill.py).

    python3 prod_step_torch.py [--slots 8,16,32,64]
        [--bounds 256,512,768,1024,full] [--variants bf16,w8a8,...]
        [--steps 32] [--rounds 3] [--out chiprun_out/prod_step.json]

What it times is what serving replays: a `DecodeEngine`'s captured CUDA
graph of one decode block (`decode_steps_status`, n_steps steps under a
length bound, the sampler on at bench.py's settings) at the full XTTSv2
width (`XTTSGPTConfig()`: 30 x 1024, 16 heads), seed-0 random bf16 weights
with `blocks_q8` from `quantize_decode_weights`. Per (variant, slots,
bound) cell, as the JAX tool does: every slot active at fill = bound -
(rounds + 1) * steps - 2; the first block runs eagerly and is captured, the
fill is restored, then one warm replay and `rounds` replays between two
CUDA events. It prints ms per step and the full-occupancy decode RTF (ms
per step over the audio one step makes for every slot: 1024 samples at
22.05 kHz each), and the block's KV read over the bf16 block weights (the
W8A8 policy's ratio).

Variants (+-joined, as the JAX tool names them; `unroll` is not ported):
  bf16          no flag: bf16 KV, the dense body, bf16 weights
  w8a8          bf16 KV with decode_w8a8
  int8          the dense int8 body (kv_int8)
  int8+w8a8     the dense int8 body with decode_w8a8
  int8+w8a8+fp  the same with decode_attn_fp (bf16 probabilities)
  flash         flash_decode, kernel K2 (reference only)
  int8+ragged   kv_int8 + ragged_decode, kernel K4 (reference only)
Under K2/K4 the bound is only the fill level: they read each slot's live
rows. `full` is the cache's T (1280), the unbounded program.

Inserts: the captured single insert at prompt bucket 128 and the burst of
8 at bucket 128 (ms per chunk), each with prefill_w8a8 off and on, over a
bf16 and an int8 KV cache of 64 slots, on the flagless GPT config (the
prompt's attention in plain PyTorch, as the engine's default runs it),
INSERT_REPS replays each.

Every number goes to `--out` as JSON with the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`); the file
is rewritten after each variant. There is no CPU path: with no CUDA device
visible the script exits non-zero. The cell functions take a device and a
config, so a test drives them on the CPU at a tiny width (untimed).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from auralis_tpu_torch.models.xttsv2.config import XTTSGPTConfig
from auralis_tpu_torch.models.xttsv2.engine import _nbytes
from auralis_tpu_torch.models.xttsv2.gpt import quantize_decode_weights
from auralis_tpu_torch.models.xttsv2.weights import init_gpt_params, tree_to_torch
from auralis_tpu_torch.runtime.engine_core import DecodeEngine, SamplingOptions
from bench_torch import nvidia_smi_line

# variant -> the GPT config's flags
VARIANTS = {
    "bf16": {},
    "w8a8": {"decode_w8a8": True},
    "int8": {"kv_int8": True},
    "int8+w8a8": {"kv_int8": True, "decode_w8a8": True},
    "int8+w8a8+fp": {"kv_int8": True, "decode_w8a8": True, "decode_attn_fp": True},
    "flash": {"flash_decode": True},
    "int8+ragged": {"kv_int8": True, "ragged_decode": True},
}
# kernel paths the engine's defaults never choose (it does not set a
# config's kernel flags): timed beside the dense bodies for reference
REFERENCE_ONLY = ("flash", "int8+ragged")
SAMPLING = SamplingOptions(temperature=0.75, top_p=0.85, top_k=50, repetition_penalty=5.0,
                           do_sample=True)
SEC_PER_TOKEN = 1024 / 22050  # audio one decode step makes for one slot
INSERT_BUCKET = 128
INSERT_BURST = 8
INSERT_SLOTS = 64  # bench.py's decode slots
INSERT_REPS = 20


def variant_config(base: XTTSGPTConfig, variant: str) -> XTTSGPTConfig:
    return dataclasses.replace(base, **VARIANTS[variant])


def gpt_params(cfg: XTTSGPTConfig, device, seed: int = 0) -> dict:
    """Seeded random GPT weights in bf16 on `device`, with `blocks_q8`."""
    params = tree_to_torch(init_gpt_params(cfg, seed), device, torch.bfloat16)
    params["blocks_q8"] = quantize_decode_weights(params["blocks"])
    return params


def kv_to_weight(params: dict, cfg: XTTSGPTConfig, slots: int, bound: int) -> float:
    """A block's KV read (slots x bound rows of K and V over every layer)
    over the bytes of the bf16 block weights: the W8A8 policy's ratio."""
    kv_elem = 1 if cfg.kv_int8 else 2
    kv = slots * bound * 2 * cfg.hidden_size * cfg.num_hidden_layers * kv_elem
    return kv / _nbytes(params["blocks"])


def decode_engine(params: dict, cfg: XTTSGPTConfig, slots: int, steps: int,
                  device) -> DecodeEngine:
    """The runner whose captured decode blocks are timed (no W8A8 policy:
    the variant's flags hold for every block)."""
    return DecodeEngine(params, cfg, num_slots=slots, cache_dtype=torch.bfloat16,
                        steps_per_sync=steps, device=device)


def fill(de: DecodeEngine, length: int) -> None:
    """Every slot active at `length` cache rows, sampling at bench.py's
    settings (the JAX tool's state)."""
    st, sp = de.state, de.state.sampling
    st.active.fill_(True)
    st.done.fill_(False)
    st.seq_lens.fill_(length)
    st.audio_pos.fill_(2)
    st.last_token.zero_()
    st.n_generated.zero_()
    sp.temperature.fill_(SAMPLING.temperature)
    sp.top_p.fill_(SAMPLING.top_p)
    sp.top_k.fill_(SAMPLING.top_k)
    sp.repetition_penalty.fill_(SAMPLING.repetition_penalty)
    sp.do_sample.fill_(SAMPLING.do_sample)
    sp.max_new.zero_()


def _timed(device, fn, n: int) -> float | None:
    """ms of `n` calls of fn on the card between two CUDA events; None on
    the CPU, where nothing is timed."""
    if torch.device(device).type != "cuda":
        for _ in range(n):
            fn()
        return None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def decode_cell(de: DecodeEngine, bound: int, steps: int, rounds: int) -> dict:
    """One cell on `de`'s state: the block of (steps, bound) captured, the
    fill restored, one warm replay, `rounds` timed replays."""
    full = de.state.cache.max_len
    len_bound = None if bound >= full else bound
    length = max(2, bound - (rounds + 1) * steps - 2)
    host = de._status_bufs[0]

    def block():
        de._decode_block(steps, len_bound, None, host)

    fill(de, length)
    block()  # eager, then captured on the card
    fill(de, length)
    block()  # warm replay
    ms = _timed(de.device, block, rounds)
    lens = de.state.seq_lens
    assert int(lens.max()) < bound, (int(lens.max()), bound)
    per_step = None if ms is None else ms / (rounds * steps)
    return {"bound": bound, "len_bound": len_bound, "fill": length, "steps": steps,
            "rounds": rounds, "ms_per_step": per_step,
            "rtf": None if per_step is None else per_step / 1e3 / (de.num_slots * SEC_PER_TOKEN)}


def insert_cell(de: DecodeEngine, k: int, reps: int, bucket: int = INSERT_BUCKET,
                seed: int = 0) -> dict:
    """The captured insert program at `bucket` into slots 0..k-1 (the single
    insert for k = 1, else the burst of k): a full prompt of random text ids
    after random cond latents; the first call runs eagerly and is captured,
    then one warm replay and `reps` timed replays."""
    cfg = de.cfg
    c = cfg.num_cond_latents
    tb = bucket - c
    rng = np.random.default_rng(seed)
    cond = torch.from_numpy(rng.normal(0, 0.02, (c, cfg.hidden_size)).astype(np.float32)).to(
        de.device)
    ids = rng.integers(0, cfg.number_text_tokens, (k, tb)).astype(np.int64)
    args = ([cond] * k, ids, [tb - 1] * k, list(range(k)), [SAMPLING] * k)

    def insert():
        de._insert_tokens(*args)

    insert()  # eager, then captured on the card
    insert()  # warm replay
    ms = _timed(de.device, insert, reps)
    per = None if ms is None else ms / reps
    return {"bucket": bucket, "k": k, "reps": reps, "ms": per,
            "ms_per_chunk": None if per is None else per / k}


def _release(de) -> None:
    del de
    gc.collect()
    torch.cuda.empty_cache()


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", default="8,16,32,64")
    ap.add_argument("--bounds", default="256,512,768,1024,full")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/prod_step.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prod_step_torch: no CUDA device visible; this script has no CPU path",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    base = XTTSGPTConfig()
    t_full = base.max_seq_len + (-base.max_seq_len) % 256  # the cache's padded T
    bounds = [t_full if b == "full" else int(b) for b in args.bounds.split(",")]
    slots = [int(s) for s in args.slots.split(",")]
    smi = nvidia_smi_line()
    result = {"device": {"name": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count(), "nvidia_smi": smi},
              "torch": torch.__version__, "cuda": torch.version.cuda, "args": vars(args),
              "reference_only": list(REFERENCE_ONLY), "decode": [], "insert": []}
    print(f"device {result['device']['name']}; nvidia-smi: {smi}; steps {args.steps}, "
          f"rounds {args.rounds}", flush=True)

    def write() -> None:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)

    t0 = time.perf_counter()
    params = gpt_params(base, dev)
    print(f"weights (seed 0, bf16, blocks_q8) in {time.perf_counter() - t0:.1f} s", flush=True)
    for variant in variants:
        cfg = variant_config(base, variant)
        note = "  (reference only)" if variant in REFERENCE_ONLY else ""
        for s in slots:
            de = decode_engine(params, cfg, s, args.steps, dev)
            for b in bounds:
                t0 = time.perf_counter()
                cell = decode_cell(de, b, args.steps, args.rounds)
                cell.update(variant=variant, slots=s,
                            kv_to_weight=kv_to_weight(params, cfg, s, b),
                            wall_s=time.perf_counter() - t0)
                result["decode"].append(cell)
                print(f"  {variant:13s} slots {s:3d} bound {b:5d}: {cell['ms_per_step']:8.4f} "
                      f"ms/step  full-occupancy decode RTF {cell['rtf']:.6f}  KV/weights "
                      f"{cell['kv_to_weight']:6.2f}  ({cell['wall_s']:.1f} s){note}", flush=True)
            _release(de)
        write()
    for kv_int8 in (False, True):
        for prefill_w8a8 in (False, True):
            cfg = dataclasses.replace(base, kv_int8=kv_int8, prefill_w8a8=prefill_w8a8)
            de = decode_engine(params, cfg, INSERT_SLOTS, args.steps, dev)
            for k in (1, INSERT_BURST):
                cell = insert_cell(de, k, INSERT_REPS)
                cell.update(kv_int8=kv_int8, prefill_w8a8=prefill_w8a8)
                result["insert"].append(cell)
                print(f"  insert {'int8' if kv_int8 else 'bf16'} KV prefill_w8a8="
                      f"{prefill_w8a8!s:5s} bucket {cell['bucket']} K={k}: "
                      f"{cell['ms']:8.4f} ms, {cell['ms_per_chunk']:8.4f} ms/chunk", flush=True)
            _release(de)
    write()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
