"""Smoke run of the PyTorch/CUDA port (auralis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
 1. device: torch's device name, and name + power limit from nvidia-smi;
 2. build: the hand-written CUDA kernels from auralis_tpu_torch/csrc (nvcc),
    and cuobjdump's SASS: tensor-core HMMA in the bf16 K1 and K3 kernels,
    none in their f32 instantiations; the registers and local-memory
    (spill) bytes of the K2, K4 and K5 kernels (cuobjdump -res-usage);
 3. each kernel against its plain PyTorch version on the card, at the main
    path's shapes: the error entry by entry and the share of entries that
    differ, each against a stated bound, and both device times (repeated
    calls in one CUDA graph, timed with CUDA events), beside the kernel's
    bound (bytes over the memory rate or operations over the peak rate,
    from the call's shapes) and, for K1 and K3, one PyTorch call computing
    the same function; K1's and K3's f32 instantiations (phase 5's) too.
    K2 and K4 run at every write-position set of decode_bench.py (the
    ragged mix, split edges, all slots at 0, 127 and 1046), each launched
    twice (bit-equal ctx), and are timed cold (call i on layer i % 30, as
    a decode step reads them: `ms`) and hot (one layer, in L2: `ms_hot`),
    then on a slot-bounded step (the first 2 and 4 slots of the 8-slot
    cache: bit-equal to the full-width step's rows, slots beyond untouched);
    K5 the same over 30 layers' MLP weights in the serving layout, beside
    the serving chain's cold time (`serving_chain_ms`), with two launches
    bit-equal and its fc -> proj overlap kept in a CUDA graph (the
    captured graph's programmatic edge);
 4. the bf16 slice: an XTTSv2Engine at the full XTTSConfig() width with
    seeded random bf16 weights and a bf16 KV cache behind the TTS facade
    answers three requests (one sync, two concurrent), each capped at 300
    tokens; every waveform must be finite 24 kHz audio, and K1, K2 and K3
    must launch during the phase;
    then one 16-step decode block at 8 live slots is timed and profiled
    (wall, device ms, K2 ms per step, device busy share), and one
    605-latent chunk through the vocoder;
 4b. the int8 slice: the same with an int8 KV cache, W8A8 prefill and
    decode matmuls and ragged decode attention, each request capped at 200
    tokens; K1, K4 and K3 must launch; then phase 4f's int8 streaming
    request (100 tokens) on the same engine, in which K1, K4 and K3 must
    launch; one decode block is profiled as in 4 (K4 ms per step);
 4c. the dense int8 decode body (no K4) with W8A8 decode, one short request
    each with bf16 and with requantised attention probabilities;
 4d. K5's path: the W8A8 MLP of every layer of the int8 engine at decode
    shape through K5, each within 28 dB SNR of the serving composition;
 4e. the runner at concurrency, full width, 16 slots, slot bucketing on:
    bursts of K = 2, 4, 8 prompts as one batched insert against K single
    inserts (ms per chunk; first tokens, KV rows, latents); 16-step blocks
    at slot bounds 4 and 8 against full width (tokens equal) and their
    wall, device and decode-kernel ms per step at bounds 4, 8 and 16; one
    migrate_slot (every field bit for bit); 16 chunks through the runner
    (batched inserts, migrations, blocks below full width, its stats) and
    the same traffic through an unbucketed runner (tokens equal); one
    facade request of 9 chunks (a batched insert, a finite waveform);
    then the int8 configuration's bounds and runner, and the dense int8
    body under the per-program W8A8 policy (its choice at every bound);
    K2 and K3 (bf16) and K4 (int8) must launch in the runner drives;
 4f. streaming on the bf16 configuration with 16 slots: one solo
    streaming request, then 8 concurrent ones with bench.py's TTFA text
    (SENTENCE x 4, two chunks each, 120 tokens a chunk): time to first
    audio p50/p95, the speculative first segments and the vocode batches;
    7 of the 8 streams are closed after their first segment and every slot
    must drain; a greedy stream must give >= 2 segments that equal, to the
    16-bit PCM step, vocode_device_row of its final latent row, and that
    row in a batch of 4 must equal the row alone; TTS.warmup() must
    complete. K1, K2, K3 must launch. (Its int8 stream runs in 4b.) Phase
    3 checks K3 at the streaming windows' shapes (STREAM_WINDOWS);
 5. reference check: the same full-width engine in f32 answers one short
    greedy request on the card (through the kernels) and on the CPU
    (through their plain versions); tokens must be equal and waveforms
    agree to 16-bit PCM;
 5b. int8 reference check: the int8 engine of 4b teacher-forced through
    prefill and 32 decode steps on the card and on the CPU; logits and
    latents must agree to 25 dB SNR and greedy tokens wherever the top-2
    logit margin is decisive;
 6. checkpoint and server: a Coqui-style .pth of the full-width model from
    seeded random weights (export_coqui_state, in a temporary directory) is
    converted by the port's CLI (python -m
    auralis_tpu_torch.entrypoints.convert_checkpoint) in a subprocess;
    load_gpt_params / load_core_params of the result must equal the
    exported weights bit for bit. With a tokenizer and prefill_flash /
    flash_decode added to its config.json, the server boots in this process
    from the CLI's argv (build_parser, start_tts_engine, build_app) on an
    ephemeral port of 127.0.0.1 and answers real HTTP: /health,
    /v1/voices, one wav request, a wav and a flac request at once (the
    flac one by a named voice), one SSE stream (bench.py's TTFA text, two
    chunks), /metrics; each request capped at 100 tokens, each response
    finite 24 kHz audio; K1, K2 and K3 must launch. Then the CLI
    (python -m auralis_tpu_torch.entrypoints.oai_server --kv_int8) boots
    in a subprocess on a sibling model directory whose config sets the
    int8 path (kv_int8, ragged_decode, prefill_flash, W8A8), answers one
    short request and must exit 0 on SIGINT.

Each phase's header gives the seconds since the start. Any failure exits
non-zero. Before the last line come the kernels JSON
object and the nvidia-smi line; the last is {"ok": true, "device": {...}}. There is no CPU path: the
script exits non-zero when no CUDA device is visible. JAX is never imported.
"""
from __future__ import annotations

import asyncio
import base64
import ctypes
import dataclasses
import itertools
import json
import math
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.common import audio_io
from auralis_tpu_torch.common.tracing import profile_summary
from auralis_tpu_torch.models.xttsv2.config import XTTSConfig
from auralis_tpu_torch.models.xttsv2.engine import FIRST_SEG_PF, PAD_PF, SEG_PF, XTTSv2Engine
from auralis_tpu_torch.models.xttsv2.hifigan import (
    RESBLOCK_DILATIONS,
    RESBLOCK_KERNELS,
    UPSAMPLE_RATES,
)
from auralis_tpu_torch.models.xttsv2.gpt import (
    gpt_decode_step,
    gpt_prefill,
    gpt_prefill_batched,
    heads,
    layer_norm,
    quantize_decode_weights,
)
from auralis_tpu_torch.runtime.decode_loop import (
    _assemble_prompt,
    decode_steps,
    decode_steps_status,
    init_decode_state,
    insert_sequence_tokens,
    insert_sequences_tokens,
    migrate_slot,
    pack_status,
)
from auralis_tpu_torch.runtime.engine_core import DecodeEngine, SamplingOptions, TokenPrompt
from auralis_tpu_torch.models.xttsv2.weights import (
    init_gpt_params,
    params_from_numpy,
    random_init,
    tree_to_torch,
)
from auralis_tpu_torch.ops import _build
from auralis_tpu_torch.ops.experimental.attention import (
    flash_decode_append_attention,
    flash_decode_plain,
    ragged_decode_attention,
    ragged_decode_plain,
)
from auralis_tpu_torch.ops.experimental.fused_mlp import (
    fused_mlp_w8,
    fused_mlp_w8_plain,
    mlp_w8_reference,
)
from auralis_tpu_torch.ops.mrf import PackedMRFStage, mrf_stage_plain, run_fused_stage
from auralis_tpu_torch.ops.prefill_attention import (
    prefill_attention_plain,
    prefill_flash_attention,
)
from decode_bench import (
    HEAD_DIM,
    HEADS,
    HOT_LAYER,
    LAYERS,
    T_MAX,
    WRITE_POS_SETS,
    cold_hot_ms,
    k2_inputs,
    k4_inputs,
    k5_inputs,
    time_ms,
)

KERNELS = {
    "prefill_attention": {
        "wrapper": prefill_flash_attention,
        "source": "auralis_tpu_torch/csrc/prefill_attention.cu",
        "replaces": "auralis_tpu/ops/prefill_attention.py:61",
    },
    "flash_decode_append": {
        "wrapper": flash_decode_append_attention,
        "source": "auralis_tpu_torch/csrc/flash_decode.cu",
        "replaces": "auralis_tpu/ops/experimental/attention.py:151",
    },
    "mrf_stage": {
        "wrapper": run_fused_stage,
        "source": "auralis_tpu_torch/csrc/mrf.cu",
        "replaces": "auralis_tpu/ops/mrf.py:216",
    },
    "ragged_decode": {
        "wrapper": ragged_decode_attention,
        "source": "auralis_tpu_torch/csrc/ragged_decode.cu",
        "replaces": "auralis_tpu/ops/experimental/attention.py:436",
    },
    "fused_mlp_w8": {
        "wrapper": fused_mlp_w8,
        "source": "auralis_tpu_torch/csrc/fused_mlp_w8.cu",
        "replaces": "auralis_tpu/ops/experimental/fused_mlp.py:70",
    },
}
# the kernels each path must launch
BF16_PATH = ("prefill_attention", "flash_decode_append", "mrf_stage")
INT8_PATH = ("prefill_attention", "ragged_decode", "mrf_stage")


def say(*parts) -> None:
    print(*parts, flush=True)


T_START = time.perf_counter()


def phase(title: str) -> None:
    """A phase's header, with the seconds since the script started."""
    say(f"{title} (at {time.perf_counter() - T_START:.0f} s)")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def cuobjdump() -> str | None:
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return tool if os.path.exists(tool) else None


def kernel_resource_usage(so_path: str) -> list[str]:
    """`cuobjdump -res-usage` of the built library for the K2, K4 and K5
    kernels: registers per thread, stack, shared and local (spill) bytes."""
    tool = cuobjdump()
    if tool is None:
        return ["cuobjdump not found: registers and spills not read"]
    dump = subprocess.run([tool, "-res-usage", so_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    found, fn = [], None
    for line in dump.splitlines():
        if "Function " in line:
            fn = line.split("Function ")[1].split(":")[0].strip()
        if fn and "REG:" in line:
            if "decode_split_kernel" in fn or "mlp_" in fn:
                usage = [w for w in line.split() if w.split(":")[0] in
                         ("REG", "STACK", "SHARED", "LOCAL")]
                found.append(f"{fn}: {' '.join(usage)}")
            fn = None
    return found or ["no K2/K4/K5 kernel in cuobjdump -res-usage"]


def sass_check(so_path: str) -> str:
    """`cuobjdump -sass` of the built library: the bf16 K1 and K3 kernels
    must issue tensor-core HMMA instructions, their f32 instantiations none
    (they stay FFMA). Raises on a kernel on the wrong side."""
    tool = cuobjdump()
    if tool is None:
        return "cuobjdump not found: tensor-core use not checked"
    dump = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in dump.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = [0, 0]
        elif fn:
            counts[fn][0] += "HMMA" in line
            counts[fn][1] += "FFMA" in line
    groups = {
        "K1 bf16": lambda f: "prefill_attention_mma_kernel" in f,
        "K1 f32": lambda f: "prefill_attention_kernelIf" in f,
        "K3 bf16": lambda f: "mrf_conv" in f and "_mma" in f,
        "K3 f32": lambda f: "mrf_conv" in f and "kernelIff" in f,
    }
    report = []
    for name, match in groups.items():
        fns = [c for f, c in counts.items() if match(f)]
        hmma = [h for h, _ in fns]
        tensor = name.endswith("bf16")
        if not fns or (tensor and min(hmma) == 0) or (not tensor and max(hmma) > 0):
            raise AssertionError(f"{name}: HMMA counts {hmma} in {len(fns)} kernels")
        report.append(f"{name} {len(fns)} kernel(s), HMMA {sum(hmma)}, "
                      f"FFMA {sum(f for _, f in fns)}")
    return "; ".join(report)


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): device memory, and operations per second by operand type (f32 is
# the rate outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate (each input read once, each output written
    once) and the operations over the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ yardsticks
# One PyTorch call computing a kernel's function, timed beside the kernel as
# `library_ms`. The port never calls these.
def k1_mask(t: int, length: int, device) -> torch.Tensor:
    """K1's mask as SDPA's boolean attn_mask: key k is seen by query q iff
    (k <= q) & (k < length)."""
    pos = torch.arange(t, device=device)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] < length)


def sdpa_yardstick(q, k, v, mask) -> torch.Tensor:
    """K1's function in one scaled_dot_product_attention call on the same
    [T, H, D] tensors as [1, H, T, D] views; mask None is is_causal=True
    (equal to K1 on rows < length). Output [T, H, D] in q's dtype."""
    qh, kh, vh = (x.permute(1, 0, 2)[None] for x in (q, k, v))
    if mask is None:
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    else:
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    return out[0].permute(1, 0, 2)


def library_convs(stage: PackedMRFStage) -> list:
    """A stage's 18 convs as F.conv1d operands: (w [O, I, K], b, dilation)."""
    return [(w.permute(2, 1, 0).contiguous(), b, dil)
            for convs in stage.chains for w, b, dil in convs]


def library_conv(x_nct: torch.Tensor, w_oik, b, dil: int) -> torch.Tensor:
    """One dilated 'same' conv of [B, C, T] in one F.conv1d call."""
    return F.conv1d(x_nct, w_oik, b, padding=(w_oik.shape[-1] - 1) // 2 * dil, dilation=dil)


def library_stage(x_nct: torch.Tensor, convs: list) -> None:
    """K3's convs alone, one F.conv1d each, all on one contiguous [B, C, T]
    input: no lrelu, residual or mean passes (they favour the library)."""
    for w, b, dil in convs:
        library_conv(x_nct, w, b, dil)


# ------------------------------------------------------------ kernel checks
def check_prefill(dev, results) -> None:
    """K1 at the prefill buckets' shapes; q/k/v are strided views of one
    fused qkv row, exactly as gpt_prefill hands them over. Then the f32
    instantiation (phase 5's) at T = 128."""
    gen = torch.Generator(device=dev).manual_seed(1)
    h, d = 16, 64
    tol = 1e-3  # f32 in both; differences come from summation order and expf
    rows = {}
    for t, length, dt in ((128, 100, torch.bfloat16), (512, 400, torch.bfloat16),
                          (1047, 1047, torch.bfloat16), (128, 100, torch.float32)):
        qkv = torch.randn((t, 3 * h * d), generator=gen, device=dev).to(dt)
        q, k, v = (x.view(t, h, d) for x in qkv.split(h * d, dim=-1))
        got = prefill_flash_attention(q, k, v, length)
        torch.cuda.synchronize()
        want = prefill_attention_plain(q, k, v, length)
        err = (got - want).abs().max().item()
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        if not err <= tol:
            raise AssertionError(f"K1 prefill {tag} T={t}: error {err} > {tol}")
        ms = time_ms(lambda: prefill_flash_attention(q, k, v, length), 20)
        plain_ms = time_ms(lambda: prefill_attention_plain(q, k, v, length), 20)
        # bytes: q, k, v read once, f32 ctx written once; operations: QK^T
        # and PV over the (query, key) pairs the mask keeps
        pairs = sum(min(i + 1, length) for i in range(t))
        bound_ms, bound_by = bound(t * h * d * (3 * q.element_size() + 4), 4 * d * h * pairs,
                                   tag)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        line = (f"  K1 prefill {tag} T={t} len={length}: max_abs_err={err:.3e} (bound "
                f"{tol:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by}, {bound_ms / ms:.1%} of it)")
        if dt == torch.bfloat16:
            mask = k1_mask(t, length, dev)
            lib = sdpa_yardstick(q, k, v, mask)
            lib_err = (lib.float() - want).abs().max().item()
            row["library_ms"] = time_ms(lambda: sdpa_yardstick(q, k, v, mask), 20)
            causal_ms = time_ms(lambda: sdpa_yardstick(q, k, v, None), 20)
            line += (f"; library SDPA with K1's mask {row['library_ms']:.4f} ms (bf16 out, "
                     f"max_abs_err {lib_err:.3e}; kernel/library "
                     f"{ms / row['library_ms']:.2f}x), is_causal=True {causal_ms:.4f} ms")
        rows[(tag, t)] = row
        say(line)
    # the JSON row is the bucket the slice serves (T = 128)
    main = rows[("bf16", 128)]
    results["prefill_attention"] = {
        **main, "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "shape": "T=128 (len 100),H=16,D=64 bf16",
        "by_shape": {f"{tag} T={t}": r for (tag, t), r in rows.items()}}


def check_slot_slices(tag: str, kernel, plain, caches, ref_caches, rtol: float, atol: float,
                      dev) -> dict:
    """K2 or K4 on a slot-bounded step, as the runner's narrow slot buckets
    launch them: the first S = 2 and 4 slots of the 8-slot cache, at the
    ragged mix's first S write positions. Against the plain version on its
    own copy of the caches: caches (and scales) bit-equal, ctx within the
    full-width check's bound; the cache rows of slots >= S untouched; and
    the S rows of ctx bit-equal to the same step at full width.
    `kernel(S or None, write_pos)` and `plain(S, write_pos)` run one step."""
    ragged = WRITE_POS_SETS["ragged"]
    full_wp = torch.tensor(ragged, dtype=torch.int32, device=dev)
    full = kernel(None, full_wp)  # the same appends as the ragged set's: idempotent
    plain(len(ragged), full_wp)
    rows = {}
    for sb in (2, 4):
        wp = full_wp[:sb].clone()
        high = [c[HOT_LAYER, sb:].clone() for c in caches]
        got = kernel(sb, wp)
        torch.cuda.synchronize()
        want = plain(sb, wp)
        for i, (a, b) in enumerate(zip(caches, ref_caches)):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag} S={sb} of 8: cache tensor {i} differs from the plain "
                                     f"version's")
            if not torch.equal(a[HOT_LAYER, sb:], high[i]):
                raise AssertionError(f"{tag} S={sb} of 8: slots >= {sb} were written")
        if got.shape[0] != sb or not torch.equal(got, full[:sb]):
            raise AssertionError(f"{tag} S={sb} of 8: ctx differs from the full-width step's rows")
        err = (got.float() - want.float()).abs().max().item()
        ratio, mismatch = elementwise(got, want, rtol, atol)
        if not ratio <= 1.0:
            raise AssertionError(f"{tag} S={sb} of 8: worst error/bound {ratio}")
        rows[f"S={sb} of 8"] = {"write_pos": wp.tolist(), "max_abs_err": err,
                                "bit_equal_to_full_width": True}
        say(f"  {tag} slot-bounded step S={sb} of an 8-slot cache, write_pos {wp.tolist()}: "
            f"caches bit-equal to the plain version's, slots >= {sb} untouched, ctx bit-equal "
            f"to the full-width step's first {sb} rows; max_abs_err={err:.3e}, worst "
            f"|err|/bound {ratio:.3f} (bound {rtol:g}|ref| + {atol:g})")
    return rows


def check_decode(dev, results) -> None:
    """K2 on a [30, 8, 1280, 1024] bf16 cache at every write-position set of
    decode_bench.WRITE_POS_SETS. Both sides update their own copy of the
    cache, which must stay bit-equal; ctx must be within its bounds, and two
    launches on the same inputs must give the same bits. Timed cold (call i
    on layer i % 30, `ms`) and hot (layer 17, `ms_hot`); the plain version
    cold."""
    q, kn, vn, kc, vc = k2_inputs(dev)
    kc2, vc2 = kc.clone(), vc.clone()
    s, row_b = q.shape[0], HEADS * HEAD_DIM * 2
    rows = {}
    for name, wp_list in WRITE_POS_SETS.items():
        wp = torch.tensor(wp_list, dtype=torch.int32, device=dev)
        got = flash_decode_append_attention(q, kn, vn, kc, vc, HOT_LAYER, wp)
        again = flash_decode_append_attention(q, kn, vn, kc, vc, HOT_LAYER, wp)
        torch.cuda.synchronize()
        want = flash_decode_plain(q, kn, vn, kc2, vc2, HOT_LAYER, wp)
        if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
            raise AssertionError(f"K2 {name}: caches after the append differ from the plain "
                                 f"index-put")
        if not torch.equal(got, again):
            raise AssertionError(f"K2 {name}: two launches on the same inputs differ")
        err = (got.float() - want.float()).abs().max().item()
        # ctx is bf16, the f32 result rounded once. Summation order may flip
        # that rounding: one bf16 step, at most 2^-7 of |ctx|, plus 1e-5 for
        # f32 noise on entries near zero. Flips are rare (2 of these 8192
        # entries on an H100), so at most 1% may differ at all; bf16
        # probabilities change ~37% (off the card).
        ratio, mismatch = elementwise(got, want, 2.0 ** -7, 1e-5)
        if not (ratio <= 1.0 and mismatch <= 0.01):
            raise AssertionError(f"K2 {name}: worst error/bound {ratio}, mismatch {mismatch}")
        ms, ms_hot = cold_hot_ms(
            lambda layer: flash_decode_append_attention(q, kn, vn, kc, vc, layer, wp))
        rot = itertools.count()
        plain_ms = time_ms(
            lambda: flash_decode_plain(q, kn, vn, kc2, vc2, next(rot) % LAYERS, wp), LAYERS)
        # bytes: the live K and V rows (write_pos + 1 per slot: the cached
        # ones and the new one) read once, the new rows written once more
        # into the cache, q read and the bf16 ctx written; operations: QK^T
        # and PV over the live rows
        live = int((wp + 1).sum())
        bound_ms, bound_by = bound(2 * live * row_b + s * row_b * (2 + 1 + 1),
                                   4 * live * HEADS * HEAD_DIM, "bf16")
        rows[name] = {"write_pos": wp_list, "max_abs_err": err, "ms": ms, "ms_hot": ms_hot,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        say(f"  K2 decode S={s} T={T_MAX} {name} write_pos={wp_list}: max_abs_err={err:.3e}, "
            f"worst |err|/bound {ratio:.3f} (bound 2^-7|ref| + 1e-5 per entry), mismatch "
            f"{mismatch:.4%} (bound 1%), repeat bit-equal; kernel cold {ms:.4f} ms, hot "
            f"{ms_hot:.4f} ms, plain cold {plain_ms:.4f} ms per layer, bound {bound_ms:.5f} ms "
            f"({bound_by}, {live} live rows; {bound_ms / ms:.1%} of cold)")
    rows.update(check_slot_slices(
        "K2",
        lambda sb, wp: flash_decode_append_attention(q[:sb], kn[:sb], vn[:sb], kc, vc, HOT_LAYER,
                                                     wp),
        lambda sb, wp: flash_decode_plain(q[:sb], kn[:sb], vn[:sb], kc2, vc2, HOT_LAYER, wp),
        (kc, vc), (kc2, vc2), 2.0 ** -7, 1e-5, dev))
    del kc, vc, kc2, vc2
    main = rows["ragged"]
    results["flash_decode_append"] = {
        **{k: v for k, v in main.items() if k != "write_pos"}, "library_ms": None,
        "library_none": "no single call appends in place and attends over ragged lengths",
        "shape": "S=8,cache=[30,8,1280,1024] bf16, ragged write_pos",
        "timing": "ms cold: call i on layer i % 30; ms_hot: every call on layer 17",
        "by_shape": rows}


# K3's bound on the share of bf16 outputs that may differ from the plain
# version, per stage width. Summation-order noise flips a rare bf16 rounding
# of a conv input, and each flipped input moves the ~11 x C outputs of the
# next conv, so flips multiply down the chain's six convs, the more the wider
# the stage. Off the card at these widths with the model's weight scale
# (CPU, two f32 summation orders and f64), order noise changed up to
# 12 / 2 / 0.7 / 0.03% of outputs at C = 256 / 128 / 64 / 32, a stage that
# skips the bf16 rounding of conv inputs 33 / 21 / 13 / 7.8%, and one that
# carries the residual in bf16 43 / 35 / 30 / 28%. On an H100 the kernel
# against the plain version changed 19.4 / 5.6 / 0.86 / 0.10%. So the bound
# separates both departures from the contract at C <= 128; at C = 256 it
# only catches a gross one.
MRF_MISMATCH_BOUND = {256: 0.30, 128: 0.10, 64: 0.05, 32: 0.02}


def mrf_test_stage(gen, dev, c: int, dtype) -> PackedMRFStage:
    """A 3-chain stage (k = 3/7/11) with weights at the scale of the model's
    random init (0.02, init_hifigan_params)."""
    blocks = []
    for k in (3, 7, 11):
        mk = lambda: {"w": 0.02 * torch.randn((k, c, c), generator=gen, device=dev),
                      "b": 0.02 * torch.randn((c,), generator=gen, device=dev)}
        blocks.append({"convs1": [mk() for _ in range(3)],
                       "convs2": [mk() for _ in range(3)]})
    return PackedMRFStage(blocks, (3, 7, 11), dtype, dev)


def mrf_compare(x, stage) -> tuple:
    """The kernel against the plain version: (max_abs_err, |ref| max, worst
    |err| / (2^-7 |ref| + 2^-8 |ref|max), share of entries that differ)."""
    got = run_fused_stage(x, stage)
    torch.cuda.synchronize()
    want = mrf_stage_plain(x, stage)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    # per entry: one bf16 step (2^-7 of |ref|) for the output's own
    # rounding, plus 2^-8 of the output scale for flips carried down the
    # chain from earlier roundings (order noise reached 2^-10 off the card)
    return (err, scale, *elementwise(got, want, 2.0 ** -7, 2.0 ** -8 * scale))


# the streaming vocoders' generator windows, in post-interp frames, and the
# batch sizes a vocode batch takes there (segments up to 4, first segments
# up to 8)
STREAM_WINDOWS = (("segment", PAD_PF + SEG_PF + PAD_PF, (1, 4)),
                  ("first-segment", FIRST_SEG_PF + PAD_PF, (1, 8)))


def check_mrf(dev, results) -> None:
    """K3 at the four stage widths for a 600-token chunk's frame count:
    600 latents -> 2400 -> 2612 frames at 24 kHz; stage T = 8/64/128/256 x.
    Then, per width, one short batch-2 stage in f32 (the instantiation phase
    5 runs) and in bf16, with T off the 128-row tile grid, and one shorter
    than a conv's reach (T = 5: the zero padding is the whole halo). Then
    the streaming windows (STREAM_WINDOWS) at their smallest and largest
    batch, each stage timed beside its bound and library time."""
    gen = torch.Generator(device=dev).manual_seed(3)
    frames = math.floor(math.floor(600 * 1024 / 256) * 24000 / 22050)
    worst, by_stage = 0.0, []
    taps = 6 * sum((3, 7, 11))  # taps over a stage's 18 convs
    for c, mult in ((256, 8), (128, 64), (64, 128), (32, 256)):
        t = frames * mult
        stage = mrf_test_stage(gen, dev, c, torch.bfloat16)
        x = torch.randn((1, t, c), generator=gen, device=dev).to(torch.bfloat16)
        err, scale, ratio, mismatch = mrf_compare(x, stage)
        mis_bound = MRF_MISMATCH_BOUND[c]
        ms = time_ms(lambda: run_fused_stage(x, stage), 3)
        plain_ms = time_ms(lambda: mrf_stage_plain(x, stage), 3)
        x_nct, convs = x.transpose(1, 2).contiguous(), library_convs(stage)
        library_ms = time_ms(lambda: library_stage(x_nct, convs), 3)
        # bytes: x read and the stage mean written once, bf16, and every
        # conv's weights and bias read once; operations: the 18 convs
        weight_b = sum(w.numel() + b.numel() for w, b, _ in convs) * 2
        ops = 2 * c * c * t * taps
        bound_ms, bound_by = bound(2 * t * c * 2 + weight_b, ops, "bf16")
        by_stage.append({"C": c, "T": t, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms, "ops": ops,
                         "bytes": 2 * t * c * 2 + weight_b})
        worst = max(worst, err)
        say(f"  K3 MRF stage C={c} T={t}: max_abs_err={err:.3e} (|ref|max {scale:.2f}), "
            f"worst |err|/bound {ratio:.3f} (bound 2^-7|ref| + 2^-8 |ref|max per entry), "
            f"mismatch {mismatch:.4%} (bound {mis_bound:.0%}); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library 18 bf16 F.conv1d "
            f"{library_ms:.3f} ms (kernel/library {ms / library_ms:.2f}x), bound "
            f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it)")
        if not (ratio <= 1.0 and mismatch <= mis_bound):
            raise AssertionError(f"K3 C={c}: worst error/bound {ratio}, mismatch {mismatch}")
    gen = torch.Generator(device=dev).manual_seed(33)
    for c, t in ((256, 700), (128, 700), (64, 700), (32, 700), (32, 5)):
        for dt in (torch.float32, torch.bfloat16):
            stage = mrf_test_stage(gen, dev, c, dt)
            x = torch.randn((2, t, c), generator=gen, device=dev).to(dt)
            err, scale, ratio, mismatch = mrf_compare(x, stage)
            # f32: order noise changes most entries in their last bits, so
            # only the per-entry bound applies
            mis_bound = 1.0 if dt == torch.float32 else MRF_MISMATCH_BOUND[c]
            say(f"  K3 MRF short stage {str(dt)[6:]} B=2 C={c} T={t}: max_abs_err={err:.3e} "
                f"(|ref|max {scale:.2f}), worst |err|/bound {ratio:.3f}, mismatch "
                f"{mismatch:.4%} (bound {mis_bound:.0%})")
            if not (ratio <= 1.0 and mismatch <= mis_bound):
                raise AssertionError(f"K3 {dt} C={c} B=2: ratio {ratio}, mismatch {mismatch}")
    total = {key: sum(st[key] for st in by_stage)
             for key in ("ms", "plain_ms", "library_ms", "ops", "bytes")}
    bound_ms, bound_by = bound(total["bytes"], total["ops"], "bf16")
    by_window = []
    for window, wframes, batches in STREAM_WINDOWS:
        for b in batches:
            for c, mult in ((256, 8), (128, 64), (64, 128), (32, 256)):
                t = wframes * mult
                stage = mrf_test_stage(gen, dev, c, torch.bfloat16)
                x = torch.randn((b, t, c), generator=gen, device=dev).to(torch.bfloat16)
                err, scale, ratio, mismatch = mrf_compare(x, stage)
                ms = time_ms(lambda: run_fused_stage(x, stage), 3)
                plain_ms = time_ms(lambda: mrf_stage_plain(x, stage), 3)
                x_nct, convs = x.transpose(1, 2).contiguous(), library_convs(stage)
                library_ms = time_ms(lambda: library_stage(x_nct, convs), 3)
                weight_b = sum(w.numel() + b_.numel() for w, b_, _ in convs) * 2
                nbytes, ops = 2 * b * t * c * 2 + weight_b, 2 * c * c * b * t * taps
                w_bound, w_by = bound(nbytes, ops, "bf16")
                by_window.append({"window": window, "B": b, "C": c, "T": t, "ms": ms,
                                  "plain_ms": plain_ms, "library_ms": library_ms,
                                  "bound_ms": w_bound, "bound_by": w_by, "mismatch": mismatch})
                worst = max(worst, err)
                say(f"  K3 MRF stage, {window} window B={b} C={c} T={t}: max_abs_err={err:.3e}, "
                    f"worst |err|/bound {ratio:.3f}, mismatch {mismatch:.4%} (bound "
                    f"{MRF_MISMATCH_BOUND[c]:.0%}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"library {library_ms:.4f} ms, bound {w_bound:.5f} ms ({w_by}, "
                    f"{w_bound / ms:.1%} of it)")
                if not (ratio <= 1.0 and mismatch <= MRF_MISMATCH_BOUND[c]):
                    raise AssertionError(f"K3 {window} B={b} C={c}: ratio {ratio}, "
                                         f"mismatch {mismatch}")
    results["mrf_stage"] = {
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "library_ms": total["library_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": f"4 stages, {frames} frames (600 latents) bf16", "by_stage": by_stage,
        "by_window": by_window}


def check_ragged(dev, results) -> None:
    """K4 on a [30, 8, 1280, 1024] int8 cache with f32 scale rows at every
    write-position set of decode_bench.WRITE_POS_SETS. Both sides update
    their own copy of the caches and scales, which must stay bit-equal; ctx
    must be within its bound, and two launches on the same inputs must give
    the same bits. Timed as K2."""
    q, kn, vn, mine = k4_inputs(dev)
    ref = tuple(x.clone() for x in mine)
    s, row = q.shape[0], HEADS * HEAD_DIM
    rows = {}
    for name, wp_list in WRITE_POS_SETS.items():
        wp = torch.tensor(wp_list, dtype=torch.int32, device=dev)
        got = ragged_decode_attention(q, kn, vn, 0.125, HOT_LAYER, wp, *mine)
        again = ragged_decode_attention(q, kn, vn, 0.125, HOT_LAYER, wp, *mine)
        torch.cuda.synchronize()
        want = ragged_decode_plain(q, kn, vn, 0.125, HOT_LAYER, wp, *ref)
        for what, a, b in zip(("k_cache", "v_cache", "k_scale", "v_scale"), mine, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"K4 {name}: {what} after the append differs from the "
                                     f"plain version")
        if not torch.equal(got, again):
            raise AssertionError(f"K4 {name}: two launches on the same inputs differ")
        err = (got - want).abs().max().item()
        # ctx is f32 on both sides, from the same int8 rows and scales: the
        # scores are exact integers, so only expf and the order of the f32
        # sums differ. On the CPU the plain version in f32 against an f64
        # evaluation reaches 0.24 of this bound (1.2e-6 at |ctx| up to 3.2).
        # One wrong key, scale or mask row among ~1,000 live keys moves ctx
        # by ~1e-3, far past it.
        ratio, mismatch = elementwise(got, want, 1e-5, 1e-6)
        if not ratio <= 1.0:
            raise AssertionError(f"K4 {name}: worst error/bound {ratio}")
        ms, ms_hot = cold_hot_ms(
            lambda layer: ragged_decode_attention(q, kn, vn, 0.125, layer, wp, *mine))
        rot = itertools.count()
        plain_ms = time_ms(
            lambda: ragged_decode_plain(q, kn, vn, 0.125, next(rot) % LAYERS, wp, *ref), LAYERS)
        # bytes: the cached int8 K and V rows and their f32 scales read once,
        # q and the new bf16 rows read, the appended int8 rows and scales and
        # the f32 ctx written; operations: QK^T and PV over the live rows, at
        # the int8 rate (the lower bound: PV runs in f32)
        live = int((wp + 1).sum())
        nbytes = (2 * (live - s) * (row + 4) + s * row * 2 + 2 * s * row * 2
                  + 2 * s * (row + 4) + s * row * 4)
        bound_ms, bound_by = bound(nbytes, 4 * live * row, "int8")
        rows[name] = {"write_pos": wp_list, "max_abs_err": err, "ms": ms, "ms_hot": ms_hot,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        say(f"  K4 ragged int8 S={s} T={T_MAX} {name} write_pos={wp_list}: caches and scales "
            f"bit-equal; ctx max_abs_err={err:.3e}, worst |err|/bound {ratio:.3f} (bound "
            f"1e-5|ref| + 1e-6 per entry), differing {mismatch:.4%}, repeat bit-equal; kernel "
            f"cold {ms:.4f} ms, hot {ms_hot:.4f} ms, plain cold {plain_ms:.4f} ms per layer, "
            f"bound {bound_ms:.5f} ms ({bound_by}, {live} live rows; {bound_ms / ms:.1%} of "
            f"cold)")
    rows.update(check_slot_slices(
        "K4",
        lambda sb, wp: ragged_decode_attention(q[:sb], kn[:sb], vn[:sb], 0.125, HOT_LAYER, wp,
                                               *mine),
        lambda sb, wp: ragged_decode_plain(q[:sb], kn[:sb], vn[:sb], 0.125, HOT_LAYER, wp, *ref),
        mine, ref, 1e-5, 1e-6, dev))
    del mine, ref
    main = rows["ragged"]
    results["ragged_decode"] = {
        **{k: v for k, v in main.items() if k != "write_pos"}, "library_ms": None,
        "library_none": "no single call quantises, appends in place and attends over "
                        "ragged int8 rows",
        "shape": "S=8,cache=[30,8,1280,1024] int8+f32 scales, ragged write_pos",
        "timing": "ms cold: call i on layer i % 30; ms_hot: every call on layer 17",
        "by_shape": rows}


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    return 10 * math.log10(ref.square().sum().item() / max((got - ref).square().sum().item(),
                                                          1e-30))


def k5_graph_edges(args) -> tuple[list[int] | None, str]:
    """One K5 call captured in a CUDA graph, its edges counted by type
    (graph_edge_types in csrc/fused_mlp_w8.cu): ([full, programmatic], how
    read), or (None, why not read)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fused_mlp_w8(*args)
    counts = (ctypes.c_int * 2)()
    code = _build.library().graph_edge_types(graph.raw_cuda_graph(), ctypes.addressof(counts))
    del graph
    if code != 0:
        return None, f"cudaGraphGetEdges returned {code} (edge types need CUDA 12.3): not read"
    return list(counts), "cudaGraphGetEdges on the captured graph"


def check_fused_mlp(dev, results) -> None:
    """K5 at decode shape: S 8, D 1024, I 4096, bf16 activations, 30 layers
    of weights in the serving layout (decode_bench.k5_inputs: 240 MB against
    the 50 MB L2). On layer 17: at tile_i 1024 (the main path's) against
    the plain version and the serving `_dot_w8a8` chain; at tile_i 256 (16
    tiles to merge) and at S 3 and 1 (part of a row block live) against the
    plain version; every shape launched twice (bit-equal). Timed cold (call
    i on layer i % 30, `ms`) and hot (layer 17, `ms_hot`), the plain
    version and the serving chain cold. One call captured in a CUDA graph
    must keep its programmatic fc -> proj edge."""
    x, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b = k5_inputs(dev)
    s, d, i = x.shape[0], x.shape[1], fc_wq.shape[-1]

    def layer_args(layer: int, rows: int = s) -> tuple:
        return (x[:rows], fc_wq[layer], fc_ws[layer], fc_b[layer], proj_wq[layer],
                proj_ws[layer], proj_b[layer])

    checks = {}
    for rows, tile in ((s, 1024), (s, 256), (3, 256), (1, 1024)):
        args = layer_args(HOT_LAYER, rows)
        got = fused_mlp_w8(*args, tile_i=tile)
        again = fused_mlp_w8(*args, tile_i=tile)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K5 S={rows} tile_i={tile}: two launches differ")
        want = fused_mlp_w8_plain(*args, tile_i=tile)
        err = (got.float() - want.float()).abs().max().item()
        # The kernel follows the plain version's operations one by one (same
        # int8 values, exact int32 products, no contracted multiply-adds,
        # erff in both gelus), so it should be bit-equal. Allowed for: a
        # gelu value one ulp apart that is the largest of its (row, tile)
        # moves that scale and redraws the row's requantisation, which moves
        # its D outputs at the quantisation-noise level (3.3e-4 of a 0.37
        # output scale on the CPU against the Pallas polynomial gelu); one
        # bf16 step is 2^-7 of |ref|. Bounds: per entry 2^-7 |ref| + 2^-9 of
        # the output scale, at most 2 of the 8 rows differing at all, and
        # SNR against the plain version above 50 dB.
        scale = want.float().abs().max().item()
        ratio, mismatch = elementwise(got, want, 2.0 ** -7, 2.0 ** -9 * scale)
        rows_off = int((got != want).any(dim=1).sum())
        snr_plain = snr_db(want, got)
        line = (f"  K5 fused W8A8 MLP S={rows} D={d} I={i} tile_i={tile}: max_abs_err={err:.3e} "
                f"(|ref|max {scale:.3f}), worst |err|/bound {ratio:.3f} (bound 2^-7|ref| + "
                f"2^-9 |ref|max), differing {mismatch:.4%} in {rows_off} of {rows} rows (bound "
                f"2 rows), SNR vs plain {snr_plain:.1f} dB (bound 50), repeat bit-equal")
        ok = ratio <= 1.0 and rows_off <= 2 and snr_plain > 50.0
        if (rows, tile) == (s, 1024):
            snr_serving = snr_db(mlp_w8_reference(*args), got)
            line += f"; vs the serving _dot_w8a8 chain {snr_serving:.1f} dB (bound 28)"
            ok = ok and snr_serving > 28.0
        say(line)
        if not ok:
            raise AssertionError(f"K5 S={rows} tile_i={tile}: ratio {ratio}, rows off "
                                 f"{rows_off}, SNR {snr_plain} dB")
        checks[f"S={rows} tile_i={tile}"] = {"max_abs_err": err, "rows_differing": rows_off,
                                             "snr_plain_db": snr_plain}
    edges, how = k5_graph_edges(layer_args(HOT_LAYER))
    say(f"  K5 in a CUDA graph: edges (full, programmatic) {edges} ({how})")
    if edges is not None and edges[1] < 1:
        raise AssertionError(f"K5: the captured graph lost the fc -> proj programmatic edge "
                             f"({edges})")
    ms, ms_hot = cold_hot_ms(lambda layer: fused_mlp_w8(*layer_args(layer)))
    rot = itertools.count()
    plain_ms = time_ms(lambda: fused_mlp_w8_plain(*layer_args(next(rot) % LAYERS)), LAYERS)
    rot = itertools.count()
    serving_ms = time_ms(lambda: mlp_w8_reference(*layer_args(next(rot) % LAYERS)), LAYERS)
    # bytes: x, the int8 weights, their scales and the biases read once, the
    # bf16 output written; operations: both products at the int8 rate
    args = layer_args(HOT_LAYER)
    nbytes = sum(a.numel() * a.element_size() for a in args) + s * d * 2
    bound_ms, bound_by = bound(nbytes, 2 * 2 * s * d * i, "int8")
    say(f"  K5 S={s} tile_i=1024 timing: kernel cold {ms:.4f} ms, hot {ms_hot:.4f} ms; plain "
        f"cold {plain_ms:.4f} ms; serving chain (_dot_w8a8 x2 around gelu) cold "
        f"{serving_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}, {bound_ms / ms:.1%} of "
        f"cold); library: none (no single call does int8 fc + gelu + proj)")
    results["fused_mlp_w8"] = {
        "max_abs_err": checks[f"S={s} tile_i=1024"]["max_abs_err"], "ms": ms, "ms_hot": ms_hot,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library_none": "no single call does the int8 fc + gelu + proj with per-row "
                        "requantisation",
        "serving_chain_ms": serving_ms, "graph_edges_full_programmatic": edges,
        "shape": "S=8,D=1024,I=4096,tile_i=1024, bf16 x, int8 weights column-major",
        "timing": "ms cold: call i on layer i % 30 of 30 layers' weights; ms_hot: layer 17",
        "checks": checks}


def elementwise(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    """(max over entries of |got - want| / (rtol |want| + atol), share of
    entries that differ at all). A NaN anywhere makes the first NaN (torch's
    max propagates it), which fails every `ratio <= 1` check."""
    g, w = got.float(), want.float()
    ratio = ((g - w).abs() / (rtol * w.abs() + atol)).max().item()
    return ratio, (g != w).float().mean().item()


# ---------------------------------------------------------------- tokenizer
class CharTokenizer:
    """Character-level stand-in for TTSTokenizer, used only when the
    `tokenizers` package is missing. Built on the port's copied frontend
    (preprocess_text / split_text_into_chunks), so normalization and
    sentence chunking are the real ones (at the 250-character default limit:
    the per-language limits live in frontend/tokenizer.py, which needs
    `tokenizers`); ids are characters folded into the text vocabulary."""

    CHUNK_CHARS = 250

    def __init__(self, vocab: int):
        self.vocab = vocab
        self.bos_token_id, self.eos_token_id = 2, 3

    def encode_with_split(self, text, lang: str = "en"):
        from auralis_tpu_torch.frontend.cleaners import preprocess_text
        from auralis_tpu_torch.frontend.sentence import split_text_into_chunks

        texts = [text] if isinstance(text, str) else list(text)
        chunks = [c for t in texts for c in split_text_into_chunks(t, max_length=self.CHUNK_CHARS)]
        return [[5 + ord(ch) % (self.vocab - 5) for ch in preprocess_text(c, lang)]
                for c in chunks]


def build_tokenizer(vocab: int):
    try:
        from tokenizers import Tokenizer, models, trainers
    except ImportError:
        say("  tokenizer: `tokenizers` is not installed; using the character-level "
            "stand-in over the port's frontend (preprocess_text + split_text_into_chunks)")
        return CharTokenizer(vocab)
    from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer

    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    trainer = trainers.BpeTrainer(
        vocab_size=380, special_tokens=["[PAD]", "[UNK]", "[START]", "[STOP]", "[SPACE]", "[en]"])
    tok.train_from_iterator([
        "hello[SPACE]world[SPACE]this[SPACE]is[SPACE]a[SPACE]test[SPACE]of[SPACE]speech",
        "the[SPACE]quick[SPACE]brown[SPACE]fox[SPACE]jumps[SPACE]over[SPACE]the[SPACE]dog",
        "abcdefghijklmnopqrstuvwxyz0123456789.,!?'",
    ], trainer)
    say("  tokenizer: small BPE trained in-process (`tokenizers` is installed)")
    return TTSTokenizer(tok)


# -------------------------------------------------------------------- slice
def build_engine(dev, tokenizer, gpt_flags: dict, engine_flags: dict, **kw) -> XTTSv2Engine:
    """The full-width engine with seeded random bf16 weights."""
    cfg = XTTSConfig()
    cfg.gpt = dataclasses.replace(cfg.gpt, **gpt_flags)
    t0 = time.perf_counter()
    engine = XTTSv2Engine.random_init(
        cfg, tokenizer=tokenizer, dtype=torch.bfloat16, seed=0, device=dev,
        decode_slots=kw.pop("decode_slots", 8), max_concurrency=4, **engine_flags, **kw)
    torch.cuda.synchronize()
    cache = engine.decode_engine.state.cache
    say(f"  engine: GPT {cfg.gpt.num_hidden_layers} layers x {cfg.gpt.hidden_size}, "
        f"{cfg.gpt.num_attention_heads} heads, {engine.decode_slots} slots, KV cache "
        f"{tuple(cache.k.shape)} {cache.k.dtype}{' + f32 scales' if cache.quantized else ''}, "
        f"{', '.join(f'{k}={v}' for k, v in {**gpt_flags, **engine_flags}.items())}; "
        f"memory plan {engine.max_gb_for_model:.2f} GiB; built in {time.perf_counter() - t0:.1f} s")
    return engine


def device_events(prof) -> list:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_ms(dev_events) -> float:
    """The union of the device events' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def profile_decode(engine, smi: str, kernel: str) -> None:
    """One block of `decode_steps` (the runner's 16 steps, then its one host
    sync, the packed status) with every slot live at the phase-3 ragged
    write positions: wall per step (host clock, median of 3 blocks), then one
    block under torch.profiler for the device ms per step (sum of device
    event times), the decode kernel's ms per step (device events whose name
    holds `kernel`) and the device busy share (union of device intervals
    over the profiled wall)."""
    from torch.profiler import ProfilerActivity, profile

    de = engine.decode_engine
    st, n = de.state, de.steps_per_sync
    lens = torch.tensor(WRITE_POS_SETS["ragged"][:de.num_slots], dtype=torch.int32,
                        device=engine.device)

    def block():
        st.seq_lens.copy_(lens)
        st.audio_pos.fill_(1)
        st.n_generated.zero_()
        st.active.fill_(True)
        st.done.fill_(False)
        decode_steps(de.params, de.cfg, st, n)
        return pack_status(st).cpu()

    block()  # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        block()
        walls.append((time.perf_counter() - t0) * 1e3 / n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        block()
        prof_wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    head = (f"  decode block: {n} steps x {de.num_slots} live slots (write_pos "
            f"{lens.tolist()}), wall {statistics.median(walls):.3f} ms per step (median of 3: "
            f"{', '.join(f'{w:.3f}' for w in walls)})")
    if not events:
        say(f"{head}; the profiler saw no device events: device ms not measured ({smi})")
        return
    dev_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    k_ms = sum(e.time_range.elapsed_us() for e in events if kernel in e.name) / 1e3
    k_n = sum(kernel in e.name for e in events)
    busy = busy_ms(events)
    say(f"{head}; profiled block {prof_wall / n:.3f} ms wall per step, device "
        f"{dev_ms / n:.3f} ms per step in {len(events) / n:.0f} device ops, {kernel} "
        f"{k_ms / n:.4f} ms per step ({k_n / n:.0f} launches), device busy "
        f"{busy / prof_wall:.1%} ({smi})")


def profile_vocoder(engine, smi: str) -> None:
    """One 605-latent chunk through the engine's row vocoder (the bucket a
    full chunk takes): wall per chunk (host clock to the PCM on the host,
    median of 3), then one chunk under torch.profiler for the device busy
    share (union of device event intervals over the profiled wall) and K3's
    share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    g = engine.gpt_config
    n = g.max_audio_tokens
    gen = torch.Generator(device=engine.device).manual_seed(8)
    row = torch.randn((n, g.hidden_size), generator=gen, device=engine.device)
    spk = np.random.default_rng(8).standard_normal((1, 512)).astype(np.float32) * 0.1
    engine.vocode_device_row(row, n, spk)  # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.vocode_device_row(row, n, spk)
        walls.append((time.perf_counter() - t0) * 1e3)
    before = run_fused_stage.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.vocode_device_row(row, n, spk)
        prof_wall = (time.perf_counter() - t0) * 1e3
    k3_launches = run_fused_stage.launches - before
    dev_events = device_events(prof)
    if not dev_events:
        say(f"  vocoder: {n} latents, wall {statistics.median(walls):.2f} ms per chunk; the "
            f"profiler saw no device events: busy share not measured ({smi})")
        return
    busy = busy_ms(dev_events)
    k3_ms = sum(e.time_range.elapsed_us() for e in dev_events if "mrf_conv" in e.name) / 1e3
    say(f"  vocoder: {n} latents, wall {statistics.median(walls):.2f} ms per chunk (median of "
        f"3: {', '.join(f'{w:.2f}' for w in walls)}); profiled chunk {prof_wall:.2f} ms wall, "
        f"device busy {busy:.2f} ms ({busy / prof_wall:.1%}), {len(dev_events)} device ops, "
        f"K3 {k3_ms:.2f} ms in {k3_launches} launches ({smi})")


def run_slice(dev, smi: str, tokenizer, gpt_flags: dict, engine_flags: dict,
              must_launch: tuple, decode_kernel: str, vocoder: bool = False,
              max_new_tokens: int = 0, stream_tokens: int = 0) -> tuple[dict, dict]:
    """Three requests through the TTS facade (one sync, two concurrent),
    each chunk capped at `max_new_tokens` (0: the model's 605); then, with
    `stream_tokens`, one streaming request capped there (phase 4f's int8
    part). Returns the launch counts of every kernel during the three and
    during the stream. Then one decode block is profiled (`decode_kernel`:
    the device name of the decode attention kernel) and, with `vocoder`,
    one chunk through the vocoder."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = build_engine(dev, tokenizer, gpt_flags, engine_flags)
    tts = TTS(scheduler_max_concurrency=4).with_engine(engine)
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_voice(tmp)

        def request(text):
            return TTSRequest(text=text, speaker_files=[wav_path], language="en",
                              max_new_tokens=max_new_tokens or None)

        for w in KERNELS.values():
            w["wrapper"].launches = 0
        outs = []
        t_start = time.perf_counter()
        out = tts.generate_speech(request("Hello world, this is a test of speech."))
        torch.cuda.synchronize()
        outs.append(("sync", out, time.perf_counter() - t_start))

        async def two():
            async def one(text):
                t1 = time.perf_counter()
                o = await tts.generate_speech_async(request(text))
                torch.cuda.synchronize()
                return o, time.perf_counter() - t1
            return await asyncio.gather(one("The quick brown fox jumps over the dog."),
                                        one("One two three four five six seven."))

        for i, (o, wall) in enumerate(tts.loop.run_until_complete(two())):
            outs.append((f"async{i + 1}", o, wall))
        launches = {name: w["wrapper"].launches for name, w in KERNELS.items()}
        stream = {name: 0 for name in KERNELS}
        if stream_tokens:
            for w in KERNELS.values():
                w["wrapper"].launches = 0
            ttfa, n_seg, secs = tts.loop.run_until_complete(stream_ttfa(tts, TTSRequest(
                text="Hello world, this is a test of speech.", speaker_files=[wav_path],
                language="en", stream=True, max_new_tokens=stream_tokens), False))
            stream = {name: w["wrapper"].launches for name, w in KERNELS.items()}
            say(f"  [4f] stream ({stream_tokens}-token cap) on this engine: first segment "
                f"{ttfa * 1e3:.1f} ms, {n_seg} segments, {secs:.2f} s audio; launches {stream} "
                f"({smi})")
            for name in must_launch:
                if stream[name] <= 0:
                    raise AssertionError(f"kernel {name} was not launched by the stream")
        tts.loop.run_until_complete(tts.shutdown())

    for name, o, wall in outs:
        check_waveform(name, o)
        secs = o.array.size / o.sample_rate
        tokens = round(o.array.size / 1024 * 22050 / 24000)  # 1024 samples @22.05k per token
        say(f"  {name}: wall {wall:.2f} s, ~{tokens} audio tokens, {secs:.2f} s audio, "
            f"audio/wall {secs / wall:.2f} ({smi})")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1024**3:.2f} GiB; "
        f"launches during the slice: {launches}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    profile_decode(engine, smi, decode_kernel)
    if vocoder:
        profile_vocoder(engine, smi)
    del tts, engine
    return launches, stream


def check_waveform(name: str, o) -> None:
    a = np.asarray(o.array)
    if not (o.sample_rate == 24000 and a.ndim == 1 and a.size > 0 and np.isfinite(a).all()):
        raise AssertionError(f"{name}: bad waveform sr={o.sample_rate} shape={a.shape} "
                             f"finite={np.isfinite(a).all()}")


def run_dense_int8(dev, tokenizer) -> None:
    """The dense int8 decode body (no K4) with W8A8 decode matmuls: one
    64-token request each with bf16 probabilities (decode_attn_fp) and with
    probabilities requantised to int8."""
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_voice(tmp)
        for attn_fp in (True, False):
            engine = build_engine(dev, tokenizer, {"prefill_flash": True,
                                                   "decode_attn_fp": attn_fp},
                                  {"kv_int8": True, "decode_w8a8": True}, decode_slots=2)
            tts = TTS(scheduler_max_concurrency=1).with_engine(engine)
            t0 = time.perf_counter()
            out = tts.generate_speech(TTSRequest(
                text="Hello world, this is a test of speech.", speaker_files=[wav_path],
                language="en", max_new_tokens=64))
            torch.cuda.synchronize()
            check_waveform(f"dense int8 decode_attn_fp={attn_fp}", out)
            say(f"  decode_attn_fp={attn_fp}: {out.array.size / out.sample_rate:.2f} s audio "
                f"(64 tokens cap) in {time.perf_counter() - t0:.2f} s wall")
            tts.loop.run_until_complete(tts.shutdown())
            del tts, engine


def run_fused_mlp_path(dev) -> int:
    """K5's path: the W8A8 MLP of every layer of the int8 slice's weights
    (seed 0, blocks_q8 quantised from the bf16 blocks) on decode-shaped
    activations (8 slots, through ln2 as the MLP gets them), each through K5
    and held to 28 dB SNR against the serving `_dot_w8a8` chain. Returns
    K5's launches."""
    g = XTTSConfig().gpt
    bp = tree_to_torch(init_gpt_params(g, 0)["blocks"], dev, torch.bfloat16)
    bq = quantize_decode_weights(bp)
    gen = torch.Generator(device=dev).manual_seed(6)
    fused_mlp_w8.launches = 0
    worst = math.inf
    for layer in range(g.num_hidden_layers):
        x = torch.randn((8, g.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
        xn = layer_norm(x, bp["ln2_scale"][layer], bp["ln2_bias"][layer])
        scales = (bq["fc_w_s"][layer], bp["fc_b"][layer], bq["fc_proj_w_s"][layer],
                  bp["fc_proj_b"][layer])
        got = fused_mlp_w8(xn, bq["fc_w_q"][layer], scales[0], scales[1],
                           bq["fc_proj_w_q"][layer], *scales[2:])
        want = mlp_w8_reference(xn, bq["fc_w_q"][layer], scales[0], scales[1],
                                bq["fc_proj_w_q"][layer], *scales[2:])
        worst = min(worst, snr_db(want, got))
    launches = fused_mlp_w8.launches
    say(f"  {g.num_hidden_layers} layers through K5: worst SNR vs the serving chain "
        f"{worst:.1f} dB (bound 28); launches {launches}")
    if not worst > 28.0:
        raise AssertionError(f"K5 path: SNR {worst} dB")
    return launches


async def _greedy_chunk(engine, wav_path: str, text: str, max_new: int):
    """One greedy chunk through the engine's phase-1/phase-2 API:
    (tokens, waveform)."""
    req = TTSRequest(text=text, speaker_files=[wav_path], language="en", do_sample=False,
                     max_new_tokens=max_new)
    handles, _, spk, _ = await engine.get_generation_context(req)
    tokens, row, n = await handles[0]
    wav = await asyncio.to_thread(engine.vocode_device_row, row, n, spk)
    await engine.shutdown()
    return np.asarray(tokens), wav


def run_reference_check(dev, tokenizer) -> None:
    cfg = XTTSConfig()
    cfg.gpt.flash_decode = True
    cfg.gpt.prefill_flash = True
    gpt_np, core_np = random_init(cfg, seed=1)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_voice(tmp)
        for device in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            params, core = params_from_numpy(gpt_np, core_np, device=device, dtype=torch.float32)
            engine = XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, tokenizer=tokenizer,
                                  device=device, cache_dtype=torch.float32,
                                  vocoder_dtype=torch.float32, decode_slots=2,
                                  max_concurrency=1)
            out[device.type] = asyncio.run(_greedy_chunk(engine, wav_path, "Hello world.", 24))
            say(f"  {device.type}: {len(out[device.type][0])} tokens, "
                f"{out[device.type][1].size} samples in {time.perf_counter() - t0:.1f} s")
            del engine, params, core
    (tok_g, wav_g), (tok_c, wav_c) = out["cuda"], out["cpu"]
    if not np.array_equal(tok_g, tok_c):
        raise AssertionError(f"greedy tokens differ: card {tok_g.tolist()} cpu {tok_c.tolist()}")
    err = float(np.abs(wav_g - wav_c).max()) if wav_g.shape == wav_c.shape else float("inf")
    # both are f32 end to end with TF32 off; the waveform is shipped as
    # 16-bit PCM, so f32 summation-order noise shows as a step or two
    bound = 3.0 / 32767
    say(f"  tokens equal ({len(tok_g)}); waveform max_abs_err={err:.3e} (bound {bound:.2e}), "
        f"peak {np.abs(wav_c).max():.3f}")
    if not err <= bound:
        raise AssertionError(f"waveform: card vs cpu error {err} > {bound}")


def run_int8_reference_check(dev) -> None:
    """The int8 slice's engine (kv_int8, W8A8 prefill and decode, K1 + K4)
    with one seeded bf16 weight set, on the card and on the CPU: one
    128-row prompt through gpt_prefill, then 32 teacher-forced decode steps
    on the engine's own params (blocks_q8 included) and KV cache. bf16
    activations and int8 requantisation make free-running token equality
    fragile, so the rule of tests/unit/test_kv_int8.py holds: greedy tokens
    equal wherever the CPU's top-2 logit margin is decisive (at least 8 such
    steps), and logits and latents above an SNR floor of 25 dB. Once any
    upstream f32 difference moves the largest element of a row, that row's
    int8 requantisation is redrawn, so card and CPU each carry their own draw
    of the W8A8 quantisation noise. At full width that noise is 27.5 dB
    below the logits against an f32 run of the same weights on the card
    (int8 KV alone: 35.6 dB; bf16: 36.1 dB), the card and CPU draws 30.8 dB
    apart. "Decisive" is a top-2 margin above 4x the RMS logit difference
    (the JAX test's 0.01 sits below this noise)."""
    cfg = XTTSConfig()
    cfg.gpt = dataclasses.replace(cfg.gpt, prefill_flash=True, ragged_decode=True)
    gpt_np, core_np = random_init(cfg, seed=2)
    rng = np.random.default_rng(7)
    cond = (0.3 * rng.standard_normal((cfg.gpt.num_cond_latents, cfg.gpt.hidden_size))
            ).astype(np.float32)
    n_ids = 40
    ids = np.zeros((128 - cfg.gpt.num_cond_latents,), np.int64)
    ids[:n_ids] = rng.integers(5, 300, n_ids)
    length = cfg.gpt.num_cond_latents + n_ids + 1
    forced = rng.integers(0, cfg.gpt.num_audio_tokens - 2, 32)
    out = {}
    for device in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        params, core = params_from_numpy(gpt_np, core_np, device=device, dtype=torch.bfloat16)
        engine = XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device=device,
                              decode_slots=2, max_concurrency=1, kv_int8=True,
                              decode_w8a8=True, prefill_w8a8=True)
        g, p, cache = engine.gpt_config, engine.params, engine.decode_engine.state.cache
        embeds = _assemble_prompt(p, g, torch.from_numpy(cond).to(device),
                                  torch.from_numpy(ids).to(device), n_ids).to(torch.bfloat16)
        h = gpt_prefill(p, g, embeds, length, 0, cache)
        logits, latents = heads(p, h[None])
        all_logits, all_latents = [logits[0]], [latents[0]]
        i32 = dict(dtype=torch.int32, device=device)
        for i, tok in enumerate(forced.tolist()):
            h = gpt_decode_step(p, g, torch.tensor([tok, 0], **i32), torch.tensor([1 + i, 0], **i32),
                                torch.tensor([length + i, 0], **i32), cache)
            logits, latents = heads(p, h)
            all_logits.append(logits[0])
            all_latents.append(latents[0])
        out[device.type] = (torch.stack(all_logits).float().cpu(),
                            torch.stack(all_latents).float().cpu())
        say(f"  {device.type}: prefill {length} rows + {len(forced)} decode steps in "
            f"{time.perf_counter() - t0:.1f} s")
        del engine, params, core, p, cache
    (lg, zg), (lc, zc) = out["cuda"], out["cpu"]
    snr_logits, snr_latents = snr_db(lc, lg), snr_db(zc, zg)
    top2 = lc.topk(2, dim=-1).values
    margin = 4 * (lg - lc).square().mean().sqrt().item()
    decisive = (top2[:, 0] - top2[:, 1]) > margin
    flips = (decisive & (lc.argmax(-1) != lg.argmax(-1))).nonzero().flatten().tolist()
    say(f"  logits SNR {snr_logits:.1f} dB, latents SNR {snr_latents:.1f} dB (bound 25); "
        f"{int(decisive.sum())} of {len(lc)} steps decisive (top-2 margin > {margin:.4f}), "
        f"greedy flips on them: {flips}")
    if not (snr_logits > 25.0 and snr_latents > 25.0 and int(decisive.sum()) >= 8 and not flips):
        raise AssertionError("int8 reference check failed")

# -------------------------------------------------------------- concurrency
CONC_SLOTS = 16  # phase 4e's decode slots: quarter and half buckets 4 and 8
PR1_INSERT_MS = 26.7  # one bucket-128 single insert in PR 1's proof run (PERF.md)
GREEDY = (1.0, 1.0, 1, 5.0, False, 0)  # temperature, top_p, top_k, rep. penalty, do_sample, cap
BUCKET, N_IDS = 128, (40, 90)  # phase 4e's prompts: prefill bucket, text ids per prompt


def conc_prompts(g, dev, n: int, seed: int) -> list:
    """`n` TokenPrompts in prefill bucket BUCKET: cond [32, 1024] f32 on the
    card (0.3 randn, a perceiver output's scale) and N_IDS text ids."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cond = (0.3 * rng.standard_normal((g.num_cond_latents, g.hidden_size))).astype(np.float32)
        ids = rng.integers(5, g.number_text_tokens - 1, int(rng.integers(*N_IDS)))
        out.append(TokenPrompt(cond=torch.from_numpy(cond).to(dev), ids=ids.astype(np.int64)))
    return out


def burst_args(g, dev, prompts) -> tuple:
    """(cond [K, C, D], ids [K, BUCKET - C], n_ids [K]) on the card, as the
    runner's burst insert uploads them."""
    tb = BUCKET - g.num_cond_latents
    ids = np.zeros((len(prompts), tb), np.int64)
    for i, pr in enumerate(prompts):
        ids[i, : len(pr.ids)] = pr.ids
    return (torch.stack([pr.cond for pr in prompts]), torch.from_numpy(ids).to(dev),
            torch.tensor([len(pr.ids) for pr in prompts], device=dev))


def wall_ms(fn, reps: int = 3) -> float:
    """Median host wall time of fn() to the card's completion, ms."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def check_burst_inserts(engine, smi: str) -> None:
    """K = 2, 4 and 8 prompts of bucket 128 as one batched insert
    (insert_sequences_tokens: dense attention, as the JAX burst) and as K
    single inserts (K1), each on a fresh 16-slot state. Greedy first tokens
    must be equal wherever the single path's top-2 logit margin is decisive
    (above 4x the RMS difference of the two paths' logits); KV rows and
    first latents above 30 dB SNR between the paths. Timed as ms per chunk
    (host wall to the card's completion, median of 3)."""
    g, p, dev = engine.gpt_config, engine.params, engine.device
    single, batch = (init_decode_state(g, CONC_SLOTS, dtype=engine.cache_dtype, device=dev)
                     for _ in range(2))
    decisive_total = 0
    for k in (2, 4, 8):
        prompts = conc_prompts(g, dev, k, seed=40 + k)
        cond, ids, n_ids = burst_args(g, dev, prompts)
        n_list = n_ids.tolist()

        def run_batched():
            insert_sequences_tokens(p, g, batch, cond, ids, n_ids, list(range(k)), *GREEDY)

        def run_single():
            for i in range(k):
                insert_sequence_tokens(p, g, single, cond[i], ids[i], n_list[i], i, *GREEDY)

        ms_b, ms_s = wall_ms(run_batched) / k, wall_ms(run_single) / k
        # the two paths' logits for the margin: the batched prefill with every
        # lane a padding lane (no cache writes), the single one into the
        # scratch slot 15
        emb = [_assemble_prompt(p, g, cond[i], ids[i], n_list[i]).to(torch.bfloat16)
               for i in range(k)]
        lengths = [n + g.num_cond_latents + 1 for n in n_list]
        h_b = gpt_prefill_batched(p, g, torch.stack(emb), lengths, [CONC_SLOTS] * k, batch.cache)
        h_s = torch.stack([gpt_prefill(p, g, emb[i], lengths[i], CONC_SLOTS - 1, single.cache)
                           for i in range(k)])
        lb, ls = heads(p, h_b)[0].float(), heads(p, h_s)[0].float()
        margin = 4 * (lb - ls).square().mean().sqrt().item()
        top2 = ls.topk(2, dim=-1).values
        decisive = ((top2[:, 0] - top2[:, 1]) > margin).cpu()
        tok_b, tok_s = batch.tokens_buf[:k, 0].cpu(), single.tokens_buf[:k, 0].cpu()
        lane_flips = [i for i in range(k) if decisive[i] and tok_b[i] != tok_s[i]]
        decisive_total += int(decisive.sum())
        snr_k = min(snr_db(single.cache.k[:, :k, :BUCKET], batch.cache.k[:, :k, :BUCKET]),
                    snr_db(single.cache.v[:, :k, :BUCKET], batch.cache.v[:, :k, :BUCKET]))
        snr_lat = snr_db(single.latents_buf[:k, 0], batch.latents_buf[:k, 0])
        say(f"  burst K={k} at bucket {BUCKET}: batched {ms_b:.2f} ms per chunk, single "
            f"{ms_s:.2f} ms per chunk (PR 1's single insert: {PR1_INSERT_MS} ms); first tokens equal on "
            f"{int((tok_b == tok_s).sum())} of {k} lanes, {int(decisive.sum())} decisive (top-2 "
            f"margin > {margin:.4f}), flips on them {lane_flips}; KV rows {snr_k:.1f} dB, first "
            f"latents {snr_lat:.1f} dB (bound 30) ({smi})")
        if lane_flips or not (snr_k > 30.0 and snr_lat > 30.0):
            raise AssertionError(f"burst K={k}: flips {lane_flips}, SNR {snr_k} / {snr_lat} dB")
    if decisive_total < 7:
        raise AssertionError(f"bursts: only {decisive_total} of 14 first tokens decisive")


def block_profile(p, g, st, n_steps: int, slot_bound, kernel: str) -> dict:
    """One `n_steps` block of decode_steps_status at `slot_bound` plus its
    status copy, continuing `st`: host wall per step (median of 3 blocks),
    then one block under torch.profiler: device ms per step (sum of device
    event times), device ops and `kernel` ms per step, device busy share."""
    from torch.profiler import ProfilerActivity, profile

    def block():
        decode_steps_status(p, g, st, n_steps, slot_bound=slot_bound).cpu()

    block()  # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        block()
        walls.append((time.perf_counter() - t0) * 1e3 / n_steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        block()
        prof_wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    row = {"wall_ms_per_step": statistics.median(walls)}
    if events:
        row.update(device_ms_per_step=sum(e.time_range.elapsed_us() for e in events) / 1e3
                   / n_steps, ops_per_step=len(events) / n_steps,
                   kernel_ms_per_step=sum(e.time_range.elapsed_us() for e in events
                                          if kernel in e.name) / 1e3 / n_steps,
                   busy=busy_ms(events) / prof_wall)
    return row


def check_slot_bounds(engine, smi: str, kernel: str) -> None:
    """4 and then 8 live slots packed low on two fresh 16-slot states (one
    burst insert each), one 16-step greedy block at slot_bound = the live
    count on one and at full width on the other: the same tokens, latents
    above 40 dB SNR (bit-equal when the card's GEMMs take the same path at
    every row count). Then blocks timed at bound 4 (4 live), 8 and 16 (8
    live): wall, device ms and decode-kernel ms per step."""
    g, p, dev = engine.gpt_config, engine.params, engine.device
    dt = torch.int8 if g.kv_int8 else engine.cache_dtype
    for live in (4, 8):
        states = [init_decode_state(g, CONC_SLOTS, dtype=dt, device=dev) for _ in range(2)]
        cond, ids, n_ids = burst_args(g, dev, conc_prompts(g, dev, live, seed=60 + live))
        for st in states:
            insert_sequences_tokens(p, g, st, cond, ids, n_ids, list(range(live)), *GREEDY)
        decode_steps(p, g, states[0], 16, slot_bound=live)
        decode_steps(p, g, states[1], 16)
        a, b = states
        same = torch.equal(a.tokens_buf, b.tokens_buf) and torch.equal(a.n_generated,
                                                                        b.n_generated)
        lat_err = (a.latents_buf[:live, :17] - b.latents_buf[:live, :17]).abs().max().item()
        lat_snr = snr_db(b.latents_buf[:live, :17], a.latents_buf[:live, :17])
        say(f"  {live} live slots, 16 greedy steps: slot_bound={live} vs full width "
            f"{CONC_SLOTS}: tokens {'equal' if same else 'DIFFER'}, latents max_abs_err "
            f"{lat_err:.3e}, {lat_snr:.1f} dB (bound 40)")
        if not same or not lat_snr > 40.0:
            raise AssertionError(f"slot bound {live}: tokens equal {same}, latents {lat_snr} dB")
        bounds = (live,) if live == 4 else (live, None)
        for sb, st in zip(bounds, states):
            row = block_profile(p, g, st, 16, sb, kernel)
            dev_part = (f", device {row['device_ms_per_step']:.3f} ms per step in "
                        f"{row['ops_per_step']:.0f} ops, {kernel} {row['kernel_ms_per_step']:.4f} "
                        f"ms, busy {row['busy']:.1%}" if "busy" in row
                        else "; the profiler saw no device events: device ms not measured")
            say(f"  block at slot_bound={sb or CONC_SLOTS} ({live} live): wall "
                f"{row['wall_ms_per_step']:.3f} ms per step{dev_part} ({smi})")
        del states, a, b


def check_migration(engine) -> None:
    """migrate_slot 13 -> 2 on a fresh state after a greedy insert into 13
    and 16 decode steps: every field of slot 13 (KV rows, int8 scales where
    present, sampling rows and seen mask, counters, token and latent rows)
    lands in slot 2 bit for bit; slot 13 keeps all but active, done and
    n_generated, which are cleared."""
    g, p, dev = engine.gpt_config, engine.params, engine.device
    dt = torch.int8 if g.kv_int8 else engine.cache_dtype
    st = init_decode_state(g, CONC_SLOTS, dtype=dt, device=dev)
    pr = conc_prompts(g, dev, 1, seed=70)[0]
    cond, ids, n_ids = burst_args(g, dev, [pr])
    insert_sequence_tokens(p, g, st, cond[0], ids[0], int(n_ids[0]), 13, 0.75, 0.85, 50, 5.0,
                           True, 300)
    decode_steps(p, g, st, 16)
    cache = [t for t in (st.cache.k, st.cache.v, st.cache.k_scale, st.cache.v_scale)
             if t is not None]
    rows = [*st.sampling.tensors(), st.seq_lens, st.audio_pos, st.last_token, st.active, st.done,
            st.tokens_buf, st.latents_buf, st.n_generated]
    want_cache = [t[:, 13].clone() for t in cache]
    want_rows = [t[13].clone() for t in rows]
    migrate_slot(st, 13, 2)
    torch.cuda.synchronize()
    moved = (all(torch.equal(t[:, 2], w) for t, w in zip(cache, want_cache))
             and all(torch.equal(t[2], w) for t, w in zip(rows, want_rows)))
    cleared = not st.active[13] and not st.done[13] and int(st.n_generated[13]) == 0
    cleared_rows = (st.active, st.done, st.n_generated)
    kept = (all(torch.equal(t[:, 13], w) for t, w in zip(cache, want_cache))
            and all(torch.equal(t[13], w) for t, w in zip(rows, want_rows)
                    if not any(t is c for c in cleared_rows)))
    say(f"  migrate_slot 13 -> 2 after {int(want_rows[-1])} tokens: {len(cache)} cache tensors "
        f"and {len(rows)} per-slot tensors moved bit for bit: {moved}; source cleared: {cleared}; "
        f"source's other rows kept: {kept}")
    if not (moved and cleared and kept):
        raise AssertionError("migrate_slot did not move every field or clear the source")


# (the two long chunks' caps and the last late one's were halved from 605,
# 500 and 300 to hold the whole run's length once phase 4f was added)
RUNNER_CAPS = [32, 64, 96, 128, 160, 48, 80, 112, 40, 72, 300, 250]  # slots 0-11 (10, 11 long)
RUNNER_LATE_CAPS = [56, 88, 120, 200]  # submitted during the fourth block


async def drive_runner(de, prompts, options) -> tuple[list, float]:
    """12 chunks at once, 4 more once the runner is inside its fourth block
    (50 ms after the third was dispatched; a block takes far longer), every
    future awaited. Returns ([(tokens, latents [n, D], n)], wall s)."""
    t0 = time.perf_counter()
    tasks = [asyncio.ensure_future(de.generate(pr, o)) for pr, o in zip(prompts[:12], options)]
    while de.stats["blocks"] < 3:
        await asyncio.sleep(0.001)
    await asyncio.sleep(0.05)
    tasks += [asyncio.ensure_future(de.generate(pr, o))
              for pr, o in zip(prompts[12:], options[12:])]
    done = await asyncio.wait_for(asyncio.gather(*tasks), 900)
    wall = time.perf_counter() - t0
    await de.shutdown()
    return [(np.asarray(t), row[:n].float().cpu(), n) for t, row, n in done], wall


def check_runner(engine, smi: str, must_launch: tuple, facade_wav: str | None) -> dict:
    """The runner end to end: DecodeEngine (the engine's own, slot
    bucketing on) driven with greedy TokenPrompts whose max_new_tokens
    spread over 32-300 (a chunk may stop earlier at the stop token), so
    slots finish apart and strand high survivors;
    then the same traffic through a DecodeEngine without bucketing on the
    same params, which must give the same tokens and n (latents above 40 dB,
    bit-equal when every GEMM row count takes the same path). Every future
    resolves; batched inserts, migrations and blocks below full width are
    counted. With `facade_wav`, one TTS-facade request whose text splits
    into >= 8 chunks follows and must reach the batched insert. Kernel
    launch counts are zeroed before the bucketed drive and read after the
    facade request: returns them."""
    g, dev = engine.gpt_config, engine.device
    prompts = conc_prompts(g, dev, 16, seed=80)
    options = [SamplingOptions(do_sample=False, max_new_tokens=c)
               for c in RUNNER_CAPS + RUNNER_LATE_CAPS]
    de = engine.decode_engine
    de.reset_stats()
    for w in KERNELS.values():
        w["wrapper"].launches = 0
    got, wall = asyncio.run(drive_runner(de, prompts, options))
    st = dict(de.stats)
    audio_s = sum(n for *_, n in got) * 1024 / 22050
    say(f"  runner, slot bucketing on, {CONC_SLOTS} slots: 16 chunks ({sum(n for *_, n in got)} "
        f"tokens, {audio_s:.2f} s of audio) in {wall:.2f} s wall, summed audio/wall "
        f"{audio_s / wall:.2f}; blocks {st['blocks']} ({st['slot_bound_blocks']} below full "
        f"width), inserts {st['inserts']} in {st['insert_batches']} batched prefills + singles, "
        f"migrations {st['migrations']}; dispatch_s {st['dispatch_s']:.3f}, status_wait_s "
        f"{st['status_wait_s']:.4f}, insert_s {st['insert_s']:.3f} (upload "
        f"{st['insert_upload_s']:.4f}, dispatch {st['insert_dispatch_s']:.3f}), harvest_s "
        f"{st['harvest_s']:.4f} ({smi})")
    caps = RUNNER_CAPS + RUNNER_LATE_CAPS
    if not all(1 <= n <= cap for (*_, n), cap in zip(got, caps)):
        raise AssertionError(f"runner: chunk lengths {[n for *_, n in got]} outside caps {caps}")
    if not (st["insert_batches"] > 0 and st["migrations"] > 0 and st["slot_bound_blocks"] > 0):
        raise AssertionError(f"runner: stats {st}")
    if facade_wav is not None:
        batches = de.stats["insert_batches"]
        text = " ".join(f"Sentence number {i} of this request is long enough that the splitter "
                        f"gives it a chunk of its own, since two of them together run past the "
                        f"limit of two hundred and fifty characters for English text." for i in
                        range(9))
        n_chunks = len(engine.tokenizer.encode_with_split(text, "en"))
        tts = TTS(scheduler_max_concurrency=4).with_engine(engine)
        t0 = time.perf_counter()
        o = tts.generate_speech(TTSRequest(text=text, speaker_files=[facade_wav], language="en",
                                           max_new_tokens=48))
        torch.cuda.synchronize()
        f_wall = time.perf_counter() - t0
        tts.loop.run_until_complete(tts.shutdown())
        check_waveform("facade request", o)
        new_batches = de.stats["insert_batches"] - batches
        say(f"  facade request: {n_chunks} chunks, {o.array.size / o.sample_rate:.2f} s audio "
            f"(48-token cap per chunk) in {f_wall:.2f} s wall; batched prefills {new_batches} "
            f"({smi})")
        if n_chunks < 8 or new_batches < 1:
            raise AssertionError(f"facade request: {n_chunks} chunks, {new_batches} batches")
    launches = {name: w["wrapper"].launches for name, w in KERNELS.items()}
    say(f"  launches during the runner drive{' and the facade request' if facade_wav else ''}: "
        f"{launches}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by phase 4e's main path")
    plain = DecodeEngine(engine.params, g, num_slots=CONC_SLOTS, cache_dtype=engine.cache_dtype,
                         steps_per_sync=de.steps_per_sync, device=dev)
    want, wall_u = asyncio.run(drive_runner(plain, prompts, options))
    lat_snr = min(snr_db(w[1], a[1]) for w, a in zip(want, got))
    same = all(np.array_equal(w[0], a[0]) and w[2] == a[2] for w, a in zip(want, got))
    bit_equal = all(torch.equal(w[1], a[1]) for w, a in zip(want, got))
    say(f"  the same traffic without slot bucketing: {wall_u:.2f} s wall, {plain.stats['blocks']} "
        f"blocks, 0 migrations; tokens {'equal' if same else 'DIFFER'} on all 16 chunks, latents "
        f"worst {lat_snr:.1f} dB (bound 40), bit-equal {bit_equal} ({smi})")
    if not same or not lat_snr > 40.0:
        raise AssertionError(f"runner: bucketed results differ from unbucketed ({lat_snr} dB)")
    del plain
    return launches


def check_policy(engine, smi: str) -> None:
    """The dense int8 body (kv_int8, no K4) run by a DecodeEngine given the
    engine's w8a8_policy(): 6 greedy chunks of 24-64 tokens. Prints the
    program _cfg_for picks at every (length bound, slot bound) pair and the
    programs the blocks ran; at least two programs must appear."""
    g = dataclasses.replace(engine.gpt_config, ragged_decode=False, decode_w8a8=False)
    de = DecodeEngine(engine.params, g, num_slots=CONC_SLOTS, slot_bucketing=True,
                      w8a8_policy=engine.w8a8_policy(), device=engine.device)
    names = {(False, False): "bf16 weights", (True, True): "W8A8 + bf16 probabilities",
             (True, False): "W8A8"}

    def name(c):
        return names[(c.decode_w8a8, c.decode_attn_fp)]

    table = {f"len={lb} slots={sb or CONC_SLOTS}": name(de._cfg_for(lb, sb))
             for lb in (*de.LEN_BUCKETS, None) for sb in (*de._slot_buckets(), None)}
    ran = []
    pick = de._cfg_for
    de._cfg_for = lambda lb, sb: ran.append(name(pick(lb, sb))) or pick(lb, sb)
    caps = [24, 32, 48, 40, 64, 56]
    prompts = conc_prompts(g, engine.device, len(caps), seed=90)

    async def go():
        out = await asyncio.gather(*(de.generate(pr, SamplingOptions(do_sample=False,
                                                                     max_new_tokens=c))
                                     for pr, c in zip(prompts, caps)))
        await de.shutdown()
        return out

    got = asyncio.run(go())
    say(f"  W8A8 policy (KV bytes < 3 x weight bytes, the TPU fit) over (len bound, slot "
        f"bound): {table}")
    say(f"  dense int8 body under the policy: {len(got)} chunks of {[n for *_, n in got]} "
        f"tokens, blocks ran {dict((k, ran.count(k)) for k in set(ran))} ({smi})")
    if not all(1 <= n <= c for (*_, n), c in zip(got, caps)) or len(set(table.values())) < 2:
        raise AssertionError(f"policy run: lengths {[n for *_, n in got]}, programs {table}")


def run_concurrency(dev, smi: str, tokenizer) -> dict:
    """Phase 4e: the runner at concurrency, full width, 16 slots, slot
    bucketing on; bf16 first (K1, K2, K3), then int8 (K1, K4, K3) and the
    per-program W8A8 policy. Returns the launches of its main-path drives."""
    launches = {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_voice(tmp)
        for tag, gpt_flags, engine_flags, must, kernel in (
                ("bf16", {"flash_decode": True, "prefill_flash": True}, {}, BF16_PATH,
                 "flash_decode_split_kernel"),
                ("int8", {"prefill_flash": True, "ragged_decode": True},
                 {"kv_int8": True, "decode_w8a8": True, "prefill_w8a8": True},
                 ("ragged_decode",), "ragged_decode_split_kernel")):
            torch.cuda.empty_cache()
            say(f"  -- {tag} configuration")
            engine = build_engine(dev, tokenizer, gpt_flags,
                                  {**engine_flags, "slot_bucketing": True},
                                  decode_slots=CONC_SLOTS)
            if tag == "bf16":
                check_burst_inserts(engine, smi)
            check_slot_bounds(engine, smi, kernel)
            if tag == "bf16":
                check_migration(engine)
            counts = check_runner(engine, smi, must, wav_path if tag == "bf16" else None)
            for name in KERNELS:
                launches[name] += counts[name]
            if tag == "int8":
                check_policy(engine, smi)
            del engine
    return launches


# ---------------------------------------------------------------- streaming
# bench.py's TTFA traffic: SENTENCE * 4 per request (two chunks), 8 at once
SENTENCE = ("the quick brown fox jumps over the lazy dog while voice cloning "
            "speech synthesis runs on tensor processing hardware. ")
STREAM_CONCURRENCY = 8
STREAM_SLOTS = 16  # every chunk of the 8 requests holds a slot at once
STREAM_CAP = 120  # tokens per chunk in phase 4f's sampled requests
# the engine's tracing spans on the way to the first segment: a chunk's wait
# for a slot, a young block from issue to its status, the wait for the
# first snapshot, a first-segment vocode batch
TTFA_SPANS = ("decode.queue_wait", "decode.young_block", "phase2.first_snapshot_wait",
              "vocode.seg_first_device", "phase1.tokenize")


def pcm_diff(got: np.ndarray, want: np.ndarray) -> tuple[int, float]:
    """(largest difference in 16-bit PCM steps, share of samples that
    differ) of two waveforms the engine shipped as 16-bit PCM."""
    if got.shape != want.shape:
        return 1 << 30, 1.0
    d = np.abs(np.round(got * 32767).astype(np.int64) - np.round(want * 32767).astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def record_batches(engine) -> list:
    """Wrap the engine's vocode batcher so every batch it runs is recorded
    as (kind, lanes); returns the list it appends to."""
    batcher, flights = engine._vocode_batcher, []
    run = batcher._run_batch

    def recording(kind, items):
        flights.append((kind, len(items)))
        return run(kind, items)

    batcher._run_batch = recording
    return flights


async def stream_ttfa(tts, request, close_after_first: bool) -> tuple[float, int, float]:
    """One streaming request through the facade: (seconds to its first
    segment, segments consumed, seconds of audio consumed); closed after the
    first segment when asked."""
    t0 = time.perf_counter()
    agen = await tts.generate_speech_async(request)
    ttfa, n_seg, samples = float("nan"), 0, 0
    try:
        async for seg in agen:
            if n_seg == 0:
                ttfa = time.perf_counter() - t0
            n_seg += 1
            samples += seg.array.size
            check_waveform("stream segment", seg)
            if close_after_first:
                break
    finally:
        await agen.aclose()
    return ttfa, n_seg, samples / 24000


async def greedy_stream(engine, wav_path: str, text: str, max_new: int) -> tuple:
    """One greedy streaming chunk through the engine's phase-1/phase-2 API,
    consumed whole: (segments, final latent row, n, d-vector)."""
    req = TTSRequest(text=text, speaker_files=[wav_path], language="en", do_sample=False,
                     max_new_tokens=max_new, stream=True)
    handles, _, spk, _ = await engine.get_generation_context(req)
    segs = [seg.array async for seg in engine.process_tokens_to_speech(
        handles[0], speaker_embeddings=spk, request=req)]
    _, row, n = handles[0][0].result()
    return segs, row, n, spk


def run_streaming(dev, smi: str, tokenizer) -> dict:
    """Phase 4f: streaming on the bf16 configuration of phase 4, with 16
    slots so that every chunk of the 8 requests holds one (phase 4's 8 would
    queue half of them behind the others). Returns the kernel launches of
    the drive. (The int8 stream runs on phase 4b's engine, in run_slice.)"""
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_voice(tmp)
        torch.cuda.empty_cache()
        engine = build_engine(dev, tokenizer, {"flash_decode": True, "prefill_flash": True}, {},
                              decode_slots=STREAM_SLOTS)
        flights = record_batches(engine)
        tts = TTS(scheduler_max_concurrency=STREAM_CONCURRENCY).with_engine(engine)

        def request():
            return TTSRequest(text=SENTENCE * 4, speaker_files=[wav_path], language="en",
                              stream=True, max_new_tokens=STREAM_CAP)

        for w in KERNELS.values():
            w["wrapper"].launches = 0
        solo = tts.loop.run_until_complete(stream_ttfa(tts, request(), False))
        say(f"  solo stream: first segment {solo[0] * 1e3:.1f} ms, {solo[1]} segments, "
            f"{solo[2]:.2f} s audio ({smi})")
        del flights[:]

        async def burst():
            # stream 0 is consumed whole, the others closed after their
            # first segment
            return await asyncio.gather(*(stream_ttfa(tts, request(), i > 0)
                                          for i in range(STREAM_CONCURRENCY)))

        profile_summary(reset=True)
        t0 = time.perf_counter()
        outs = tts.loop.run_until_complete(burst())
        wall = time.perf_counter() - t0
        spans = profile_summary(reset=True)
        ttfas = sorted(o[0] for o in outs)
        p50 = ttfas[len(ttfas) // 2]
        p95 = ttfas[min(len(ttfas) - 1, int(len(ttfas) * 0.95))]
        sf = [k for kind, k in flights if kind == "seg_first"]
        say(f"  TTFA at concurrency {STREAM_CONCURRENCY} (SENTENCE x 4, {STREAM_CAP}-token cap "
            f"per chunk, sampled): p50 {p50 * 1e3:.1f} ms, p95 {p95 * 1e3:.1f} ms, all "
            f"{', '.join(f'{t * 1e3:.1f}' for t in ttfas)} ms; speculative first segments "
            f"{sum(sf)} in seg_first batches of {sf}; other batches "
            f"{[f for f in flights if f[0] != 'seg_first']}; stream 0: {outs[0][1]} segments, "
            f"{outs[0][2]:.2f} s audio; {wall:.2f} s wall ({smi})")
        say("  where the burst's time went (host spans, mean / max ms x count): " + "; ".join(
            f"{k} {v['mean_ms']:.1f} / {v['max_ms']:.1f} x {v['count']}"
            for k, v in sorted(spans.items()) if k in TTFA_SPANS))
        if not all(o[1] >= 1 for o in outs) or outs[0][1] < 2:
            raise AssertionError(f"streams: segments {[o[1] for o in outs]}")
        de = engine.decode_engine

        async def drained():
            t_end = time.perf_counter() + 30
            while de.num_active or de._queue:
                if time.perf_counter() > t_end:
                    raise AssertionError(f"abandoned streams: {de.num_active} slots still live")
                await asyncio.sleep(0.01)

        tts.loop.run_until_complete(drained())
        say(f"  abandonment: {STREAM_CONCURRENCY - 1} streams closed after their first segment; "
            f"num_active back to 0")

        segs, row, n, spk = tts.loop.run_until_complete(
            greedy_stream(engine, wav_path, "Hello world, this is a test of speech.", 200))
        streamed = np.concatenate(segs)
        full = engine.vocode_device_row(row, n, spk)
        s_max, s_share = pcm_diff(streamed, full)
        say(f"  greedy stream after the abandonment: {len(segs)} segments, {n} tokens, "
            f"{streamed.size} samples; against vocode_device_row of its final row: largest "
            f"difference {s_max} PCM steps, {s_share:.4%} of samples differ")
        gen = torch.Generator(device=dev).manual_seed(12)
        others = [torch.randn(row.shape, generator=gen, device=dev) for _ in range(3)]
        batch = engine._vocode_rows(torch.stack([row] + others), [n, 40, 150, 96], [spk] * 4)
        b_max, b_share = pcm_diff(batch[0], full)
        say(f"  the row in a batch of 4 (n = {n}, 40, 150, 96) against alone: largest "
            f"difference {b_max} PCM steps, {b_share:.4%} of samples differ")
        if len(segs) < 2 or s_max or b_max:
            raise AssertionError(f"streaming exactness: {len(segs)} segments, stream "
                                 f"{s_max} steps, batch {b_max} steps")

        t0 = time.perf_counter()
        tts.warmup(text="Hello world, this is a test of speech. The quick brown fox jumps "
                        "over the lazy dog.")
        say(f"  TTS.warmup (two sentences) completed in {time.perf_counter() - t0:.1f} s ({smi})")
        bf16 = {name: w["wrapper"].launches for name, w in KERNELS.items()}
        tts.loop.run_until_complete(tts.shutdown())
        del tts, engine
    say(f"  launches during the bf16 streaming drive: {bf16}")
    for name in BF16_PATH:
        if bf16[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by phase 4f's bf16 drive")
    return bf16


# ------------------------------------------------------ checkpoint and server
# A Coqui-style state from seeded numpy weights: the JAX-free inverse of the
# loaders (a copy of tests/helpers.py's, which imports the JAX package;
# tests/test_torch_checkpoint.py holds the two equal).
def export_coqui_state(gpt_params: dict, core: dict) -> dict:
    """Invert the weight-loader transforms (weights.py:load_gpt_params /
    load_core_params) to synthesize a Coqui-style flat state dict with the
    original checkpoint's key names and torch tensor layouts. Used by the
    golden round-trip test: random params -> Coqui .pth ->
    convert_coqui_checkpoint -> from_pretrained must reproduce the params
    bit-exactly (BN rows are emitted with mean=0 / var=1-eps so folding is
    the identity)."""
    st: dict = {}

    def P(key, value):
        st[key] = np.ascontiguousarray(np.asarray(value, np.float32))

    def bn(prefix, scale, shift):
        P(f"{prefix}.weight", scale)
        P(f"{prefix}.bias", shift)
        P(f"{prefix}.running_mean", np.zeros_like(np.asarray(scale)))
        P(f"{prefix}.running_var", np.full_like(np.asarray(scale, np.float64), 1.0 - 1e-5))

    inv1d = lambda w: np.transpose(np.asarray(w), (2, 1, 0))  # [K,I,O]->[O,I,K]
    invT1d = lambda w: np.transpose(np.asarray(w), (1, 2, 0))[:, :, ::-1]  # ->[I,O,K]
    inv2d = lambda w: np.transpose(np.asarray(w), (3, 2, 0, 1))  # [kh,kw,I,O]->[O,I,kh,kw]

    g = gpt_params
    P("gpt.mel_embedding.weight", g["wte"])
    P("gpt.mel_pos_embedding.emb.weight", g["wpe"])
    P("gpt.text_embedding.weight", g["text_wte"])
    P("gpt.text_pos_embedding.emb.weight", g["text_wpe"])
    P("gpt.mel_head.weight", np.asarray(g["mel_head_w"]).T)
    P("gpt.mel_head.bias", g["mel_head_b"])
    P("gpt.final_norm.weight", g["final_norm_scale"])
    P("gpt.final_norm.bias", g["final_norm_bias"])
    P("gpt.gpt.ln_f.weight", g["ln_f_scale"])
    P("gpt.gpt.ln_f.bias", g["ln_f_bias"])
    block_names = [
        ("ln_1.weight", "ln1_scale"), ("ln_1.bias", "ln1_bias"),
        ("attn.c_attn.weight", "attn_w"), ("attn.c_attn.bias", "attn_b"),
        ("attn.c_proj.weight", "attn_proj_w"), ("attn.c_proj.bias", "attn_proj_b"),
        ("ln_2.weight", "ln2_scale"), ("ln_2.bias", "ln2_bias"),
        ("mlp.c_fc.weight", "fc_w"), ("mlp.c_fc.bias", "fc_b"),
        ("mlp.c_proj.weight", "fc_proj_w"), ("mlp.c_proj.bias", "fc_proj_b"),
    ]
    n_layers = np.asarray(g["blocks"]["ln1_scale"]).shape[0]
    for i in range(n_layers):
        for torch_name, jax_name in block_names:
            P(f"gpt.gpt.h.{i}.{torch_name}", np.asarray(g["blocks"][jax_name])[i])

    ce = core["cond_encoder"]
    P("gpt.conditioning_encoder.init.weight", np.asarray(ce["init_w"]).T[:, :, None])
    P("gpt.conditioning_encoder.init.bias", ce["init_b"])
    for i, b in enumerate(ce["blocks"]):
        p = f"gpt.conditioning_encoder.attn.{i}"
        P(f"{p}.norm.weight", b["norm_scale"])
        P(f"{p}.norm.bias", b["norm_bias"])
        P(f"{p}.qkv.weight", np.asarray(b["qkv_w"]).T[:, :, None])
        P(f"{p}.qkv.bias", b["qkv_b"])
        P(f"{p}.proj_out.weight", np.asarray(b["proj_w"]).T[:, :, None])
        P(f"{p}.proj_out.bias", b["proj_b"])

    pv = core["perceiver"]
    P("gpt.conditioning_perceiver.latents", pv["latents"])
    P("gpt.conditioning_perceiver.norm.gamma", pv["norm_gamma"])
    for i, l in enumerate(pv["layers"]):
        p = f"gpt.conditioning_perceiver.layers.{i}"
        P(f"{p}.0.to_q.weight", np.asarray(l["attn"]["to_q"]).T)
        P(f"{p}.0.to_kv.weight", np.asarray(l["attn"]["to_kv"]).T)
        P(f"{p}.0.to_out.weight", np.asarray(l["attn"]["to_out"]).T)
        P(f"{p}.1.0.weight", np.asarray(l["ff"]["w1"]).T)
        P(f"{p}.1.0.bias", l["ff"]["b1"])
        P(f"{p}.1.2.weight", np.asarray(l["ff"]["w2"]).T)
        P(f"{p}.1.2.bias", l["ff"]["b2"])

    se = core["speaker_encoder"]
    sp = "hifigan_decoder.speaker_encoder"
    P(f"{sp}.conv1.weight", inv2d(se["conv1_w"]))
    P(f"{sp}.conv1.bias", se["conv1_b"])
    bn(f"{sp}.bn1", se["bn1_scale"], se["bn1_shift"])
    P(f"{sp}.attention.0.weight", np.asarray(se["att1_w"]).T[:, :, None])
    P(f"{sp}.attention.0.bias", se["att1_b"])
    bn(f"{sp}.attention.2", se["att_bn_scale"], se["att_bn_shift"])
    P(f"{sp}.attention.3.weight", np.asarray(se["att2_w"]).T[:, :, None])
    P(f"{sp}.attention.3.bias", se["att2_b"])
    P(f"{sp}.fc.weight", np.asarray(se["fc_w"]).T)
    P(f"{sp}.fc.bias", se["fc_b"])
    for li in range(1, 5):
        for j, blk in enumerate(se[f"layer{li}"]):
            p = f"{sp}.layer{li}.{j}"
            P(f"{p}.conv1.weight", inv2d(blk["conv1_w"]))
            bn(f"{p}.bn1", blk["bn1_scale"], blk["bn1_shift"])
            P(f"{p}.conv2.weight", inv2d(blk["conv2_w"]))
            bn(f"{p}.bn2", blk["bn2_scale"], blk["bn2_shift"])
            P(f"{p}.se.fc.0.weight", np.asarray(blk["se"]["fc1_w"]).T)
            P(f"{p}.se.fc.0.bias", blk["se"]["fc1_b"])
            P(f"{p}.se.fc.2.weight", np.asarray(blk["se"]["fc2_w"]).T)
            P(f"{p}.se.fc.2.bias", blk["se"]["fc2_b"])
            if "down_w" in blk:
                P(f"{p}.downsample.0.weight", inv2d(blk["down_w"]))
                bn(f"{p}.downsample.1", blk["down_bn_scale"], blk["down_bn_shift"])

    hg = core["hifigan"]
    hp = "hifigan_decoder.waveform_decoder"
    P(f"{hp}.conv_pre.weight", inv1d(hg["conv_pre_w"]))
    P(f"{hp}.conv_pre.bias", hg["conv_pre_b"])
    P(f"{hp}.cond_layer.weight", np.asarray(hg["cond_w"]).T[:, :, None])
    P(f"{hp}.cond_layer.bias", hg["cond_b"])
    for i, u in enumerate(hg["ups"]):
        P(f"{hp}.ups.{i}.weight", invT1d(u["w"]))
        P(f"{hp}.ups.{i}.bias", u["b"])
    for i, c in enumerate(hg["conds"]):
        P(f"{hp}.conds.{i}.weight", np.asarray(c["w"]).T[:, :, None])
        P(f"{hp}.conds.{i}.bias", c["b"])
    for i, r in enumerate(hg["resblocks"]):
        for group in ("convs1", "convs2"):
            for j, cv in enumerate(r[group]):
                P(f"{hp}.resblocks.{i}.{group}.{j}.weight", inv1d(cv["w"]))
                P(f"{hp}.resblocks.{i}.{group}.{j}.bias", cv["b"])
    P(f"{hp}.conv_post.weight", inv1d(hg["conv_post_w"]))
    P("mel_stats", core["mel_stats"])
    return st


def leaf_pairs(got, want, path: str):
    """(path, got leaf, want leaf) over two pytrees of one structure; a key
    or length that differs raises."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"round trip: {path} keys differ")
        for k in want:
            yield from leaf_pairs(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"round trip: {path} lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            yield from leaf_pairs(g, w, f"{path}[{i}]")
    else:
        yield path, got, want


def check_round_trip(gpt: dict, core: dict, gpt_np: dict, core_np: dict) -> int:
    """The loaders' trees (load_gpt_params / load_core_params of the
    converted artifacts) against the numpy trees the state was exported
    from: every leaf f32 and bit-equal. The text embeddings and the final
    norm travel through the core artifact. Returns the leaves compared."""
    pairs = [*leaf_pairs(gpt, {k: v for k, v in gpt_np.items()
                               if k not in ("text_wte", "text_wpe")}, "gpt"),
             *leaf_pairs({k: core[k] for k in core_np}, core_np, "core"),
             *((f"core.{k}", core[k], gpt_np[k])
               for k in ("text_wte", "text_wpe", "final_norm_scale", "final_norm_bias"))]
    for path, g, w in pairs:
        if not (isinstance(g, np.ndarray) and g.dtype == np.float32 and g.shape == w.shape
                and np.array_equal(g, w)):
            raise AssertionError(f"round trip: {path} is not bit-equal to its source")
    return len(pairs)


SERVER_TOKENS = 100  # max_new_tokens of each phase-6 request
CLI_TOKENS = 60  # the CLI boot's one short request
INT8_CONFIG = {"kv_int8": True, "ragged_decode": True, "prefill_flash": True,
               "decode_w8a8": True, "prefill_w8a8": True, "flash_decode": False}


def mib(path: str) -> str:
    return f"{os.path.getsize(path) / 2**20:.1f} MiB"


def set_gpt_flags(root: str, flags: dict) -> None:
    path = os.path.join(root, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["gpt_config"].update(flags)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)


def decode_audio(fmt: str, body: bytes) -> np.ndarray:
    """A response body as finite 24 kHz samples (wav, flac or s16le PCM)."""
    from auralis_tpu_torch.common import native_audio

    if fmt == "flac":
        if body[:4] != b"fLaC":
            raise AssertionError("flac response without the fLaC magic")
        audio, sr = native_audio.flac_decode(bytes(body))
    elif fmt == "pcm":
        audio, sr = np.frombuffer(body, dtype="<i2").astype(np.float32) / 32767, 24000
    else:
        audio, sr = audio_io.read_wav(body)
    audio = np.asarray(audio)
    if not (sr == 24000 and audio.size > 0 and np.isfinite(audio).all()):
        raise AssertionError(f"{fmt} response: sr={sr}, {audio.size} samples, "
                             f"finite={np.isfinite(audio).all()}")
    return audio


def speech_body(text: str, voice, fmt: str = "wav", max_new: int = SERVER_TOKENS, **kw) -> dict:
    return {"input": text, "model": "xttsv2", "voice": voice, "response_format": fmt,
            "language": "en", "max_new_tokens": max_new, **kw}


async def post_speech(session, url: str, body: dict) -> tuple[np.ndarray, float]:
    """One buffered /v1/audio/speech: (samples, wall seconds)."""
    t0 = time.perf_counter()
    async with session.post(f"{url}/v1/audio/speech", json=body) as resp:
        payload = await resp.read()
        if resp.status != 200:
            raise AssertionError(f"/v1/audio/speech {body['response_format']}: HTTP "
                                 f"{resp.status}: {payload[:300]!r}")
    return decode_audio(body["response_format"], payload), time.perf_counter() - t0


async def post_sse(session, url: str, body: dict) -> tuple[np.ndarray, float, float, int]:
    """One streamed /v1/audio/speech (stream_format "sse"): (samples, seconds
    to the first delta, wall seconds, deltas). The deltas must decode to
    24 kHz PCM and be followed by exactly one speech.audio.done."""
    t0 = time.perf_counter()
    first, events = float("nan"), []
    async with session.post(f"{url}/v1/audio/speech", json=body) as resp:
        if resp.status != 200 or not resp.headers["Content-Type"].startswith("text/event-stream"):
            raise AssertionError(f"SSE: HTTP {resp.status} {resp.headers.get('Content-Type')}: "
                                 f"{(await resp.read())[:300]!r}")
        async for raw in resp.content:
            line = raw.decode().strip()
            if not line.startswith("data:"):
                continue
            events.append(json.loads(line[len("data:"):]))
            if events[-1].get("type") == "speech.audio.delta" and math.isnan(first):
                first = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    deltas = [e for e in events if e.get("type") == "speech.audio.delta"]
    if not deltas or [e.get("type") for e in events[len(deltas):]] != ["speech.audio.done"] \
            or any(e["sample_rate"] != 24000 for e in deltas):
        raise AssertionError(f"SSE events: {[e.get('type') for e in events]}")
    pcm = b"".join(base64.b64decode(e["audio"]) for e in deltas)
    return decode_audio("pcm", pcm), first, wall, len(deltas)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def report(name: str, audio: np.ndarray, wall: float, smi: str) -> None:
    secs = audio.size / 24000
    say(f"  {name}: wall {wall:.2f} s, {secs:.2f} s audio, audio/wall {secs / wall:.2f} ({smi})")


def serve_in_process(args_list: list, smi: str, wav_path: str) -> None:
    """Boot the server in this process from the CLI's argv (the port's
    argparse, start_tts_engine, build_app), serve it with aiohttp on an
    ephemeral port of 127.0.0.1 and send real HTTP over the socket."""
    import aiohttp
    from aiohttp import web

    from auralis_tpu_torch.server.oai_server import (
        build_app,
        build_parser,
        scan_voices_dir,
        start_tts_engine,
    )

    args = build_parser().parse_args(args_list)
    t0 = time.perf_counter()
    tts = start_tts_engine(args)
    torch.cuda.synchronize()
    say(f"  in-process boot (TTS.from_pretrained through start_tts_engine): "
        f"{time.perf_counter() - t0:.1f} s; engine {tts.tts_engine.decode_slots} slots, "
        f"KV cache {tts.tts_engine.decode_engine.state.cache.k.dtype} ({smi})")
    app = build_app(tts, voices=scan_voices_dir(args.voices_dir))
    with open(wav_path, "rb") as f:
        voice_b64 = base64.b64encode(f.read()).decode()
    text1 = "Hello world, this is a test of speech."

    async def drive():
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        url = "http://127.0.0.1:%d" % runner.addresses[0][1]
        try:
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
                async with s.get(f"{url}/health") as r:
                    health = await r.json()
                if r.status != 200 or health != {"status": "ok", "engine_loaded": True}:
                    raise AssertionError(f"/health: {r.status} {health}")
                async with s.get(f"{url}/v1/voices") as r:
                    voices = await r.json()
                if voices != {"voices": ["alloy"]}:
                    raise AssertionError(f"/v1/voices: {voices}")
                audio, wall = await post_speech(s, url, speech_body(text1, [voice_b64]))
                report("wav", audio, wall, smi)
                (a1, w1), (a2, w2) = await asyncio.gather(
                    post_speech(s, url, speech_body("The quick brown fox jumps over the dog.",
                                                    [voice_b64])),
                    post_speech(s, url, speech_body("One two three four five six seven.",
                                                    "alloy", "flac")))
                report("concurrent wav", a1, w1, smi)
                report("concurrent flac (named voice)", a2, w2, smi)
                audio, first, wall, n = await post_sse(s, url, speech_body(
                    SENTENCE * 4, [voice_b64], stream_format="sse"))
                report(f"sse ({n} deltas, first after {first * 1e3:.1f} ms)", audio, wall, smi)
                async with s.get(f"{url}/metrics") as r:
                    text = await r.text()
            counters = {line.split()[0]: float(line.split()[1])
                        for line in text.splitlines() if line and not line.startswith("#")}
            say(f"  /metrics: {counters}")
            if not (counters["auralis_audio_chunks_total"] >= 5
                    and counters["auralis_audio_seconds_total"] > 0
                    and counters["auralis_decode_inserts_total"] >= 5
                    and counters["auralis_decode_slots"] == 8):
                raise AssertionError(f"/metrics: {counters}")
        finally:
            await runner.cleanup()  # the app's cleanup shuts the engine down

    asyncio.run(drive())
    del tts, app


def serve_cli(args_list: list, smi: str, tmp: str) -> None:
    """Boot `python -m auralis_tpu_torch.entrypoints.oai_server` in a
    subprocess, wait for /health, send one short request, then SIGINT: the
    server must exit with 0. The process is killed if anything fails."""
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    log_path = os.path.join(tmp, "cli_server.log")
    cmd = [sys.executable, "-m", "auralis_tpu_torch.entrypoints.oai_server", *args_list,
           "--host", "127.0.0.1", "--port", str(port)]
    say(f"  CLI: {' '.join(cmd[1:])}")
    with open(log_path, "wb") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"the CLI server exited with {proc.returncode} "
                                         "before /health answered")
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("the CLI server did not answer /health within 300 s")
                try:
                    with urllib.request.urlopen(f"{url}/health", timeout=5) as r:
                        if json.loads(r.read()).get("engine_loaded"):
                            break
                except OSError:
                    time.sleep(0.25)
            boot = time.perf_counter() - t0
            with open(os.path.join(tmp, "voice.wav"), "rb") as f:
                body = speech_body("Hello from the command line.",
                                   [base64.b64encode(f.read()).decode()], max_new=CLI_TOKENS)
            req = urllib.request.Request(f"{url}/v1/audio/speech", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                audio = decode_audio("wav", r.read())
            wall = time.perf_counter() - t1
            say(f"  CLI boot {boot:.1f} s (process start to the first healthy /health)")
            report("CLI wav (int8 config)", audio, wall, smi)
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
            if rc != 0:
                raise AssertionError(f"the CLI server exited with {rc} on SIGINT")
            say(f"  CLI server exited with {rc} on SIGINT")
        except BaseException:
            with open(log_path, "rb") as f:
                say("  CLI server log (tail):\n" + f.read()[-4000:].decode(errors="replace"))
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_checkpoint_server(smi: str, tokenizer) -> dict:
    """Phase 6: a full-width Coqui-style checkpoint from seeded random
    weights is converted by the port's CLI, loaded back bit-equal, and
    served over HTTP, in this process (bf16: K1, K2, K3) and by the CLI in a
    subprocess (int8: K1, K4, K3). Returns the kernel launches of the
    in-process server."""
    from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer
    from auralis_tpu_torch.models.xttsv2.weights import (
        find_artifact,
        load_core_params,
        load_gpt_params,
        load_safetensors,
    )

    if not isinstance(tokenizer, TTSTokenizer):
        raise AssertionError("phase 6 saves a tokenizer.json: it needs the `tokenizers` package")
    cfg = XTTSConfig()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gpt_np, core_np = random_init(cfg, seed=0)
        state = export_coqui_state(gpt_np, core_np)
        pth = os.path.join(tmp, "model.pth")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, pth)
        say(f"  export: {len(state)} tensors, {sum(v.nbytes for v in state.values()) / 2**30:.2f} "
            f"GiB f32, model.pth {mib(pth)}, {time.perf_counter() - t0:.1f} s")
        del state

        out = os.path.join(tmp, "converted")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "auralis_tpu_torch.entrypoints.convert_checkpoint", pth, out],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"convert_checkpoint exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        gpt_dir, core_dir = os.path.join(out, "gpt"), os.path.join(out, "core_xttsv2")
        gpt_file = str(find_artifact(gpt_dir, ("gpt2_model.safetensors",)))
        core_file = str(find_artifact(core_dir, ("xtts-v2.safetensors",)))
        say(f"  convert (CLI subprocess): {time.perf_counter() - t0:.1f} s; "
            f"gpt2_model.safetensors {mib(gpt_file)}, xtts-v2.safetensors {mib(core_file)}")
        os.remove(pth)
        with open(os.path.join(gpt_dir, "config.json")) as f:
            arch = json.load(f)
        for key in ("hidden_size", "num_hidden_layers", "num_attention_heads", "n_inner",
                    "num_audio_tokens", "start_audio_token", "stop_audio_token",
                    "max_audio_tokens"):
            if arch[key] != getattr(cfg.gpt, key):
                raise AssertionError(f"converted config: {key} {arch[key]} != "
                                     f"{getattr(cfg.gpt, key)}")

        t0 = time.perf_counter()
        gpt = load_gpt_params(load_safetensors(gpt_file), cfg.gpt)
        core = load_core_params(load_safetensors(core_file), cfg)
        t_load = time.perf_counter() - t0
        n = check_round_trip(gpt, core, gpt_np, core_np)
        say(f"  round trip: load_gpt_params + load_core_params {t_load:.1f} s; {n} leaves "
            f"bit-equal to the exported weights")
        del gpt, core, gpt_np, core_np

        tokenizer.save(os.path.join(gpt_dir, "tokenizer.json"))
        set_gpt_flags(core_dir, {"prefill_flash": True, "flash_decode": True})
        voices = os.path.join(tmp, "voices")
        os.makedirs(voices)
        wav_path = write_voice(tmp)
        shutil.copy(wav_path, os.path.join(voices, "alloy.wav"))

        for w in KERNELS.values():
            w["wrapper"].launches = 0
        serve_in_process(["--model", core_dir, "--gpt_model", gpt_dir, "--max_concurrency", "4",
                          "--decode_slots", "8", "--voices_dir", voices], smi, wav_path)
        launches = {name: w["wrapper"].launches for name, w in KERNELS.items()}
        say(f"  launches during the in-process server: {launches}")
        for name in BF16_PATH:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by phase 6's server")
        torch.cuda.empty_cache()

        int8_dir = os.path.join(tmp, "int8")
        os.makedirs(int8_dir)
        shutil.copy(os.path.join(core_dir, "config.json"), int8_dir)
        set_gpt_flags(int8_dir, INT8_CONFIG)
        os.symlink(core_file, os.path.join(int8_dir, "xtts-v2.safetensors"))
        serve_cli(["--model", int8_dir, "--gpt_model", gpt_dir, "--kv_int8",
                   "--max_concurrency", "2", "--decode_slots", "4"], smi, tmp)
    return launches


def write_voice(tmp: str) -> str:
    """A 6 s sine reference voice at 22.05 kHz."""
    sr = 22050
    tt = np.arange(sr * 6) / sr
    voice = 0.5 * np.sin(2 * np.pi * 220 * tt) * (0.8 + 0.2 * np.sin(2 * np.pi * 2 * tt))
    path = os.path.join(tmp, "voice.wav")
    audio_io.write_wav(path, voice.astype(np.float32), sr)
    return path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script has no CPU path", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    phase("[1] device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    say(f"  torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; "
        f"count {torch.cuda.device_count()}; nvidia-smi: {smi}")

    phase("[2] build")
    t0 = time.perf_counter()
    lib = _build.library()
    say(f"  kernels built/loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    say(f"  SASS: {sass_check(lib._name)}")
    for line in kernel_resource_usage(lib._name):
        say(f"  K2/K4/K5 resources: {line}")

    phase("[3] kernels vs plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"  plain side: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    results: dict = {}
    check_prefill(dev, results)
    check_decode(dev, results)
    check_mrf(dev, results)
    check_ragged(dev, results)
    check_fused_mlp(dev, results)
    torch.cuda.empty_cache()

    tokenizer = build_tokenizer(XTTSConfig().gpt.number_text_tokens)
    phase("[4] bf16 slice: full-width XTTSv2 on the TTS facade")
    # phase 4's requests are capped at 300 tokens (from the model's 605) to
    # hold the whole run's length with phase 4f
    bf16, _ = run_slice(dev, smi, tokenizer, {"flash_decode": True, "prefill_flash": True}, {},
                        BF16_PATH, "flash_decode_split_kernel", vocoder=True,
                        max_new_tokens=300)
    phase("[4b] int8 slice: int8 KV, W8A8 prefill and decode, ragged decode attention")
    # the int8 requests are capped at 200 tokens to hold the whole run's
    # length with phases 4e and 4f, and phase 4f's int8 stream (100 tokens)
    # runs on this engine
    int8, int8_stream = run_slice(
        dev, smi, tokenizer, {"prefill_flash": True, "ragged_decode": True},
        {"kv_int8": True, "decode_w8a8": True, "prefill_w8a8": True}, INT8_PATH,
        "ragged_decode_split_kernel", max_new_tokens=200, stream_tokens=100)
    phase("[4c] dense int8 decode body with W8A8 decode")
    run_dense_int8(dev, tokenizer)
    phase("[4d] K5 path: the int8 slice's decode MLPs through the fused W8A8 kernel")
    launches = {name: bf16[name] + int8[name] for name in KERNELS}
    launches["fused_mlp_w8"] = run_fused_mlp_path(dev)
    torch.cuda.empty_cache()
    phase("[4e] the runner at concurrency: burst inserts, slot bounds, migration, the pipelined "
        "runner, the W8A8 policy")
    conc = run_concurrency(dev, smi, tokenizer)
    for name in KERNELS:
        launches[name] += conc[name]
    torch.cuda.empty_cache()
    phase("[4f] streaming: TTFA at concurrency 8, abandonment, stream and batch exactness, "
        "warmup, int8")
    stream = run_streaming(dev, smi, tokenizer)
    for name in KERNELS:
        launches[name] += stream[name] + int8_stream[name]
    torch.cuda.empty_cache()
    phase("[5] reference check: card vs CPU, f32, greedy")
    run_reference_check(dev, tokenizer)
    phase("[5b] int8 reference check: card vs CPU, int8 KV + W8A8, teacher-forced")
    run_int8_reference_check(dev)
    torch.cuda.empty_cache()
    phase("[6] checkpoint and server: convert a full-width Coqui checkpoint, load it back, "
          "serve it over HTTP in-process (bf16) and from the CLI (int8)")
    served = run_checkpoint_server(smi, tokenizer)
    for name in KERNELS:
        launches[name] += served[name]

    # launches per main-path unit: one K1 per GPT layer per prompt insert,
    # one K2/K4 (and K5 on its path) per layer per decode step, one K3 per
    # conv of every MRF stage per vocoded chunk
    layers = XTTSConfig().gpt.num_hidden_layers
    per_unit = {"prefill_attention": (layers, "insert"),
                "flash_decode_append": (layers, "decode step"),
                "mrf_stage": (len(UPSAMPLE_RATES) * len(RESBLOCK_KERNELS) * 2
                              * len(RESBLOCK_DILATIONS), "vocoded chunk"),
                "ragged_decode": (layers, "decode step"),
                "fused_mlp_w8": (layers, "decode step")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": launches[name],
         **{key: results[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
         "launches_per_unit": per_unit[name][0], "unit": per_unit[name][1],
         **{key: v for key, v in results[name].items()
            if key not in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms")}}
        for name, k in KERNELS.items()
    ]}
    say(json.dumps(line))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
