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
    K1 takes its prompt length from device memory: it is checked with the
    length as an int32 on the card (what a captured insert passes; `ms`) and
    as an int (the wrapper writes it there; `ms_int_length`), bit-equal.
    K2 and K4 run at every write-position set of decode_bench.py (the
    ragged mix, split edges, all slots at 0, 127 and 1046), each launched
    twice (bit-equal ctx), and are timed cold (call i on layer i % 30, as
    a decode step reads them: `ms`) and hot (one layer, in L2: `ms_hot`),
    then on a slot-bounded step (the first 2 and 4 slots of the 8-slot
    cache: bit-equal to the full-width step's rows, slots beyond untouched);
    then the same checks and times at bench_torch's 64 slots (a [30, 64,
    1280, 1024] cache: a mixed write-position set and all slots at 1046);
    K5 the same over 30 layers' MLP weights in the serving layout, beside
    the serving chain's cold time (`serving_chain_ms`), with two launches
    bit-equal and its fc -> proj overlap kept in a CUDA graph (the
    captured graph's programmatic edge); K1 and K2 also at one model
    shard's shapes under tensor parallelism of 2 (8 heads);
 4. the bf16 slice: an XTTSv2Engine at the full XTTSConfig() width with
    seeded random bf16 weights and a bf16 KV cache behind the TTS facade
    answers three requests (one sync, two concurrent), each capped at 300
    tokens; every waveform must be finite 24 kHz audio, K1, K2 and K3
    must launch during the phase and captured programs must replay (the
    decode blocks and vocoder batches run as CUDA graphs on the card);
    then the runner's 16-step and 13-step decode blocks at 8 live slots
    are timed and profiled eagerly and as captured graphs, side by side
    (wall, device ms, K2 ms per step, device busy share), and one
    605-latent chunk and first-segment batches of 1 and 8 through the
    vocoder, eagerly and as graphs;
 4b. the int8 slice: the same with an int8 KV cache, W8A8 prefill and
    decode matmuls and ragged decode attention, each request capped at 200
    tokens; K1, K4 and K3 must launch and graphs replay; then phase 4f's
    int8 streaming request (100 tokens) on the same engine, in which K1,
    K4 and K3 must launch and graphs replay; the decode blocks are
    profiled as in 4 (K4 ms per step);
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
    body under the per-program W8A8 policy at crossover 1, where it flips
    inside the 16-slot grid (its choice at every bound);
    K2 and K3 (bf16) and K4 (int8) must launch in the runner drives,
    and graphs replay there, insert programs among them;
 4f. streaming on the bf16 configuration with 16 slots: one solo
    streaming request, then 8 concurrent ones with bench.py's TTFA text
    (SENTENCE x 4, two chunks each, 120 tokens a chunk): time to first
    audio p50/p95, the speculative first segments and the vocode batches;
    7 of the 8 streams are closed after their first segment and every slot
    must drain; a greedy stream must give >= 2 segments that equal, to the
    16-bit PCM step, vocode_device_row of its final latent row, and that
    row in a batch of 4 must equal the row alone. The 8-stream burst runs
    twice: first capturing its programs lazily while other threads issue,
    then after TTS.warmup() (whose precompile hooks capture every decode
    block, insert program and vocoder program; its time and memory are
    printed beside the slot fit's pool estimate, which must not be below
    the growth), where insert programs must replay too. K1, K2, K3 must
    launch and graphs replay. (Its int8 stream runs in 4b.) Phase 3
    checks K3 at the streaming windows' shapes (STREAM_WINDOWS);
 4g. captured programs on fresh bf16 and int8 engines: the precompile
    hooks' time, captures, capture and instantiation seconds and memory
    reserved before and after; a 16-step and a 13-step block, greedy and
    sampled (the generator's own draws), through the captured graph and
    eagerly (`decode_steps_status`) from one cloned full-width state: every
    state tensor (tokens, latents, KV rows and int8 scales, sampling rows,
    counters), the packed status and the generator's state bit-equal; on
    bf16 the vocoder programs (seg_first at B = 1, 8; seg at B = 1, 4; rows
    in every bucket at B = 1, 4) 0 PCM steps from the eager functions.
    precompile_decode_programs must capture every decode block, the 16
    insert programs (single and K = 2, 4, 8 per prefill bucket) and
    migrate_slot, its decode and insert parts timed apart; on bf16 the
    growth of both hooks on the fresh engine must not exceed the slot
    fit's pool estimate (accepted: at most 1.5x above it);
 4h. the insert programs on 4g's engines: from one cloned full-width state
    per side, `precompile_inserts` captures on the graph side, then a
    single insert at each prefill bucket into slot 5 (sampled and greedy),
    bursts of K = 2, 4, 8 at buckets 128 and 512 into non-contiguous slots
    and migrate_slot 6 -> 1 replay with other values than the capture's,
    against the module functions with the same values: every state tensor
    and the generator bit-equal; ms per chunk, eager and graph, of the
    single insert and each burst at bucket 128. On bf16, the conditioning
    programs (perceiver latents and speaker embedding of a 6 s and a 3 s
    reference) bit-equal to the eager functions, ms side by side;
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
    finite 24 kHz audio; K1, K2 and K3 must launch and graphs replay.
    Then the CLI
    (python -m auralis_tpu_torch.entrypoints.oai_server --kv_int8) boots
    in a subprocess on a sibling model directory whose config sets the
    int8 path (kv_int8, ragged_decode, prefill_flash, W8A8), answers one
    short request and must exit 0 on SIGINT;
 7a. data-parallel replicas: two full-width bf16 engines on this card
    (ReplicatedTTSEngine.from_engine with devices [cuda:0, cuda:0]) behind
    the facade: 4 concurrent requests (100 tokens) capture both replicas'
    programs lazily at once and must route to both; TTS.warmup() on both
    (time, memory reserved beside the replicas' pool estimates, which must
    not be below the growth); the burst again, each replica's programs
    replaying in its own pools; a greedy request on replica 1 against the
    donor (tokens equal, waveform within 1 PCM step); from_engine with
    n_replicas=2 on the default devices gives one replica and logs it;
 7b. tensor parallelism on one card: a DecodeEngine on a mesh of two model
    shards on cuda:0 beside the unsharded one, full width, with bf16 KV
    (K1 and K2) and with int8 KV and ragged decode attention (K1 and K4,
    which takes the whole row's scales): 4 single inserts, 64
    teacher-forced steps, hidden states and logits within TP_SNR_FLOOR_DB;
    K1 and K2 / K4 at 8 heads; a 16-step block on the mesh replayed as a
    graph; under int8 layer 0's rows and scales of the prompts bit-equal
    to the unsharded engine's; the dense int8 body's layer-0 rows and
    scales of a prompt bit-equal to the unsharded engine's. Phase 3 holds
    K4 at one shard's 8 heads with the 16-head row's scales given
    bit-equal to the 16-head launch;
 7c. the refusal on this card: tensor_parallel_size=2 on one GPU raises
    ValueError;
 7d. the data and dcn axes of a decode state: 8-slot DecodeEngines at full
    width on cuda:0 meshes of data=2/model=1, data=2/model=2 and
    dcn=2/data=1/model=2, with bf16 KV (K1, K2) and int8 KV with ragged
    decode (K1, K4), slot bucketing on: 4 greedy TokenPrompt requests of
    100 tokens and one [90, 1024] embeds prompt through `generate`, tokens
    equal to the reference engine's (unsharded for model=1, the
    model-only mesh's for model=2); then 8 sampled prompts as one burst
    (spanning the data shards) and a 16-step sampled block, tokens,
    counts and seen rows bit-equal to the reference's; two migrate_slot
    from data shard 1 to 0, each destination bit-equal to its source;
    decode blocks and migrations replay as graphs, and the path's kernels
    launch (counts printed);
 8. bench_torch at reduced depth: bench_torch.py's section functions on a
    fresh bf16 engine at its settings (64 slots, 64-step blocks): the cold
    request and the warmup (precompile_decode_programs, a batch of 2
    requests, precompile_vocoder_buckets), then the RTF section (2
    requests x 2 chunks, one run), TTFA (8 streams), the short phrase (3
    reps) and the server load (8 requests, uncapped and capped); each
    section's JSON line and its captures_in_timed are printed. Any failed
    request fails the phase; K1, K2 and K3 must launch, programs (inserts
    among them) replay, and every key of bench.py's result line be a number;
 9. serving defaults: a full-width engine built with no engine flag (what
    `TTS.from_pretrained`, the CLI server and bench_torch's `default`
    serve) at 4 slots; its resolved defaults (kernel flags, int8 KV, the
    W8A8 policy and its crossover, int8 prefill, slot bucketing, the
    attn_fp region) must equal PERF.md's table; TTS.warmup() on it, its
    memory growth against the slot fit's estimate, and the program every
    decode key was captured with against the policy (W8A8 on one side of
    the crossover and bf16 weights on the other where it is armed; bf16
    weights everywhere on the H100); then 4 concurrent requests with no
    capture, programs replaying and K2 (the card's default decode
    attention on a bf16 cache) and K3 launching; one short greedy request
    bit-equal (tokens and PCM) to an engine given the same flags
    explicitly, lazily captured and replayed.

Every phase but 9 pins its engines' flags (PINNED: no int8 KV, W8A8 or
bucketing unless the phase names them), so it runs what its name says
whatever the card's defaults are; phase 6's servers run the defaults, as
a user's would, with the kernel flags of their config.json.

Each phase's header gives the seconds since the start. Any failure exits
non-zero. The kernels' launch counts include the launches of replayed
graphs (each replay adds the launches its capture recorded); every phase
that serves prints the captures and replays by program kind (decode,
insert, burst, migrate, the vocoder's, cond, speaker). The eager
reference on the card is the module functions (`decode_steps_status`,
`insert_sequence_tokens`, `insert_sequences_tokens`, `migrate_slot`,
`_vocode_seg_first`, `_cond_latents`, ...), which capture nothing. To
hold the script's time on slower hosts, every engine is built from one
cached set of seed-0 weights, and some earlier paths run at reduced
depth: the eager decode profiles of 4, 4b and 4e time one run, and 4c's
requests (32 tokens) and the W8A8 policy drive's chunks (12-32 tokens)
are short. Before the last line
come the kernels JSON object and the nvidia-smi line; the last is
{"ok": true, "device": {...}}. There is no CPU path: the script exits
non-zero when no CUDA device is visible. JAX is never imported.
"""
from __future__ import annotations

import asyncio
import base64
import ctypes
import dataclasses
import functools
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
from auralis_tpu_torch.models.xttsv2.engine import (
    FIRST_SEG_PF,
    PAD_PF,
    SEG_PF,
    XTTSv2Engine,
    _VocodeBatcher,
)
from auralis_tpu_torch.models.xttsv2.hifigan import (
    RESBLOCK_DILATIONS,
    RESBLOCK_KERNELS,
    UPSAMPLE_RATES,
)
from auralis_tpu_torch.models.xttsv2 import gpt as gpt_module
from auralis_tpu_torch.models.xttsv2.gpt import (
    KVCache,
    gpt_decode_step,
    gpt_prefill,
    gpt_prefill_batched,
    heads,
    layer_norm,
    quantize_decode_weights,
)
from auralis_tpu_torch.parallel.mesh import make_mesh
from auralis_tpu_torch.parallel.replica import ReplicatedTTSEngine
from auralis_tpu_torch.parallel.replica import logger as replica_logger
from auralis_tpu_torch.runtime import graphs
from auralis_tpu_torch.runtime.decode_loop import (
    PREFILL_BUCKETS,
    DataShardedState,
    DecodeState,
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
from auralis_tpu_torch.runtime.sampler import SamplingState
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
from auralis_tpu_torch.ops.quant import quantize_rows
from auralis_tpu_torch.ops.prefill_attention import (
    prefill_attention_plain,
    prefill_flash_attention,
)
from decode_bench import (
    HEAD_DIM,
    HEADS,
    HOT_LAYER,
    LAYERS,
    SLOTS,
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
        # the length as the captured inserts pass it (an int32 on the card,
        # read by the kernel) and as an int (the wrapper writes it there)
        dev_len = torch.tensor(length, dtype=torch.int32, device=dev)
        got = prefill_flash_attention(q, k, v, dev_len)
        got_int = prefill_flash_attention(q, k, v, length)
        torch.cuda.synchronize()
        want = prefill_attention_plain(q, k, v, dev_len)
        err = max((got - want).abs().max().item(), (got_int - want).abs().max().item())
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        if not (err <= tol and torch.equal(got, got_int)):
            raise AssertionError(f"K1 prefill {tag} T={t}: error {err} > {tol}, or the int "
                                 f"and device lengths differ")
        ms = time_ms(lambda: prefill_flash_attention(q, k, v, dev_len), 20)
        ms_int = time_ms(lambda: prefill_flash_attention(q, k, v, length), 20)
        plain_ms = time_ms(lambda: prefill_attention_plain(q, k, v, dev_len), 20)
        # bytes: q, k, v read once, f32 ctx written once; operations: QK^T
        # and PV over the (query, key) pairs the mask keeps
        pairs = sum(min(i + 1, length) for i in range(t))
        bound_ms, bound_by = bound(t * h * d * (3 * q.element_size() + 4), 4 * d * h * pairs,
                                   tag)
        row = {"max_abs_err": err, "ms": ms, "ms_int_length": ms_int, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        line = (f"  K1 prefill {tag} T={t} len={length}: max_abs_err={err:.3e} (bound "
                f"{tol:.0e}; int and device length bit-equal); kernel {ms:.4f} ms (device "
                f"length; {ms_int:.4f} with an int, the wrapper's fill included), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, {bound_ms / ms:.1%} "
                f"of it)")
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


def check_shard_shapes(dev, results) -> None:
    """K1 and K2 at one model shard's shapes under tensor parallelism of 2
    (phase 7b): 8 heads, K1's q/k/v strided views of a [T, 3 x 512] row at
    T = 128, K2 on a [30, 8, 1280, 512] cache at the ragged write
    positions; against the plain versions with phase 3's bounds, timed the
    same way, in each kernel's `by_shape`."""
    gen = torch.Generator(device=dev).manual_seed(3)
    h, d, t, length = HEADS // 2, HEAD_DIM, 128, 100
    qkv = torch.randn((t, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (x.view(t, h, d) for x in qkv.split(h * d, dim=-1))
    dev_len = torch.tensor(length, dtype=torch.int32, device=dev)
    got = prefill_flash_attention(q, k, v, dev_len)
    want = prefill_attention_plain(q, k, v, dev_len)
    err = (got - want).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"K1 at 8 heads: error {err} > 1e-3")
    ms = time_ms(lambda: prefill_flash_attention(q, k, v, dev_len), 20)
    plain_ms = time_ms(lambda: prefill_attention_plain(q, k, v, dev_len), 20)
    pairs = sum(min(i + 1, length) for i in range(t))
    bound_ms, bound_by = bound(t * h * d * (3 * 2 + 4), 4 * d * h * pairs, "bf16")
    results["prefill_attention"]["by_shape"]["bf16 T=128 H=8 (one of 2 model shards)"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by}
    say(f"  K1 prefill bf16 T={t} len={length} H=8 (one of 2 model shards): max_abs_err="
        f"{err:.3e} (bound 1e-3); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}, {bound_ms / ms:.1%} of it)")
    shape = (LAYERS, 8, T_MAX, h * d)
    kc = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    kc2, vc2 = kc.clone(), vc.clone()
    q = torch.randn((8, h, d), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((8, h * d), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((8, h * d), generator=gen, device=dev).to(torch.bfloat16)
    wp = torch.tensor(WRITE_POS_SETS["ragged"], dtype=torch.int32, device=dev)
    got = flash_decode_append_attention(q, kn, vn, kc, vc, HOT_LAYER, wp)
    torch.cuda.synchronize()
    want = flash_decode_plain(q, kn, vn, kc2, vc2, HOT_LAYER, wp)
    ratio, mismatch = elementwise(got, want, 2.0 ** -7, 1e-5)
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2) and ratio <= 1.0
            and mismatch <= 0.01):
        raise AssertionError(f"K2 at 8 heads: caches equal {torch.equal(kc, kc2)}, worst "
                             f"error/bound {ratio}, mismatch {mismatch}")
    err = (got.float() - want.float()).abs().max().item()
    ms, ms_hot = cold_hot_ms(
        lambda layer: flash_decode_append_attention(q, kn, vn, kc, vc, layer, wp))
    rot = itertools.count()
    plain_ms = time_ms(
        lambda: flash_decode_plain(q, kn, vn, kc2, vc2, next(rot) % LAYERS, wp), LAYERS)
    live, row_b = int((wp + 1).sum()), h * d * 2
    bound_ms, bound_by = bound(2 * live * row_b + 8 * row_b * 4, 4 * live * h * d, "bf16")
    results["flash_decode_append"]["by_shape"]["ragged H=8 (one of 2 model shards)"] = {
        "write_pos": wp.tolist(), "max_abs_err": err, "ms": ms, "ms_hot": ms_hot,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    say(f"  K2 decode S=8 T={T_MAX} H=8 (one of 2 model shards) ragged: max_abs_err={err:.3e}, "
        f"worst |err|/bound {ratio:.3f}, mismatch {mismatch:.4%}; kernel cold {ms:.4f} ms, hot "
        f"{ms_hot:.4f} ms, plain cold {plain_ms:.4f} ms per layer, bound {bound_ms:.5f} ms "
        f"({bound_by}; {bound_ms / ms:.1%} of cold)")


def check_k4_shard(dev, results) -> None:
    """K4 at one model shard's shapes under tensor parallelism of 2 (phases
    7b and 7d): 8 heads on a [30, 8, 1280, 512] int8 cache with f32 scale
    rows, given the new rows' scales over the whole 16-head row
    (`row_scales`, what the sharded decode step passes), at every
    write-position set. Each half of the heads, launched on its lanes of a
    copy of the 16-head cache, must write the int8 lanes and scales and give
    the ctx heads of the 16-head launch bit for bit; it is held against its
    plain version on its own copy with phase 3's K4 bounds (caches and
    scales bit-equal, ctx within 1e-5|ref| + 1e-6) and two launches
    bit-equal. Then timed as K4 (cold and hot), into K4's `by_shape`."""
    q, kn, vn, full = k4_inputs(dev, seed=9)
    h, d, s = HEADS // 2, HEAD_DIM, q.shape[0]
    w = h * d
    row_scales = (quantize_rows(kn)[1], quantize_rows(vn)[1])
    lanes = [slice(r * w, (r + 1) * w) for r in range(2)]
    halves = [tuple(x[..., ln].contiguous() if i < 2 else x.clone() for i, x in enumerate(full))
              for ln in lanes]
    refs = [tuple(x.clone() for x in half) for half in halves]
    args = [(q[:, r * h:(r + 1) * h].contiguous(), kn[:, ln].contiguous(),
             vn[:, ln].contiguous()) for r, ln in enumerate(lanes)]
    rows = {}
    for name, wp_list in WRITE_POS_SETS.items():
        wp = torch.tensor(wp_list, dtype=torch.int32, device=dev)
        ctx16 = ragged_decode_attention(q, kn, vn, 0.125, HOT_LAYER, wp, *full)
        worst, err = 0.0, 0.0
        for r, ln in enumerate(lanes):
            got = ragged_decode_attention(*args[r], 0.125, HOT_LAYER, wp, *halves[r],
                                          row_scales=row_scales)
            again = ragged_decode_attention(*args[r], 0.125, HOT_LAYER, wp, *halves[r],
                                            row_scales=row_scales)
            torch.cuda.synchronize()
            want = ragged_decode_plain(*args[r], 0.125, HOT_LAYER, wp, *refs[r],
                                       row_scales=row_scales)
            as_16 = (torch.equal(got, ctx16[:, ln]) and torch.equal(halves[r][0], full[0][..., ln])
                     and torch.equal(halves[r][1], full[1][..., ln])
                     and torch.equal(halves[r][2], full[2]) and torch.equal(halves[r][3], full[3]))
            if not as_16:
                raise AssertionError(f"K4 at 8 heads with given scales, {name}, heads "
                                     f"{r * h}-{(r + 1) * h - 1}: rows, scales or ctx differ from "
                                     f"the 16-head launch's")
            if not all(torch.equal(a, b) for a, b in zip(halves[r], refs[r])):
                raise AssertionError(f"K4 at 8 heads with given scales, {name}: caches or scales "
                                     f"differ from the plain version's")
            if not torch.equal(got, again):
                raise AssertionError(f"K4 at 8 heads with given scales, {name}: two launches on "
                                     f"the same inputs differ")
            ratio, mismatch = elementwise(got, want, 1e-5, 1e-6)
            if not ratio <= 1.0:
                raise AssertionError(f"K4 at 8 heads with given scales, {name}: worst "
                                     f"error/bound {ratio}")
            worst = max(worst, ratio)
            err = max(err, (got - want).abs().max().item())
        rows[name] = {"write_pos": wp_list, "max_abs_err": err, "worst_ratio": worst}
        say(f"  K4 ragged int8 S={s} T={T_MAX} H=8 (one of 2 model shards, scales of the 16-head "
            f"row given) {name}: both halves' int8 lanes, scales and ctx bit-equal to the 16-head "
            f"launch's; against the plain version caches and scales bit-equal, ctx "
            f"max_abs_err={err:.3e}, worst |err|/bound {worst:.3f}; repeat bit-equal")
    del full, refs
    torch.cuda.empty_cache()
    # timed on the first half's copy: the appends of every layer now differ
    # from the 16-head cache's, which nothing compares any more
    mine, row = halves[0], w
    for name, wp_list in WRITE_POS_SETS.items():
        wp = torch.tensor(wp_list, dtype=torch.int32, device=dev)
        ms, ms_hot = cold_hot_ms(lambda layer: ragged_decode_attention(
            *args[0], 0.125, layer, wp, *mine, row_scales=row_scales))
        rot = itertools.count()
        plain_ms = time_ms(lambda: ragged_decode_plain(
            *args[0], 0.125, next(rot) % LAYERS, wp, *halves[1], row_scales=row_scales), LAYERS)
        # bytes as phase 3's K4, plus the two given scales per slot read
        live = int((wp + 1).sum())
        nbytes = (2 * (live - s) * (row + 4) + s * row * 2 + 2 * s * row * 2 + 2 * s * 4
                  + 2 * s * (row + 4) + s * row * 4)
        bound_ms, bound_by = bound(nbytes, 4 * live * row, "int8")
        rows[name].update({"ms": ms, "ms_hot": ms_hot, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by})
        say(f"  K4 H=8 with given scales {name}: kernel cold {ms:.4f} ms, hot {ms_hot:.4f} ms, "
            f"plain cold {plain_ms:.4f} ms per layer, bound {bound_ms:.5f} ms ({bound_by}, {live} "
            f"live rows; {bound_ms / ms:.1%} of cold)")
    results["ragged_decode"]["by_shape"]["H=8 scales given (one of 2 model shards)"] = rows
    del halves, mine
    torch.cuda.empty_cache()


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


# bench_torch's decode slot count (bench.py's BENCH_DECODE_SLOTS default):
# K2 and K4 are also checked and timed at the width the benchmark steps
# them, on a [30, 64, 1280, 1024] cache. Its write positions: the 8-slot
# ragged mix and split edges, then 48 spread over 0-1046 without a period,
# and every slot at the longest row.
BENCH_SLOTS = 64
WRITE_POS_64 = {
    f"S={BENCH_SLOTS} mixed": (WRITE_POS_SETS["ragged"] + WRITE_POS_SETS["split edges"]
                               + [(97 * i + 13 * i * i) % 1047 for i in range(48)]),
    f"S={BENCH_SLOTS} all 1046": [1046] * BENCH_SLOTS,
}


def check_decode(dev, results) -> None:
    """K2 on a [30, 8, 1280, 1024] bf16 cache at every write-position set of
    decode_bench.WRITE_POS_SETS, and on a [30, 64, 1280, 1024] one at
    WRITE_POS_64. Both sides update their own copy of the cache, which must
    stay bit-equal; ctx must be within its bounds, and two launches on the
    same inputs must give the same bits. Timed cold (call i on layer i % 30,
    `ms`) and hot (layer 17, `ms_hot`); the plain version cold."""
    rows = {}
    for slots, sets in ((SLOTS, WRITE_POS_SETS), (BENCH_SLOTS, WRITE_POS_64)):
        q, kn, vn, kc, vc = k2_inputs(dev, slots=slots)
        kc2, vc2 = kc.clone(), vc.clone()
        s, row_b = q.shape[0], HEADS * HEAD_DIM * 2
        for name, wp_list in sets.items():
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
            # ctx is bf16, the f32 result rounded once. Summation order may
            # flip that rounding: one bf16 step, at most 2^-7 of |ctx|, plus
            # 1e-5 for f32 noise on entries near zero. Flips are rare (2 of
            # these 8192 entries on an H100), so at most 1% may differ at
            # all; bf16 probabilities change ~37% (off the card).
            ratio, mismatch = elementwise(got, want, 2.0 ** -7, 1e-5)
            if not (ratio <= 1.0 and mismatch <= 0.01):
                raise AssertionError(f"K2 {name}: worst error/bound {ratio}, mismatch {mismatch}")
            ms, ms_hot = cold_hot_ms(
                lambda layer: flash_decode_append_attention(q, kn, vn, kc, vc, layer, wp))
            rot = itertools.count()
            plain_ms = time_ms(
                lambda: flash_decode_plain(q, kn, vn, kc2, vc2, next(rot) % LAYERS, wp), LAYERS)
            # bytes: the live K and V rows (write_pos + 1 per slot: the
            # cached ones and the new one) read once, the new rows written
            # once more into the cache, q read and the bf16 ctx written;
            # operations: QK^T and PV over the live rows
            live = int((wp + 1).sum())
            bound_ms, bound_by = bound(2 * live * row_b + s * row_b * (2 + 1 + 1),
                                       4 * live * HEADS * HEAD_DIM, "bf16")
            rows[name] = {"write_pos": wp_list, "max_abs_err": err, "ms": ms, "ms_hot": ms_hot,
                          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            say(f"  K2 decode S={s} T={T_MAX} {name} write_pos={wp_list}: max_abs_err={err:.3e}, "
                f"worst |err|/bound {ratio:.3f} (bound 2^-7|ref| + 1e-5 per entry), mismatch "
                f"{mismatch:.4%} (bound 1%), repeat bit-equal; kernel cold {ms:.4f} ms, hot "
                f"{ms_hot:.4f} ms, plain cold {plain_ms:.4f} ms per layer, bound {bound_ms:.5f} "
                f"ms ({bound_by}, {live} live rows; {bound_ms / ms:.1%} of cold)")
        if slots == SLOTS:
            rows.update(check_slot_slices(
                "K2",
                lambda sb, wp: flash_decode_append_attention(q[:sb], kn[:sb], vn[:sb], kc, vc,
                                                             HOT_LAYER, wp),
                lambda sb, wp: flash_decode_plain(q[:sb], kn[:sb], vn[:sb], kc2, vc2, HOT_LAYER,
                                                  wp),
                (kc, vc), (kc2, vc2), 2.0 ** -7, 1e-5, dev))
        del q, kn, vn, kc, vc, kc2, vc2
        torch.cuda.empty_cache()
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
    write-position set of decode_bench.WRITE_POS_SETS, and on a [30, 64,
    1280, 1024] one at WRITE_POS_64. Both sides update their own copy of
    the caches and scales, which must stay bit-equal; ctx must be within its
    bound, and two launches on the same inputs must give the same bits.
    Timed as K2."""
    rows = {}
    for slots, sets in ((SLOTS, WRITE_POS_SETS), (BENCH_SLOTS, WRITE_POS_64)):
        q, kn, vn, mine = k4_inputs(dev, slots=slots)
        ref = tuple(x.clone() for x in mine)
        s, row = q.shape[0], HEADS * HEAD_DIM
        for name, wp_list in sets.items():
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
            # ctx is f32 on both sides, from the same int8 rows and scales:
            # the scores are exact integers, so only expf and the order of
            # the f32 sums differ. On the CPU the plain version in f32
            # against an f64 evaluation reaches 0.24 of this bound (1.2e-6
            # at |ctx| up to 3.2). One wrong key, scale or mask row among
            # ~1,000 live keys moves ctx by ~1e-3, far past it.
            ratio, mismatch = elementwise(got, want, 1e-5, 1e-6)
            if not ratio <= 1.0:
                raise AssertionError(f"K4 {name}: worst error/bound {ratio}")
            ms, ms_hot = cold_hot_ms(
                lambda layer: ragged_decode_attention(q, kn, vn, 0.125, layer, wp, *mine))
            rot = itertools.count()
            plain_ms = time_ms(lambda: ragged_decode_plain(
                q, kn, vn, 0.125, next(rot) % LAYERS, wp, *ref), LAYERS)
            # bytes: the cached int8 K and V rows and their f32 scales read
            # once, q and the new bf16 rows read, the appended int8 rows and
            # scales and the f32 ctx written; operations: QK^T and PV over
            # the live rows, at the int8 rate (the lower bound: PV runs in
            # f32)
            live = int((wp + 1).sum())
            nbytes = (2 * (live - s) * (row + 4) + s * row * 2 + 2 * s * row * 2
                      + 2 * s * (row + 4) + s * row * 4)
            bound_ms, bound_by = bound(nbytes, 4 * live * row, "int8")
            rows[name] = {"write_pos": wp_list, "max_abs_err": err, "ms": ms, "ms_hot": ms_hot,
                          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            say(f"  K4 ragged int8 S={s} T={T_MAX} {name} write_pos={wp_list}: caches and "
                f"scales bit-equal; ctx max_abs_err={err:.3e}, worst |err|/bound {ratio:.3f} "
                f"(bound 1e-5|ref| + 1e-6 per entry), differing {mismatch:.4%}, repeat "
                f"bit-equal; kernel cold {ms:.4f} ms, hot {ms_hot:.4f} ms, plain cold "
                f"{plain_ms:.4f} ms per layer, bound {bound_ms:.5f} ms ({bound_by}, {live} live "
                f"rows; {bound_ms / ms:.1%} of cold)")
        if slots == SLOTS:
            rows.update(check_slot_slices(
                "K4",
                lambda sb, wp: ragged_decode_attention(q[:sb], kn[:sb], vn[:sb], 0.125,
                                                       HOT_LAYER, wp, *mine),
                lambda sb, wp: ragged_decode_plain(q[:sb], kn[:sb], vn[:sb], 0.125, HOT_LAYER,
                                                   wp, *ref),
                mine, ref, 1e-5, 1e-6, dev))
        del q, kn, vn, mine, ref
        torch.cuda.empty_cache()
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
@functools.lru_cache(maxsize=1)
def seed0_weights() -> tuple[dict, dict]:
    """The full-width model's seed-0 numpy weights (random_init), made once:
    the flags of a configuration do not change its weights, and making them
    takes ~5-12 s of host time per engine."""
    return random_init(XTTSConfig(), seed=0)


# the engine flags every phase's engine is pinned to unless the phase names
# them: no int8 KV, W8A8 (policy included) or bucketing by default, so each
# phase runs what its name and its checks say whatever the card's serving
# defaults are (phase 9 runs those)
PINNED = {"kv_int8": False, "decode_w8a8": False, "prefill_w8a8": False,
          "slot_bucketing": False}


def build_engine(dev, tokenizer, gpt_flags: dict, engine_flags: dict | None,
                 **kw) -> XTTSv2Engine:
    """The full-width engine with seeded random bf16 weights (what
    XTTSv2Engine.random_init builds, from the cached seed-0 weights), its
    engine flags pinned (PINNED under `engine_flags`), or left to the
    engine's serving defaults when `engine_flags` is None."""
    engine_flags = {} if engine_flags is None else {**PINNED, **engine_flags}
    cfg = XTTSConfig()
    cfg.gpt = dataclasses.replace(cfg.gpt, **gpt_flags)
    t0 = time.perf_counter()
    params, core = params_from_numpy(*seed0_weights(), device=dev, dtype=torch.bfloat16)
    engine = XTTSv2Engine(
        cfg, cfg.gpt, params=params, core=core, tokenizer=tokenizer, device=dev, seed=0,
        cache_dtype=torch.bfloat16, decode_slots=kw.pop("decode_slots", 8), max_concurrency=4,
        **engine_flags, **kw)
    torch.cuda.synchronize()
    cache = engine.decode_engine.state.cache
    say(f"  engine: GPT {cfg.gpt.num_hidden_layers} layers x {cfg.gpt.hidden_size}, "
        f"{cfg.gpt.num_attention_heads} heads, {engine.decode_slots} slots, KV cache "
        f"{tuple(cache.k.shape)} {cache.k.dtype}{' + f32 scales' if cache.quantized else ''}, "
        f"{', '.join(f'{k}={v}' for k, v in {**gpt_flags, **engine_flags}.items()) or 'defaults'}; "
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


# program kinds as graphs.counts tallies them ("<kind>.captures", ...)
PROGRAM_KINDS = ("decode", "insert", "burst", "migrate", "seg_first", "seg", "row", "cond",
                 "speaker")


def graphs_text(counts: dict) -> str:
    """Captures (with their seconds) and replays, then per program kind
    captured / replayed: the insert programs' numbers are `insert` (single)
    and `burst`."""
    kinds = [f"{k} {counts.get(k + '.captures', 0)}/{counts.get(k + '.replays', 0)}"
             for k in PROGRAM_KINDS if counts.get(k + ".captures") or counts.get(k + ".replays")]
    return (f"{counts['captures']} captured ({counts['capture_s']:.2f} s capture, "
            f"{counts['instantiate_s']:.2f} s instantiate), {counts['replays']} replays"
            + (f" [captured/replayed by kind: {', '.join(kinds)}]" if kinds else ""))


def must_replay(what: str, counts: dict) -> None:
    """The main path's decode blocks and vocoder batches replayed captured
    graphs during `what`."""
    if counts["replays"] <= 0:
        raise AssertionError(f"no captured program was replayed during {what}: {counts}")


def must_replay_inserts(what: str, counts: dict) -> None:
    """The runner's single or burst insert programs replayed during `what`."""
    if counts.get("insert.replays", 0) + counts.get("burst.replays", 0) <= 0:
        raise AssertionError(f"no insert program was replayed during {what}: {counts}")


def decode_keys(de) -> list:
    """The decode blocks' keys among a runner's captured programs."""
    return [k for k in de._programs.keys() if graphs.kind_of(k) == "decode"]


def profile_run(fn, n_units: int, kernel: str | None = None, reps: int = 3) -> dict:
    """fn() (which ends in a host sync) once to warm, `reps` times on the
    host clock, then once under torch.profiler. Per unit: wall ms (median
    of reps), the profiled run's wall, device ms (sum of device event
    times), device ops and, with `kernel`, the ms and launches of device
    events whose name holds it; busy is the union of the device intervals
    over the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3 / n_units)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        prof_wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    row = {"wall_ms": statistics.median(walls), "walls": walls, "prof_wall_ms": prof_wall / n_units}
    if events:
        row.update(device_ms=sum(e.time_range.elapsed_us() for e in events) / 1e3 / n_units,
                   ops=len(events) / n_units, busy=busy_ms(events) / prof_wall)
        if kernel:
            row.update(kernel_ms=sum(e.time_range.elapsed_us() for e in events
                                     if kernel in e.name) / 1e3 / n_units,
                       kernel_n=sum(kernel in e.name for e in events) / n_units)
    return row


def profile_text(row: dict, unit: str, kernel: str | None = None) -> str:
    walls = ", ".join(f"{w:.3f}" for w in row["walls"])
    text = (f"wall {row['wall_ms']:.3f} ms per {unit} (median of {len(row['walls'])}: {walls}); "
            f"profiled {row['prof_wall_ms']:.3f} ms wall per {unit}")
    if "busy" not in row:
        return text + "; the profiler saw no device events: device ms not measured"
    text += (f", device {row['device_ms']:.3f} ms per {unit} in {row['ops']:.0f} device ops, "
             f"device busy {row['busy']:.1%} under the profiler, device ms over the unprofiled "
             f"wall {row['device_ms'] / row['wall_ms']:.1%}")
    if kernel:
        text += f", {kernel} {row['kernel_ms']:.4f} ms per {unit} ({row['kernel_n']:.0f} launches)"
    return text


def profile_decode(engine, smi: str, kernel: str) -> None:
    """The runner's decode blocks (steps_per_sync steps, and the young
    block's stream_block_steps) with every slot live at the phase-3 ragged
    write positions, each then its packed status copied to the host and
    waited for: eagerly (`decode_steps_status`, the module function) and as
    the engine's captured program (`DecodeEngine._decode_block`), side by
    side: wall per step, device ms per step, device ops, the decode
    kernel's ms and the device busy share (profile_run)."""
    de = engine.decode_engine
    st = de.state
    lens = torch.tensor(WRITE_POS_SETS["ragged"][:de.num_slots], dtype=torch.int32,
                        device=engine.device)
    host = torch.empty((de.num_slots,), dtype=torch.int32, pin_memory=True)

    def reset():
        st.seq_lens.copy_(lens)
        st.audio_pos.fill_(1)
        st.n_generated.zero_()
        st.active.fill_(True)
        st.done.fill_(False)

    for n in sorted({de.steps_per_sync, de.stream_block_steps}, reverse=True):
        def eager():
            reset()
            host.copy_(decode_steps_status(de.params, de._cfg_for(None, None), st, n),
                       non_blocking=True)
            torch.cuda.synchronize()

        def graph():
            reset()
            de._decode_block(n, None, None, host)
            torch.cuda.synchronize()

        # one timed eager run: the eager block is host-bound, and one run
        # holds the script's time
        for mode, fn, reps in (("eager", eager, 1), ("graph", graph, 3)):
            row = profile_run(fn, n, kernel, reps=reps)
            say(f"  decode block, {mode}: {n} steps x {de.num_slots} live slots (write_pos "
                f"{lens.tolist()}), {profile_text(row, 'step', kernel)} ({smi})")


def profile_vocoder(engine, smi: str) -> None:
    """One 605-latent chunk through the row vocoder (the bucket a full chunk
    takes), and first-segment batches of 1 and 8 lanes, each eagerly (the
    module functions) and through the batcher's captured program
    (`_vocode_batch`), PCM on the host at the end: wall, device ms, device
    ops, K3's ms and the device busy share (profile_run)."""
    g = engine.gpt_config
    n = g.max_audio_tokens
    gen = torch.Generator(device=engine.device).manual_seed(8)
    rows = [torch.randn((n, g.hidden_size), generator=gen, device=engine.device)
            for _ in range(_VocodeBatcher.SEG_FIRST_MAX_BATCH)]
    spk = [np.random.default_rng(8 + i).standard_normal((1, 512)).astype(np.float32) * 0.1
           for i in range(len(rows))]
    bucket = engine.row_bucket(n)
    cases = [("605-latent chunk", lambda: engine.vocode_device_row(rows[0], n, spk[0]),
              lambda: engine._vocode_batch("row", rows[:1], [n], spk[:1], bucket))]
    for b in (1, _VocodeBatcher.SEG_FIRST_MAX_BATCH):
        cases.append((f"seg_first batch of {b}",
                      lambda b=b: engine._vocode_seg_first(torch.stack(rows[:b]), [n] * b,
                                                           spk[:b]).cpu(),
                      lambda b=b: engine._vocode_batch("seg_first", rows[:b], [n] * b, spk[:b])))
    for name, eager, graph in cases:
        for mode, fn in (("eager", eager), ("graph", graph)):
            row = profile_run(fn, 1, "mrf_conv")
            say(f"  vocoder {name}, {mode}: {profile_text(row, 'call', 'mrf_conv')} ({smi})")


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
        graphs.reset_counts()
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
        requests_graphs = dict(graphs.counts)
        stream = {name: 0 for name in KERNELS}
        if stream_tokens:
            for w in KERNELS.values():
                w["wrapper"].launches = 0
            graphs.reset_counts()
            ttfa, n_seg, secs = tts.loop.run_until_complete(stream_ttfa(tts, TTSRequest(
                text="Hello world, this is a test of speech.", speaker_files=[wav_path],
                language="en", stream=True, max_new_tokens=stream_tokens), False))
            stream = {name: w["wrapper"].launches for name, w in KERNELS.items()}
            say(f"  [4f] stream ({stream_tokens}-token cap) on this engine: first segment "
                f"{ttfa * 1e3:.1f} ms, {n_seg} segments, {secs:.2f} s audio; launches {stream}; "
                f"graphs {graphs_text(graphs.counts)} ({smi})")
            for name in must_launch:
                if stream[name] <= 0:
                    raise AssertionError(f"kernel {name} was not launched by the stream")
            must_replay("the stream", graphs.counts)
        tts.loop.run_until_complete(tts.shutdown())

    for name, o, wall in outs:
        check_waveform(name, o)
        secs = o.array.size / o.sample_rate
        tokens = round(o.array.size / 1024 * 22050 / 24000)  # 1024 samples @22.05k per token
        say(f"  {name}: wall {wall:.2f} s, ~{tokens} audio tokens, {secs:.2f} s audio, "
            f"audio/wall {secs / wall:.2f} ({smi})")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1024**3:.2f} GiB; "
        f"launches during the slice: {launches}; graphs {graphs_text(requests_graphs)}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    must_replay("the slice's requests", requests_graphs)
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
    32-token request (short, to hold the script's time) each with bf16
    probabilities (decode_attn_fp) and with
    probabilities requantised to int8."""
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_voice(tmp)
        for attn_fp in (True, False):
            engine = build_engine(dev, tokenizer, {"prefill_flash": True,
                                                   "decode_attn_fp": attn_fp},
                                  {"kv_int8": True, "decode_w8a8": True}, decode_slots=2)
            tts = TTS(scheduler_max_concurrency=1).with_engine(engine)
            graphs.reset_counts()
            t0 = time.perf_counter()
            out = tts.generate_speech(TTSRequest(
                text="Hello world, this is a test of speech.", speaker_files=[wav_path],
                language="en", max_new_tokens=32))
            torch.cuda.synchronize()
            check_waveform(f"dense int8 decode_attn_fp={attn_fp}", out)
            say(f"  decode_attn_fp={attn_fp}: {out.array.size / out.sample_rate:.2f} s audio "
                f"(32 tokens cap) in {time.perf_counter() - t0:.2f} s wall; graphs "
                f"{graphs_text(graphs.counts)}")
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
                                  max_concurrency=1, **PINNED)
            graphs.reset_counts()
            out[device.type] = asyncio.run(_greedy_chunk(engine, wav_path, "Hello world.", 24))
            say(f"  {device.type}: {len(out[device.type][0])} tokens, "
                f"{out[device.type][1].size} samples in {time.perf_counter() - t0:.1f} s; graphs "
                f"{graphs_text(graphs.counts)}")
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
                              decode_w8a8=True, prefill_w8a8=True, slot_bucketing=False)
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
    status copy, continuing `st`, eagerly (the module function), through
    profile_run with one timed run (eager blocks are host-bound; one run
    holds the script's time)."""
    def block():
        decode_steps_status(p, g, st, n_steps, slot_bound=slot_bound).cpu()

    return profile_run(block, n_steps, kernel, reps=1)


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
            say(f"  eager block at slot_bound={sb or CONC_SLOTS} ({live} live): "
                f"{profile_text(row, 'step', kernel)} ({smi})")
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
    graphs.reset_counts()
    got, wall = asyncio.run(drive_runner(de, prompts, options))
    st = dict(de.stats)
    runner_graphs = dict(graphs.counts)
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
        f"{launches}; graphs in the runner drive {graphs_text(runner_graphs)}, and with the "
        f"facade request {graphs_text(graphs.counts)}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by phase 4e's main path")
    must_replay("phase 4e's runner drive", runner_graphs)
    must_replay_inserts("phase 4e's runner drive", runner_graphs)
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


# the W8A8 policy's crossover in phase 4e's drive: it flips inside the
# 16-slot grid (the TPU's 3 picks W8A8 for every block of 16 int8 slots, and
# the card's attn_fp region gives every W8A8 block of the dense int8 body
# the bf16-probabilities variant), so two programs run
POLICY_CROSSOVER = 1


def check_policy(engine, smi: str) -> None:
    """The dense int8 body (kv_int8, no K4) run by a DecodeEngine given the
    engine's w8a8_policy() at POLICY_CROSSOVER: 6 greedy chunks of 12-32
    tokens. Prints the program _cfg_for picks at every (length bound, slot
    bound) pair and the programs the blocks ran; at least two programs must
    appear."""
    g = dataclasses.replace(engine.gpt_config, ragged_decode=False, decode_w8a8=False)
    de = DecodeEngine(engine.params, g, num_slots=CONC_SLOTS, slot_bucketing=True,
                      w8a8_policy=engine.w8a8_policy(POLICY_CROSSOVER), device=engine.device)
    name = de._program_name
    table = {f"len={lb} slots={sb or CONC_SLOTS}": name(de._cfg_for(lb, sb))
             for lb in (*de.LEN_BUCKETS, None) for sb in (*de._slot_buckets(), None)}
    ran = []
    pick = de._cfg_for
    de._cfg_for = lambda lb, sb: ran.append(name(pick(lb, sb))) or pick(lb, sb)
    caps = [12, 16, 24, 20, 32, 28]  # short, to hold the script's time
    prompts = conc_prompts(g, engine.device, len(caps), seed=90)

    async def go():
        out = await asyncio.gather(*(de.generate(pr, SamplingOptions(do_sample=False,
                                                                     max_new_tokens=c))
                                     for pr, c in zip(prompts, caps)))
        await de.shutdown()
        return out

    got = asyncio.run(go())
    say(f"  W8A8 policy (KV bytes < {POLICY_CROSSOVER} x weight bytes) over (len bound, slot "
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
# the engine's tracing spans on the way to the first segment, on the host's
# clock: a chunk's wait for a slot, a young block from issue to its status,
# the wait for the first snapshot, the tokenizer (the first segment's device
# time, `vocode.device.seg_first`, is a device span: the bursts run with the
# timeline off, as served)
TTFA_SPANS = ("decode.queue_wait", "decode.young_block", "phase2.first_snapshot_wait",
              "phase1.tokenize")


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

    def recording(kind, items, *rest):
        flights.append((kind, len(items)))
        return run(kind, items, *rest)

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

        de = engine.decode_engine

        async def drained():
            t_end = time.perf_counter() + 30
            while de.num_active or de._queue:
                if time.perf_counter() > t_end:
                    raise AssertionError(f"abandoned streams: {de.num_active} slots still live")
                await asyncio.sleep(0.01)

        # the first burst captures its programs lazily, in the threads that
        # run them; TTS.warmup() then captures every key, and the second
        # burst runs on captured programs only
        for tag in ("lazy captures", "after TTS.warmup()"):
            del flights[:]
            graphs.reset_counts()
            profile_summary(reset=True)
            t0 = time.perf_counter()
            outs = tts.loop.run_until_complete(burst())
            wall = time.perf_counter() - t0
            spans = profile_summary(reset=True)
            ttfas = sorted(o[0] for o in outs)
            p50 = ttfas[len(ttfas) // 2]
            p95 = ttfas[min(len(ttfas) - 1, int(len(ttfas) * 0.95))]
            sf = [k for kind, k in flights if kind == "seg_first"]
            say(f"  TTFA at concurrency {STREAM_CONCURRENCY}, {tag} (SENTENCE x 4, "
                f"{STREAM_CAP}-token cap per chunk, sampled): p50 {p50 * 1e3:.1f} ms, p95 "
                f"{p95 * 1e3:.1f} ms, all {', '.join(f'{t * 1e3:.1f}' for t in ttfas)} ms; "
                f"speculative first segments {sum(sf)} in seg_first batches of {sf}; other "
                f"batches {[f for f in flights if f[0] != 'seg_first']}; stream 0: "
                f"{outs[0][1]} segments, {outs[0][2]:.2f} s audio; {wall:.2f} s wall; graphs "
                f"{graphs_text(graphs.counts)} ({smi})")
            say("  where the burst's time went (host spans, mean / max ms x count): " + "; ".join(
                f"{k} {v['mean_ms']:.1f} / {v['max_ms']:.1f} x {v['count']}"
                for k, v in sorted(spans.items()) if k in TTFA_SPANS))
            if not all(o[1] >= 1 for o in outs) or outs[0][1] < 2:
                raise AssertionError(f"streams: segments {[o[1] for o in outs]}")
            must_replay(f"the streaming burst ({tag})", graphs.counts)
            if tag != "lazy captures":
                must_replay_inserts(f"the streaming burst ({tag})", graphs.counts)
            tts.loop.run_until_complete(drained())
            say(f"  abandonment: {STREAM_CONCURRENCY - 1} streams closed after their first "
                f"segment; num_active back to 0")
            if tag == "lazy captures":
                graphs.reset_counts()
                torch.cuda.synchronize()
                reserved = torch.cuda.memory_reserved()
                t0 = time.perf_counter()
                tts.warmup(text="Hello world, this is a test of speech. The quick brown fox "
                                "jumps over the lazy dog.")
                torch.cuda.synchronize()
                grown = torch.cuda.memory_reserved() - reserved
                say(f"  TTS.warmup (precompile hooks, then two sentences of traffic) completed "
                    f"in {time.perf_counter() - t0:.1f} s: graphs {graphs_text(graphs.counts)}; "
                    f"decode keys {len(decode_keys(de))} of {len(de.precompile_keys())}, "
                    f"insert and migrate keys {len(de._programs.keys()) - len(decode_keys(de))}, "
                    f"vocoder keys {len(engine._vocoder_programs.keys())}; memory reserved "
                    f"{reserved / 2**30:.2f} -> {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
                    f"(+{grown / 2**30:.2f}; the pool estimate {engine.pool_bytes / 2**30:.2f} "
                    f"GiB, the lazy burst captured part of it) ({smi})")
                if engine.pool_bytes < grown:
                    raise AssertionError(f"4f: pool estimate {engine.pool_bytes} below the "
                                         f"warmup's growth {grown}")
                if len(decode_keys(de)) < len(de.precompile_keys()):
                    raise AssertionError("TTS.warmup() left decode keys uncaptured")
                if len(de._programs.keys()) - len(decode_keys(de)) < INSERT_KEYS + 1:
                    raise AssertionError("TTS.warmup() left insert keys uncaptured")

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

        bf16 = {name: w["wrapper"].launches for name, w in KERNELS.items()}
        tts.loop.run_until_complete(tts.shutdown())
        del tts, engine
    say(f"  launches during the bf16 streaming drive: {bf16}")
    for name in BF16_PATH:
        if bf16[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by phase 4f's bf16 drive")
    return bf16


# ------------------------------------------------------------- graphs
def state_tensors(st: DecodeState) -> dict:
    """Every tensor of a decode state by name: the cache (and its scales),
    the sampling rows and the per-slot counters and buffers."""
    out = {name: t for name, t in (("k", st.cache.k), ("v", st.cache.v),
                                   ("k_scale", st.cache.k_scale),
                                   ("v_scale", st.cache.v_scale)) if t is not None}
    out.update({f"sampling.{f.name}": getattr(st.sampling, f.name)
                for f in dataclasses.fields(st.sampling)})
    out.update({f.name: getattr(st, f.name) for f in dataclasses.fields(st)
                if f.name not in ("cache", "sampling", "generator")})
    return out


def clone_state(st: DecodeState) -> DecodeState:
    """An independent copy of a decode state, its generator's state too."""
    gen = torch.Generator(device=st.seq_lens.device)
    gen.set_state(st.generator.get_state())
    c = st.cache
    return DecodeState(
        cache=KVCache(*(None if t is None else t.clone() for t in (c.k, c.v, c.k_scale,
                                                                   c.v_scale))),
        sampling=SamplingState(*(t.clone() for t in st.sampling.tensors())),
        **{f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)
           if f.name not in ("cache", "sampling", "generator")},
        generator=gen)


def restore_state(dst: DecodeState, src: DecodeState) -> None:
    """Copy src into dst in place (dst's tensors are a graph's static
    inputs), the generator's state too."""
    want = state_tensors(src)
    for name, t in state_tensors(dst).items():
        t.copy_(want[name])
    dst.generator.set_state(src.generator.get_state())


def full_width_state(engine, sampled: bool, seed: int) -> DecodeState:
    """A fresh decode state of the engine's slot count with every slot live
    at the phase-3 ragged write positions (0 ... 1046): a random cache (int8
    rows and positive scales under kv_int8), random last tokens below the
    stop token, n_generated 1, and greedy or sampled rows (temperature 0.8,
    top-p 0.9, top-k 50, repetition penalty 2)."""
    g, dev = engine.gpt_config, engine.device
    de = engine.decode_engine
    st = init_decode_state(g, de.num_slots, seed=seed,
                           dtype=engine.cache_dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = st.cache
    if c.quantized:
        for t in (c.k, c.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev, dtype=torch.int8))
        for t in (c.k_scale, c.v_scale):
            t.copy_(0.005 + 0.02 * torch.rand(t.shape, generator=gen, device=dev))
    else:
        for t in (c.k, c.v):
            t.copy_(0.5 * torch.randn(t.shape, generator=gen, device=dev))
    s = de.num_slots
    st.seq_lens.copy_(torch.tensor(WRITE_POS_SETS["ragged"][:s], dtype=torch.int32))
    st.audio_pos.fill_(1)
    st.n_generated.fill_(1)
    st.last_token.copy_(torch.randint(0, g.stop_audio_token, (s,), generator=gen, device=dev))
    st.tokens_buf[:, 0] = st.last_token
    st.active.fill_(True)
    sp = st.sampling
    sp.do_sample.fill_(sampled)
    sp.temperature.fill_(0.8)
    sp.top_p.fill_(0.9)
    sp.top_k.fill_(50)
    sp.repetition_penalty.fill_(2.0)
    sp.seen[torch.arange(s, device=dev), st.last_token.long()] = True
    return st


def check_graph_blocks(engine, tag: str, smi: str) -> None:
    """A 16-step and a 13-step block (the young one), greedy and with the
    generator's own draws, through the engine's captured program and
    eagerly (`decode_steps_status`) from one cloned full-width state: every
    tensor of the state (tokens, latents, KV rows and int8 scales, the
    sampling rows, the counters), the packed status and the generator's
    state must be bit-equal. The program is captured on the first call
    (an eager block on a copy), the copy is restored in place and the
    second call replays."""
    de = engine.decode_engine
    home = de.state
    host = torch.empty((de.num_slots,), dtype=torch.int32, pin_memory=True)
    for n_steps in (de.steps_per_sync, de.stream_block_steps):
        for sampled in (False, True):
            s0 = full_width_state(engine, sampled, seed=70 + n_steps)
            graphed, eager = clone_state(s0), clone_state(s0)
            de.state = graphed
            de._decode_block(n_steps, None, None, host)
            restore_state(graphed, s0)
            replays = graphs.counts["replays"]
            de._decode_block(n_steps, None, None, host)
            torch.cuda.synchronize()
            if graphs.counts["replays"] != replays + 1:
                raise AssertionError(f"{tag}: the second block did not replay a graph")
            want = decode_steps_status(de.params, de._cfg_for(None, None), eager, n_steps).cpu()
            got_t, want_t = state_tensors(graphed), state_tensors(eager)
            differ = [name for name in got_t if not torch.equal(got_t[name], want_t[name])]
            if not torch.equal(host, want):
                differ.append("packed status")
            if not torch.equal(graphed.generator.get_state(), eager.generator.get_state()):
                differ.append("generator state")
            moved = int((eager.n_generated - s0.n_generated).sum())
            say(f"  {tag} block of {n_steps} steps, {'sampled' if sampled else 'greedy'}: graph "
                f"vs eager over {len(got_t)} state tensors, the packed status and the generator "
                f"({moved} tokens generated): "
                f"{'bit-equal' if not differ else 'DIFFER in ' + ', '.join(differ)}")
            if differ:
                raise AssertionError(f"{tag} graph block differs from eager: {differ}")
            del s0, graphed, eager
    de.state = home


def check_graph_vocoders(engine) -> None:
    """The batcher's vocoder programs against the eager functions, PCM 0
    steps apart: seg_first at B = 1 and 8, seg at B = 1 and 4, the row
    vocoder in every bucket at B = 1 and 4, each on two sets of random
    rows (the second replays the program the first captured or
    replayed)."""
    g, dev = engine.gpt_config, engine.device
    t_max = g.max_audio_tokens
    gen = torch.Generator(device=dev).manual_seed(33)
    rng = np.random.default_rng(33)
    buckets = sorted({engine.row_bucket(n) for n in range(1, t_max + 1)})
    cases = ([("seg_first", b, None) for b in (1, _VocodeBatcher.SEG_FIRST_MAX_BATCH)]
             + [("seg", b, None) for b in (1, _VocodeBatcher.MAX_BATCH)]
             + [("row", b, bucket) for bucket in buckets for b in (1, _VocodeBatcher.MAX_BATCH)])
    worst = 0
    for kind, b, bucket in cases:
        for _ in range(2):
            rows = [torch.randn((t_max, g.hidden_size), generator=gen, device=dev)
                    for _ in range(b)]
            spk = [rng.standard_normal((1, 512)).astype(np.float32) * 0.1 for _ in range(b)]
            if kind == "row":
                top = min(bucket - 4, t_max)
                ns = [top] + [int(x) for x in rng.integers(1, top + 1, b - 1)]
                arg = bucket
                want = engine._rows_pcm(torch.stack(rows), engine._lanes(ns),
                                        engine._speaker_rows(spk), bucket)
            elif kind == "seg":
                ns = [int(x) for x in rng.integers(1, t_max + 1, b)]
                arg = [engine._seg_slice_start(int(x))
                       for x in rng.integers(0, engine._bucket_pf, b)]
                want = engine._vocode_seg(torch.stack(rows), ns, arg, spk)
            else:
                ns = [int(x) for x in rng.integers(1, min(64, t_max) + 1, b)]
                arg = None
                want = engine._vocode_seg_first(torch.stack(rows), ns, spk)
            got = engine._vocode_batch(kind, rows, ns, spk, arg)
            want = want.cpu().numpy()
            if got.shape != want.shape:
                raise AssertionError(f"vocoder {kind} B={b}: shape {got.shape} != {want.shape}")
            worst = max(worst, int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()))
            if worst:
                raise AssertionError(f"vocoder {kind} bucket={bucket} B={b}: graph PCM "
                                     f"{worst} steps from eager")
    say(f"  vocoder programs vs eager: {len(cases)} keys (seg_first B = 1, 8; seg B = 1, 4; "
        f"rows in buckets {buckets} at B = 1, 4), two batches each: PCM {worst} steps apart")


def timed_calls(obj, names: tuple) -> dict:
    """Wrap the methods `names` of `obj` so each call records (seconds to
    the card's completion, memory_reserved before, after) under its name in
    the returned dict; `del obj.<name>` restores a method."""
    out = {}
    for name in names:
        def wrapper(*args, _fn=getattr(obj, name), _name=name, **kwargs):
            torch.cuda.synchronize()
            before, t0 = torch.cuda.memory_reserved(), time.perf_counter()
            _fn(*args, **kwargs)
            torch.cuda.synchronize()
            out[_name] = (time.perf_counter() - t0, before, torch.cuda.memory_reserved())
        setattr(obj, name, wrapper)
    return out


# the insert programs at full width: the single insert and bursts of K = 2,
# 4, 8 in every prefill bucket (the JAX runner's precompile_inserts set)
INSERT_KEYS = len(PREFILL_BUCKETS) * (1 + len(DecodeEngine._INSERT_K_BUCKETS))


def pool_gib(pool) -> float:
    """GiB that the allocator holds for one graph memory pool (its
    segments in `torch.cuda.memory_snapshot`)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool)) / 2**30


def run_graphs(dev, smi: str, tokenizer) -> dict:
    """Phase 4g: the captured programs on the full-width bf16 (K2) and int8
    (K4) engines of phases 4 and 4b. Per engine, `precompile_decode_programs`
    (and on bf16 `precompile_vocoder_buckets`) with its time, captures,
    capture and instantiation seconds and memory_reserved before and
    after, the decode blocks (`DecodeEngine.precompile`) and the insert and
    migrate programs (`precompile_inserts`) apart; then the decode blocks
    against eager (check_graph_blocks) and, on bf16, the vocoder programs
    (check_graph_vocoders). Returns the engines, which phase 4h reuses."""
    engines = {}
    for tag, gpt_flags, engine_flags in (
            ("bf16", {"flash_decode": True, "prefill_flash": True}, {}),
            ("int8", {"prefill_flash": True, "ragged_decode": True},
             {"kv_int8": True, "decode_w8a8": True, "prefill_w8a8": True})):
        torch.cuda.empty_cache()
        engine = build_engine(dev, tokenizer, gpt_flags, engine_flags)
        de = engine.decode_engine
        torch.cuda.synchronize()
        start = torch.cuda.memory_reserved()
        hooks = [("decode", engine.precompile_decode_programs)]
        if tag == "bf16":
            hooks.append(("vocoder", engine.precompile_vocoder_buckets))
        for name, hook in hooks:
            graphs.reset_counts()
            parts = timed_calls(de, ("precompile", "precompile_inserts"))
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            hook()
            torch.cuda.synchronize()
            del de.precompile, de.precompile_inserts
            c = graphs.counts
            say(f"  {tag} precompile ({name}): {time.perf_counter() - t0:.1f} s, graphs "
                f"{graphs_text(c)}; memory reserved {reserved / 2**30:.2f} -> "
                f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB ({smi})")
            for part, kinds in (("precompile", ("decode",)),
                                ("precompile_inserts", ("insert", "burst", "migrate"))):
                if part in parts:
                    secs, before, after = parts[part]
                    say(f"    {part}: {secs:.1f} s, memory reserved {before / 2**30:.2f} -> "
                        f"{after / 2**30:.2f} GiB; " + "; ".join(
                            f"{k} {c.get(k + '.captures', 0)} captured in "
                            f"{c.get(k + '.capture_s', 0.0):.2f} s (capture + instantiate)"
                            for k in kinds))
        if tag == "bf16":
            # both hooks on a fresh engine: what TTS.warmup()'s captures
            # reserve, against the slot fit's estimate (accepted: not below
            # the growth, at most 1.5x it)
            grown = torch.cuda.memory_reserved() - start
            say(f"  {tag} both precompile hooks on a fresh engine: memory reserved +"
                f"{grown / 2**30:.2f} GiB, of it the graph pools: decode state (blocks and "
                f"inserts) {pool_gib(de._programs.pool):.2f} GiB, vocoder "
                f"{pool_gib(engine._vocoder_programs.pool):.2f} GiB; the slot fit's pool estimate "
                f"{engine.pool_bytes / 2**30:.2f} GiB ({engine.pool_bytes / grown:.2f}x; accepted "
                f"1.0-1.5x) ({smi})")
            if engine.pool_bytes < grown:
                raise AssertionError(f"4g: pool estimate {engine.pool_bytes} below the "
                                     f"precompile growth {grown}")
        if len(decode_keys(de)) != len(de.precompile_keys()):
            raise AssertionError(f"{tag}: precompile captured {len(decode_keys(de))} of "
                                 f"{len(de.precompile_keys())} decode keys")
        others = [k for k in de._programs.keys() if graphs.kind_of(k) != "decode"]
        if (sum(k[0] in ("insert", "burst") for k in others) != INSERT_KEYS
                or ("migrate",) not in others):
            raise AssertionError(f"{tag}: precompile_decode_programs captured {others}, not "
                                 f"the {INSERT_KEYS} insert programs and migrate_slot")
        check_graph_blocks(engine, tag, smi)
        if tag == "bf16":
            check_graph_vocoders(engine)
        engines[tag] = engine
    return engines


# ------------------------------------------------- inserts and conditioning
INSERT_SAMPLED = SamplingOptions(temperature=0.75, top_p=0.85, top_k=50, repetition_penalty=5.0,
                                 do_sample=True, max_new_tokens=300)
INSERT_GREEDY = dataclasses.replace(INSERT_SAMPLED, do_sample=False)
# phase 4h's bursts: non-contiguous slots of the 8-slot state
BURST_SLOTS = {2: [6, 1], 4: [7, 2, 5, 0], 8: [3, 7, 0, 5, 2, 6, 1, 4]}


def opt_args(o: SamplingOptions) -> tuple:
    return (o.temperature, o.top_p, o.top_k, o.repetition_penalty, o.do_sample,
            o.max_new_tokens)


def insert_prompt(g, dev, bucket: int, seed: int) -> tuple:
    """(cond [C, D] f32 on the card, ids [bucket - C] int64, n_ids): a
    prompt that fills most of prefill bucket `bucket`."""
    rng = np.random.default_rng(seed)
    tb = bucket - g.num_cond_latents
    n = tb - 1 - int(rng.integers(0, min(16, tb - 2)))
    ids = np.zeros((tb,), np.int64)
    ids[:n] = rng.integers(5, g.number_text_tokens - 1, n)
    cond = (0.3 * rng.standard_normal((g.num_cond_latents, g.hidden_size))).astype(np.float32)
    return torch.from_numpy(cond).to(dev), ids, n


def check_insert_programs(engine, tag: str, smi: str) -> None:
    """Every insert program and migrate_slot of a fresh engine against the
    module functions, from one cloned full-width state per side (every slot
    live at the ragged write positions): `precompile_inserts` captures the
    programs on the graph side's state (zero prompts, greedy, slots 0..K-1,
    migrate 0 -> 0), then each case replays one with other values and the
    eager side runs `insert_sequence_tokens` / `insert_sequences_tokens` /
    `migrate_slot` with them: a single insert at every prefill bucket into
    slot 5, sampled and greedy; bursts of K = 2, 4, 8 at buckets 128 and
    512 into non-contiguous slots, lanes sampled and greedy in turn; one
    migration 6 -> 1. Every state tensor (KV rows and int8 scales, sampling
    and seen rows, counters, tokens, latents) and the generator's state
    must be bit-equal, and every case must replay. Then ms per chunk of the
    single insert at bucket 128 and of each burst at bucket 128, eager and
    graph."""
    g, p, dev, de = engine.gpt_config, engine.params, engine.device, engine.decode_engine
    home = de.state
    s0 = full_width_state(engine, True, seed=90)
    graphed, eager = clone_state(s0), clone_state(s0)
    de.state = graphed
    de.precompile_inserts(g.num_cond_latents)
    say(f"  {tag}: precompile_inserts on the graph side's state: "
        f"{len(de._programs.keys())} programs captured")

    def case(name: str, graph_fn, eager_fn) -> None:
        restore_state(graphed, s0)
        restore_state(eager, s0)
        replays = graphs.counts["replays"]
        graph_fn()
        eager_fn()
        torch.cuda.synchronize()
        got_t, want_t = state_tensors(graphed), state_tensors(eager)
        differ = [n for n in got_t if not torch.equal(got_t[n], want_t[n])]
        if not torch.equal(graphed.generator.get_state(), eager.generator.get_state()):
            differ.append("generator state")
        if graphs.counts["replays"] != replays + 1:
            differ.append("no replay")
        say(f"  {tag} {name}: graph vs eager over {len(got_t)} state tensors and the "
            f"generator: {'bit-equal' if not differ else 'DIFFER in ' + ', '.join(differ)}")
        if differ:
            raise AssertionError(f"{tag} {name}: the program differs from eager: {differ}")

    for i, bucket in enumerate(PREFILL_BUCKETS):
        for opts in (INSERT_SAMPLED, INSERT_GREEDY):
            cond, ids, n = insert_prompt(g, dev, bucket, seed=100 + i)
            ids_dev = torch.from_numpy(ids).to(dev)
            case(f"single insert, bucket {bucket} ({n} ids), slot 5, "
                 f"{'sampled' if opts.do_sample else 'greedy'}",
                 lambda: de._insert_tokens([cond], ids[None], [n], [5], [opts]),
                 lambda: insert_sequence_tokens(p, g, eager, cond, ids_dev, n, 5,
                                                *opt_args(opts)))
    for bucket in (128, 512):
        for k, slots in BURST_SLOTS.items():
            prompts = [insert_prompt(g, dev, bucket, seed=200 + 10 * k + j) for j in range(k)]
            conds, ns = [c for c, _, _ in prompts], [n for _, _, n in prompts]
            ids = np.stack([x for _, x, _ in prompts])
            ids_dev = torch.from_numpy(ids).to(dev)
            opts = [dataclasses.replace(INSERT_SAMPLED, temperature=0.6 + 0.1 * j,
                                        top_k=50 - j, do_sample=j % 2 == 0,
                                        max_new_tokens=100 + j) for j in range(k)]
            lanes = list(zip(*(opt_args(o) for o in opts)))
            case(f"burst K={k}, bucket {bucket}, slots {slots}",
                 lambda: de._insert_tokens(conds, ids, ns, slots, opts),
                 lambda: insert_sequences_tokens(p, g, eager, torch.stack(conds), ids_dev, ns,
                                                 slots, *lanes))
    case("migrate_slot 6 -> 1", lambda: de._migrate(6, 1), lambda: migrate_slot(eager, 6, 1))

    cond, ids, n = insert_prompt(g, dev, 128, seed=300)
    ids_dev = torch.from_numpy(ids).to(dev)
    times = [("single insert", 1, wall_ms(lambda: insert_sequence_tokens(
        p, g, eager, cond, ids_dev, n, 5, *opt_args(INSERT_SAMPLED))),
        wall_ms(lambda: de._insert_tokens([cond], ids[None], [n], [5], [INSERT_SAMPLED])))]
    for k, slots in BURST_SLOTS.items():
        prompts = [insert_prompt(g, dev, 128, seed=400 + j) for j in range(k)]
        conds, ns = [c for c, _, _ in prompts], [x for _, _, x in prompts]
        ids_k = np.stack([x for _, x, _ in prompts])
        ids_k_dev = torch.from_numpy(ids_k).to(dev)
        lanes = list(zip(*(opt_args(INSERT_SAMPLED) for _ in range(k))))
        times.append((f"burst K={k}", k, wall_ms(lambda: insert_sequences_tokens(
            p, g, eager, torch.stack(conds), ids_k_dev, ns, slots, *lanes)),
            wall_ms(lambda: de._insert_tokens(conds, ids_k, ns, slots, [INSERT_SAMPLED] * k))))
    for name, k, eager_ms, graph_ms in times:
        say(f"  {tag} {name} at bucket 128: eager {eager_ms / k:.2f} ms per chunk, graph "
            f"{graph_ms / k:.2f} ms per chunk (host wall to the card's completion, median of "
            f"3) ({smi})")
    de.state = home
    del s0, graphed, eager


def check_cond_programs(engine, smi: str) -> None:
    """The conditioning programs against the eager functions on the card:
    get_gpt_cond_latents (one 22.05 kHz chunk) and the speaker embedding
    (16 kHz) of a 6 s and a 3 s reference, each called twice through the
    programs (the first call runs eagerly and captures, the second
    replays) and once through `_cond_latents` / `_speaker_dvector`: bit-equal
    on the host; ms per call, eager and graph (host wall, median of 3)."""
    dev = engine.device
    rng = np.random.default_rng(95)
    for seconds in (6, 3):
        wav22 = (0.3 * rng.standard_normal((1, 22050 * seconds))).astype(np.float32)
        wav16 = (0.3 * rng.standard_normal((1, 16000 * seconds))).astype(np.float32)

        def eager_c():
            return engine._cond_latents(torch.from_numpy(wav22).to(dev)).float().cpu().numpy()

        def eager_s():
            return engine._speaker_dvector(torch.from_numpy(wav16).to(dev)).float().cpu().numpy()

        replays = graphs.counts["replays"]
        got = [(engine.get_gpt_cond_latents(wav22), engine._speaker_embedding(wav16))
               for _ in range(2)]
        want = (eager_c(), eager_s())
        same = all(np.array_equal(gc, want[0]) and np.array_equal(gs, want[1]) for gc, gs in got)
        replayed = graphs.counts["replays"] - replays
        ms = [wall_ms(eager_c), wall_ms(lambda: engine.get_gpt_cond_latents(wav22)),
              wall_ms(eager_s), wall_ms(lambda: engine._speaker_embedding(wav16))]
        say(f"  conditioning, {seconds} s reference: cond latents {want[0].shape} and d-vector "
            f"{want[1].shape}, programs vs eager {'bit-equal' if same else 'DIFFER'} "
            f"({replayed} replays in the second calls); cond latents eager {ms[0]:.2f} ms, "
            f"graph {ms[1]:.2f} ms; speaker embedding eager {ms[2]:.2f} ms, graph "
            f"{ms[3]:.2f} ms ({smi})")
        if not same or replayed != 2:
            raise AssertionError(f"conditioning {seconds} s: bit-equal {same}, replays {replayed}")
    say(f"  conditioning programs: {sorted(engine._cond_programs.keys())}")


def run_insert_programs(engines: dict, smi: str) -> None:
    """Phase 4h: the insert, burst, migrate and conditioning programs on
    phase 4g's engines against the module functions (check_insert_programs
    per engine, check_cond_programs on bf16)."""
    for tag, engine in engines.items():
        graphs.reset_counts()
        check_insert_programs(engine, tag, smi)
        if tag == "bf16":
            check_cond_programs(engine, smi)
        say(f"  {tag}: graphs {graphs_text(graphs.counts)}")


# ------------------------------------------------------------- parallel
REPLICA_TOKENS = 100  # tokens a chunk in phase 7a's requests
TP_STEPS = 64  # phase 7b's teacher-forced decode steps
# phase 7b: the model-sharded engine against the unsharded one on one card,
# teacher-forced (both read the same tokens), bf16 throughout. The shards sum
# their f32 partials of each row-parallel product where the unsharded
# product accumulates in one GEMM, so the residual stream parts at bf16
# rounding. Calibrated on an NVIDIA H100 80GB HBM3 (700 W): 35.0-36.1 dB on
# inserts, hidden states and logits over the 64 steps, so the floor leaves
# 5 dB; a shard that summed the wrong heads or lanes lands near 0 dB
TP_SNR_FLOOR_DB = 30.0


def snr_db_np(ref: np.ndarray, got: np.ndarray) -> float:
    noise = float(np.sum((got.astype(np.float64) - ref.astype(np.float64)) ** 2))
    return float("inf") if noise == 0 else 10 * math.log10(
        float(np.sum(ref.astype(np.float64) ** 2)) / noise)


class HeadsSeen:
    """Wraps a kernel wrapper where gpt.py calls it and records the head
    count of every call (the wrapped function still counts its launches)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.heads: set = set()

    def __enter__(self):
        def call(q, *args, **kwargs):
            self.heads.add(int(q.shape[1]))
            return self.real(q, *args, **kwargs)

        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def replica_replays(engine) -> list:
    """Per replica: replays of its decode-state programs and of its vocoder
    programs."""
    return [(e.decode_engine._programs.replays(), e._vocoder_programs.replays())
            for e in engine.engines]


def run_replicas(dev, smi: str, tokenizer) -> dict:
    """Phase 7a: two replicas of the full-width bf16 engine on one card
    behind the facade (ReplicatedTTSEngine.from_engine with devices [cuda:0,
    cuda:0]). A cold burst of 4 concurrent requests captures both replicas'
    programs lazily at once; TTS.warmup(), forwarded to both, is timed with
    memory_reserved beside the estimate; the burst again replays each
    replica's programs in its own pools; a greedy request on replica 1
    against the donor alone; the replica count on this card's default
    devices. Returns the kernel launches of the drives."""
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_voice(tmp)
        torch.cuda.empty_cache()
        donor = build_engine(dev, tokenizer, {"flash_decode": True, "prefill_flash": True}, {})
        engine = ReplicatedTTSEngine.from_engine(donor, devices=[dev, dev])
        rep = engine.engines[1]
        say(f"  replicas: {len(engine.engines)} on {dev}; slots {[e.decode_slots for e in engine.engines]}, "
            f"memory plans {[round(e.max_gb_for_model, 2) for e in engine.engines]} GiB (pools "
            f"{[round(e.pool_bytes / 2**30, 2) for e in engine.engines]} GiB each); replica 1 "
            f"shares the donor's weights: {rep.params['wte'] is donor.params['wte']}")
        if rep.params["wte"] is not donor.params["wte"]:
            raise AssertionError("replica 1 copied the donor's weights on the donor's device")
        pools = {e.decode_engine._programs.pool for e in engine.engines} | {
            e._vocoder_programs.pool for e in engine.engines}
        if len(pools) != 4:
            raise AssertionError("the replicas' program caches share a memory pool")
        tts = TTS(scheduler_max_concurrency=4).with_engine(engine)
        routes = []
        route = engine._route
        engine._route = lambda request: routes.append(route(request)) or routes[-1]

        def request(**kw):
            return TTSRequest(text=SENTENCE, speaker_files=[wav_path], language="en",
                              max_new_tokens=REPLICA_TOKENS, **kw)

        async def burst():
            return await asyncio.gather(*(tts.generate_speech_async(request())
                                          for _ in range(4)))

        for w in KERNELS.values():
            w["wrapper"].launches = 0
        launches = {}
        for tag in ("cold, lazy captures on both replicas at once", "after TTS.warmup()"):
            del routes[:]
            graphs.reset_counts()
            before = replica_replays(engine)
            t0 = time.perf_counter()
            outs = tts.loop.run_until_complete(burst())
            wall = time.perf_counter() - t0
            for i, o in enumerate(outs):
                check_waveform(f"7a {tag} request {i}", o)
            after = replica_replays(engine)
            audio = sum(o.array.size for o in outs) / 24000
            say(f"  4 concurrent requests ({tag}): routes {routes}, {audio:.2f} s audio in "
                f"{wall:.2f} s; graphs {graphs_text(graphs.counts)}; replays per replica "
                f"(decode-state programs, vocoder programs) "
                f"{[(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)]} ({smi})")
            if sorted(set(routes)) != [0, 1]:
                raise AssertionError(f"7a {tag}: routes {routes} did not use both replicas")
            if tag != "after TTS.warmup()":
                torch.cuda.synchronize()
                reserved = torch.cuda.memory_reserved()
                estimate = sum(e.pool_bytes for e in engine.engines)
                t0 = time.perf_counter()
                tts.warmup(text="Hello world, this is a test of speech. The quick brown fox "
                                "jumps over the lazy dog.")
                torch.cuda.synchronize()
                grown = torch.cuda.memory_reserved() - reserved
                say(f"  TTS.warmup() on both replicas: {time.perf_counter() - t0:.1f} s; memory "
                    f"reserved {reserved / 2**30:.2f} -> {torch.cuda.memory_reserved() / 2**30:.2f}"
                    f" GiB (+{grown / 2**30:.2f}), the replicas' pool estimates "
                    f"{estimate / 2**30:.2f} GiB ({estimate / max(grown, 1):.2f}x the growth; "
                    f"the cold burst captured part of it) ({smi})")
                if estimate < grown:
                    raise AssertionError(f"7a: pool estimate {estimate} below the warmup's "
                                         f"growth {grown}")
            else:
                for i, (a, b) in enumerate(zip(after, before)):
                    if a[0] <= b[0] or a[1] <= b[1]:
                        raise AssertionError(f"7a: replica {i}'s programs did not replay "
                                             f"({b} -> {a})")
        launches = {name: w["wrapper"].launches for name, w in KERNELS.items()}

        # exactness: one greedy request on replica 1 against the donor alone
        async def tokens_of(e):
            handles, _, _, _ = await e.get_generation_context(request(do_sample=False))
            return [np.asarray((await h)[0]) for h in handles]

        got_tokens = tts.loop.run_until_complete(tokens_of(rep))
        want_tokens = tts.loop.run_until_complete(tokens_of(donor))
        engine._route = lambda r: 1
        got = tts.generate_speech(request(do_sample=False))
        engine._route = lambda r: 0
        want = tts.generate_speech(request(do_sample=False))
        steps, share = pcm_diff(got.array, want.array)
        say(f"  greedy request on replica 1 against the donor: tokens "
            f"{'equal' if all(np.array_equal(a, b) for a, b in zip(got_tokens, want_tokens)) else 'DIFFER'}"
            f" ({[len(t) for t in got_tokens]} per chunk); waveform largest difference {steps} PCM "
            f"steps, {share:.4%} of samples differ")
        if len(got_tokens) != len(want_tokens) or not all(
                np.array_equal(a, b) for a, b in zip(got_tokens, want_tokens)):
            raise AssertionError("7a: replica 1's greedy tokens differ from the donor's")
        if got.array.shape != want.array.shape or steps > 1:
            raise AssertionError(f"7a: replica 1's waveform is {steps} PCM steps from the donor's")
        warned = []
        log_warning = replica_logger.warning
        replica_logger.warning = lambda msg, *a: (warned.append(msg % a), log_warning(msg, *a))
        try:
            one = ReplicatedTTSEngine.from_engine(donor, n_replicas=2)
        finally:
            replica_logger.warning = log_warning
        say(f"  from_engine(n_replicas=2) on this card's default devices "
            f"({torch.cuda.device_count()} GPU): {len(one.engines)} replica; logged: {warned}")
        if len(one.engines) != torch.cuda.device_count() or not warned:
            raise AssertionError("7a: n_replicas above the device count was not truncated and logged")
        tts.loop.run_until_complete(tts.shutdown())
        del tts, engine, donor, rep, one
    say(f"  launches during the replica drives: {launches}")
    for name in BF16_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by phase 7a's replicas")
    return launches


def tp_prompts(cfg, dev, n: int) -> list:
    """n (cond, ids) prompts from a seed: 32 conditioning latents of unit
    scale and 40-70 text ids, one prefill bucket (128)."""
    g = torch.Generator(device="cpu").manual_seed(7)
    out = []
    for i in range(n):
        cond = 0.5 * torch.randn((cfg.num_cond_latents, cfg.hidden_size), generator=g)
        ids = torch.randint(5, 200, (40 + 10 * i,), generator=g).numpy().astype(np.int32)
        out.append(TokenPrompt(cond=cond.to(dev), ids=ids))
    return out


def tp_against_unsharded(dev, smi: str, params, cfg, mesh, tag: str, decode_kernel: str) -> dict:
    """DecodeEngine on `mesh` (two model shards on one card) beside the
    unsharded engine, full width: 4 single inserts through each runner's
    insert programs, then TP_STEPS teacher-forced steps (both fed the
    unsharded engine's greedy tokens), hidden states and logits against
    the unsharded engine as an SNR above TP_SNR_FLOOR_DB; K1 and the decode
    kernel must launch at 8 heads; a 16-step block on the mesh must replay
    as a graph. Under kv_int8 layer 0's int8 rows and scales of the prompts
    (written from the same embeddings on both sides) must be bit-equal,
    and those the forced steps appended are reported."""
    greedy = SamplingOptions(temperature=1.0, top_p=1.0, top_k=1, repetition_penalty=1.0,
                             do_sample=False)
    torch.cuda.empty_cache()
    with HeadsSeen(gpt_module, "prefill_flash_attention") as k1, \
            HeadsSeen(gpt_module, decode_kernel) as kd:
        one = DecodeEngine(params, cfg, num_slots=8, cache_dtype=torch.bfloat16, device=dev)
        tp = DecodeEngine(params, cfg, num_slots=8, cache_dtype=torch.bfloat16, device=dev,
                          mesh=mesh)
        shards = tp.state.cache.shards
        say(f"  {tag}: mesh {mesh}; shard caches {[tuple(c.k.shape) for c in shards]} "
            f"{shards[0].k.dtype}; qkv per shard "
            f"{tuple(tp.params.shards[0]['blocks']['attn_w'].shape)}")
        prompts = tp_prompts(cfg, dev, 4)
        graphs.reset_counts()
        for de in (one, tp):
            with de._state_lock:
                for slot, p in enumerate(prompts):
                    de._insert(type("P", (), {"prompt": p, "options": greedy})(), slot)
        torch.cuda.synchronize()
        inserts = dict(graphs.counts)
        s = 4
        lat_one = one.state.latents_buf[:s, 0].float().cpu().numpy()
        lat_tp = tp.state.latents_buf[:s, 0].float().cpu().numpy()
        snr_insert = snr_db_np(lat_one, lat_tp)
        st1, st2 = one.state, tp.state
        prompt_rows = None
        if cfg.kv_int8:
            prompt_rows = all(layer0_equal(st1.cache, st2.cache, slot, 0, p.length)
                              for slot, p in enumerate(prompts))
        # teacher forcing: both engines read the unsharded engine's greedy
        # tokens, step by step
        h_snr, l_snr = [], []
        tokens = st1.last_token[:s].clone()
        pos, lens = st1.audio_pos[:s].clone(), st1.seq_lens[:s].clone()
        start = lens.clone()
        t0 = time.perf_counter()
        for _ in range(TP_STEPS):
            h1 = gpt_decode_step(one.params, cfg, tokens, pos, lens, st1.cache)
            h2 = gpt_decode_step(tp.params, cfg, tokens, pos, lens, st2.cache)
            lg1, _ = heads(one.params, h1)
            lg2, _ = heads(tp.params, h2)
            h_snr.append(snr_db_np(h1.float().cpu().numpy(), h2.float().cpu().numpy()))
            l_snr.append(snr_db_np(lg1.cpu().numpy(), lg2.cpu().numpy()))
            tokens = lg1.argmax(dim=-1).to(torch.int32)
            pos, lens = pos + 1, lens + 1
        torch.cuda.synchronize()
        forced_s = time.perf_counter() - t0
        appended = None
        if cfg.kv_int8:
            appended = sum(layer0_equal(st1.cache, st2.cache, slot, int(start[slot]),
                                        int(lens[slot])) for slot in range(s))
        # the same slots' state moved on by hand: a graph block on the mesh
        for st in (st1, st2):
            st.seq_lens[:s], st.audio_pos[:s], st.last_token[:s] = lens, pos, tokens
        graphs.reset_counts()
        for _ in range(2):
            tp._decode_block(16, None, None, tp._status_bufs[0])
        torch.cuda.synchronize()
        block = dict(graphs.counts)
        t0 = time.perf_counter()
        for _ in range(3):
            tp._decode_block(16, None, None, tp._status_bufs[0])
        torch.cuda.synchronize()
        block_ms = (time.perf_counter() - t0) / 3 / 16 * 1e3
        for _ in range(2):
            one._decode_block(16, None, None, one._status_bufs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            one._decode_block(16, None, None, one._status_bufs[0])
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) / 3 / 16 * 1e3
    say(f"  {tag}: 4 single inserts per engine (insert programs: {graphs_text(inserts)}); first "
        f"latents SNR {snr_insert:.1f} dB; {TP_STEPS} teacher-forced steps ({forced_s:.1f} s, "
        f"both engines eager): hidden state SNR min {min(h_snr):.1f} / median "
        f"{statistics.median(h_snr):.1f} dB, logits SNR min {min(l_snr):.1f} / median "
        f"{statistics.median(l_snr):.1f} dB (floor {TP_SNR_FLOOR_DB} dB); K1 heads "
        f"{sorted(k1.heads)}, {decode_kernel} heads {sorted(kd.heads)} ({smi})")
    if cfg.kv_int8:
        say(f"  {tag}: layer 0's int8 rows and scales of the 4 prompts (each shard's copy of the "
            f"scales) {'bit-equal' if prompt_rows else 'DIFFER'} to the unsharded engine's; of "
            f"the rows the {TP_STEPS} forced steps appended at layer 0, {appended} of {s} slots' "
            f"bit-equal")
    say(f"  {tag}: 16-step blocks on the mesh as graphs: {graphs_text(block)}; {block_ms:.3f} ms "
        f"a step (two shards on one card) against {one_ms:.3f} unsharded, wall with the status "
        f"copy ({smi})")
    if min(min(h_snr), min(l_snr), snr_insert) < TP_SNR_FLOOR_DB:
        raise AssertionError(f"7b {tag}: SNR below {TP_SNR_FLOOR_DB} dB")
    half = cfg.num_attention_heads // 2
    if half not in k1.heads or half not in kd.heads:
        raise AssertionError(f"7b {tag}: K1 heads {k1.heads}, {decode_kernel} heads {kd.heads}: "
                             f"no launch at {half} heads")
    if block.get("decode.replays", 0) < 1:
        raise AssertionError(f"7b {tag}: the mesh's decode block did not replay as a graph")
    if prompt_rows is False:
        raise AssertionError(f"7b {tag}: layer 0's int8 rows or scales differ under the mesh")
    return {"h_snr": min(h_snr), "l_snr": min(l_snr), "block_ms": block_ms, "one_ms": one_ms}


def layer0_equal(plain, sharded, slot: int, lo: int, hi: int) -> bool:
    """Layer 0's int8 K/V rows [lo, hi) of `slot`, the model shards' lanes
    side by side, and every shard's copy of their scales, bit-equal to the
    unsharded cache's."""
    k = torch.cat([c.k[0, slot, lo:hi] for c in sharded.shards], dim=-1)
    v = torch.cat([c.v[0, slot, lo:hi] for c in sharded.shards], dim=-1)
    return (torch.equal(k, plain.k[0, slot, lo:hi]) and torch.equal(v, plain.v[0, slot, lo:hi])
            and all(torch.equal(c.k_scale[0, slot, lo:hi], plain.k_scale[0, slot, lo:hi])
                    and torch.equal(c.v_scale[0, slot, lo:hi], plain.v_scale[0, slot, lo:hi])
                    for c in sharded.shards))


def run_tensor_parallel(dev, smi: str) -> dict:
    """Phase 7b: DecodeEngine on a mesh of two model shards on one card
    (make_mesh(devices=[cuda:0, cuda:0], model=2)) beside the unsharded
    engine, full width (tp_against_unsharded): the bf16 KV configuration
    (K1, K2) and the int8 one with ragged decode attention (K1, K4 at 8
    heads given the whole row's scales). Then the dense int8 body on the
    same mesh: layer 0's int8 rows and scales of a prompt bit-equal to the
    unsharded engine's. Then 7c: the refusal. Returns the kernel
    launches."""
    params, _ = params_from_numpy(*seed0_weights(), device=dev, dtype=torch.bfloat16)
    mesh = make_mesh([dev, dev], data=1, model=2)
    base = XTTSConfig().gpt
    for w in KERNELS.values():
        w["wrapper"].launches = 0
    tp_against_unsharded(dev, smi, params,
                         dataclasses.replace(base, flash_decode=True, prefill_flash=True), mesh,
                         "bf16 KV, K1 + K2", "flash_decode_append_attention")
    tp_against_unsharded(dev, smi, params,
                         dataclasses.replace(base, prefill_flash=True, kv_int8=True,
                                             ragged_decode=True), mesh,
                         "int8 KV, K1 + K4", "ragged_decode_attention")
    launches = {name: w["wrapper"].launches for name, w in KERNELS.items()}
    torch.cuda.empty_cache()

    # the dense int8 body on the same mesh: layer 0's rows and scales
    greedy = SamplingOptions(temperature=1.0, top_p=1.0, top_k=1, repetition_penalty=1.0,
                             do_sample=False)
    prompt = tp_prompts(base, dev, 1)[0]
    icfg = dataclasses.replace(base, prefill_flash=True, kv_int8=True)
    sides = []
    for m in (None, mesh):
        de = DecodeEngine(params, icfg, num_slots=2, cache_dtype=torch.bfloat16, device=dev,
                          mesh=m)
        with de._state_lock:
            de._insert(type("P", (), {"prompt": prompt, "options": greedy})(), 1)
        torch.cuda.synchronize()
        sides.append(de.state.cache)
        del de
    plain, sharded = sides
    n = prompt.length
    equal = layer0_equal(plain, sharded, 1, 0, n)
    deep = float((sharded.shards[0].k_scale[1:, 1, :n] / plain.k_scale[1:, 1, :n] - 1)
                 .abs().max())
    say(f"  dense int8 body on the mesh, a {n}-row prompt: layer 0's int8 rows and scales "
        f"(each shard's copy) {'bit-equal' if equal else 'DIFFER'} to the unsharded engine's; "
        f"the deeper layers' scales within {deep:.2e} relative (their inputs are summed over the "
        f"shards)")
    if not equal:
        raise AssertionError("7b: layer 0's int8 rows or scales differ under the mesh")
    del sides, plain, sharded
    torch.cuda.empty_cache()

    phase("[7c] parallel refusals on this card")
    gpu_count = torch.cuda.device_count()
    try:
        core = {}  # never reached: the mesh is made first
        XTTSv2Engine(XTTSConfig(), base, params=params, core=core, device=dev,
                     tensor_parallel_size=2)
    except ValueError as e:
        say(f"  XTTSv2Engine(tensor_parallel_size=2) with {gpu_count} GPU: ValueError: {e}")
        if gpu_count >= 2 or "needs 2 devices" not in str(e):
            raise
    else:
        if gpu_count < 2:
            raise AssertionError("7c: tensor_parallel_size=2 did not raise on one GPU")
    del params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- data axes
# phase 7d: (dcn, data, model) of each mesh on cuda:0; its reference is the
# unsharded engine when model is 1, else the (1, 1, 2) mesh's engine (the
# model axis alone changes the rounding of the row-parallel sums, which 7b
# holds against the unsharded engine; the data axis changes no bit)
DATA_MESHES = {"data=2 model=1": (1, 2, 1), "data=2 model=2": (1, 2, 2),
               "dcn=2 data=1 model=2": (2, 1, 2)}
DATA_TOKENS = 100  # max_new_tokens of 7d's requests
DATA_REQUESTS = 4  # greedy TokenPrompt requests per engine, beside one embeds prompt
DATA_SLOTS = 8


def slot_tensors(state, slot: int) -> list:
    """Every tensor of one slot (per-slot fields, sampling rows, and its KV
    rows and scales in every model shard's cache), cloned."""
    if isinstance(state, DataShardedState):
        i, slot = state.locate(slot)
        state = state.shards[i]
    fields = (*state.sampling.tensors(), state.seq_lens, state.audio_pos, state.last_token,
              state.active, state.done, state.tokens_buf, state.latents_buf,
              state.n_generated)
    return [t[slot].clone() for t in fields] + [t[:, slot].clone()
                                                for t in state.cache.tensors()]


def drive_data_engine(dev, params, cfg, shape, prompts, embeds) -> dict:
    """One 8-slot DecodeEngine (slot bucketing on) on a cuda:0 mesh of
    `shape` (dcn, data, model), or unsharded (None): DATA_REQUESTS greedy
    TokenPrompt requests and one embeds prompt through `generate` at once;
    then, from one generator state, 8 sampled prompts as one burst through
    the runner's insert program and a 16-step sampled decode block through
    its decode program; on a data mesh two migrations from data shard 1 to
    data shard 0 through the migrate program (the second a replay), each
    destination bit-equal to its source."""
    mesh = None
    if shape is not None:
        dcn, data, model = shape
        mesh = make_mesh([dev] * (dcn * data * model), data=data, model=model, dcn_data=dcn)
    t0 = time.perf_counter()
    de = DecodeEngine(params, cfg, num_slots=DATA_SLOTS, cache_dtype=torch.bfloat16, device=dev,
                      mesh=mesh, slot_bucketing=True)
    greedy = SamplingOptions(temperature=1.0, top_p=1.0, top_k=1, repetition_penalty=1.0,
                             do_sample=False, max_new_tokens=DATA_TOKENS)

    async def serve():
        out = await asyncio.gather(*(de.generate(p, greedy) for p in [*prompts, embeds]))
        await de.shutdown()
        return out

    served = [np.asarray(t) for t, _, _ in asyncio.run(serve())]
    serve_s = time.perf_counter() - t0
    sampled = SamplingOptions(temperature=0.75, top_p=0.85, top_k=50, repetition_penalty=5.0,
                              do_sample=True)
    g = torch.Generator(device="cpu").manual_seed(11)
    conds = [0.5 * torch.randn((cfg.num_cond_latents, cfg.hidden_size), generator=g).to(dev)
             for _ in range(DATA_SLOTS)]
    tb = PREFILL_BUCKETS[1] - cfg.num_cond_latents  # one prefill bucket, 128
    ids = torch.randint(5, 200, (DATA_SLOTS, tb), generator=g).numpy()
    with de._state_lock:
        de.state.generator.set_state(torch.Generator(device=dev).manual_seed(5).get_state())
        de._insert_tokens(conds, ids, [60] * DATA_SLOTS, list(range(DATA_SLOTS)),
                          [sampled] * DATA_SLOTS)
        de._decode_block(16, None, None, de._status_bufs[0])
    torch.cuda.synchronize()
    state = de.state
    field = state.field if isinstance(state, DataShardedState) else (
        lambda name: getattr(state.sampling if hasattr(state.sampling, name) else state, name))
    block = {name: field(name).cpu() for name in ("tokens_buf", "n_generated", "seen")}
    migrated = None
    if isinstance(state, DataShardedState):
        migrated = []
        with de._state_lock:
            de._release_state([1, 2])
            for src, dst in ((6, 1), (5, 2)):
                want = slot_tensors(state, src)
                de._migrate(src, dst)
                got = slot_tensors(state, dst)
                migrated.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
    out = {"served": served, "block": block, "migrated": migrated, "serve_s": serve_s,
           "graphs": dict(graphs.counts), "stats": dict(de.stats)}
    del de, state
    torch.cuda.empty_cache()
    return out


def run_data_axes(dev, smi: str) -> dict:
    """Phase 7d: DecodeEngines at full width (XTTSConfig()), 8 slots, on
    cuda:0 meshes of DATA_MESHES, with the bf16 KV configuration (K1, K2)
    and the int8 one with ragged decode attention (K1, K4); each engine
    drives drive_data_engine, and its served tokens (4 TokenPrompt requests
    of DATA_TOKENS and one embeds prompt), its sampled block (tokens, counts
    and seen rows) must equal its reference engine's, its migrations be
    bit for bit, its decode programs replay as graphs and its path's
    kernels launch. Returns the kernel launches of the data-sharded
    engines' runs."""
    params, _ = params_from_numpy(*seed0_weights(), device=dev, dtype=torch.bfloat16)
    base = XTTSConfig().gpt
    prompts = tp_prompts(base, dev, DATA_REQUESTS)
    embeds = (0.5 * np.random.default_rng(12).standard_normal(
        (90, base.hidden_size))).astype(np.float32)
    configs = {
        "bf16 KV (K1, K2)": (dataclasses.replace(base, prefill_flash=True, flash_decode=True),
                             ("prefill_attention", "flash_decode_append")),
        "int8 KV ragged (K1, K4)": (
            dataclasses.replace(base, prefill_flash=True, kv_int8=True, ragged_decode=True),
            ("prefill_attention", "ragged_decode"))}
    launches = {name: 0 for name in KERNELS}
    for tag, (cfg, must) in configs.items():
        refs = {}
        for ref, shape in (("unsharded", None), ("model=2", (1, 1, 2))):
            graphs.reset_counts()
            refs[ref] = drive_data_engine(dev, params, cfg, shape, prompts, embeds)
            say(f"  {tag}, {ref} reference: served {[len(t) for t in refs[ref]['served']]} "
                f"tokens in {refs[ref]['serve_s']:.1f} s; graphs {graphs_text(refs[ref]['graphs'])}")
        for name, shape in DATA_MESHES.items():
            for w in KERNELS.values():
                w["wrapper"].launches = 0
            graphs.reset_counts()
            got = drive_data_engine(dev, params, cfg, shape, prompts, embeds)
            run = {k: w["wrapper"].launches for k, w in KERNELS.items()}
            for k in KERNELS:
                launches[k] += run[k]
            ref_name = "unsharded" if shape[2] == 1 else "model=2"
            want = refs[ref_name]
            served_equal = all(np.array_equal(a, b) for a, b in zip(got["served"], want["served"]))
            block_equal = all(torch.equal(got["block"][k], want["block"][k]) for k in want["block"])
            st = got["stats"]
            say(f"  {tag}, {name} ({shape[0] * shape[1]} data shards): served "
                f"{[len(t) for t in got['served']]} tokens in {got['serve_s']:.1f} s, "
                f"{'equal' if served_equal else 'NOT EQUAL'} to the {ref_name} engine's (the last "
                f"an embeds prompt); sampled 16-step block after a burst of 8 "
                f"{'bit-equal' if block_equal else 'NOT EQUAL'}; migrations 6 -> 1, 5 -> 2 "
                f"(data shard 1 -> 0) bit for bit {got['migrated']}; runner stats "
                f"insert_batches {st['insert_batches']}, migrations {st['migrations']}, "
                f"slot_bound_blocks {st['slot_bound_blocks']}; graphs {graphs_text(got['graphs'])}; "
                f"launches {run} ({smi})")
            if not (served_equal and block_equal and all(got["migrated"])):
                raise AssertionError(f"7d {tag}, {name}: tokens, the sampled block or a "
                                     f"migration differ from the {ref_name} engine's")
            if (got["graphs"].get("decode.replays", 0) < 1
                    or got["graphs"].get("migrate.replays", 0) < 1):
                raise AssertionError(f"7d {tag}, {name}: no decode block or migration replayed "
                                     f"as a graph: {got['graphs']}")
            for k in must:
                if run[k] <= 0:
                    raise AssertionError(f"7d {tag}, {name}: kernel {k} was not launched")
    del params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- bench_torch
# phase 8's depth: bench_torch's sections at a small load
BENCH_DEPTH = {"n_requests": 2, "chunks": 2, "streams": 8, "short_reps": 3,
               "server_requests": 8}


def run_bench_sections(dev, smi: str) -> dict:
    """Phase 8: bench_torch.py's section functions at reduced depth on a
    fresh bf16 engine built by bench_torch (its tokenizer and settings: 64
    slots, 64-step blocks): its cold request and warmup, then the RTF,
    TTFA, short-phrase and server-load sections. Every request must
    succeed, K1, K2 and K3 must launch in the sections, programs (inserts
    among them) must replay, and every key of bench.py's result line must be
    a number. Returns the sections' launch counts."""
    import bench_torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = bench_torch.build_engine("bf16", bench_torch.engine_settings(), device=dev)
    torch.cuda.synchronize()
    say(f"  engine: {engine.decode_slots} slots, {engine.decode_engine.steps_per_sync}-step "
        f"blocks, bench_torch's bf16 config, built in {time.perf_counter() - t0:.1f} s")
    tts = TTS(scheduler_max_concurrency=bench_torch.CONCURRENCY).with_engine(engine)
    d = BENCH_DEPTH
    with tempfile.TemporaryDirectory() as tmp:
        speaker = bench_torch.write_speaker(os.path.join(tmp, "speaker.wav"))
        warm = bench_torch.run_cold_and_warm(tts, speaker, chunks=d["chunks"])
        say(f"  cold and warm: {json.dumps({**warm.metrics, **warm.book()})} ({smi})")
        for w in KERNELS.values():
            w["wrapper"].launches = 0
        graphs.reset_counts()
        sections = {
            "rtf": bench_torch.run_rtf(tts, speaker, n_requests=d["n_requests"],
                                       chunks=d["chunks"], reps=1),
            "ttfa": bench_torch.run_ttfa(tts, speaker, streams=d["streams"]),
            "short_phrase": bench_torch.run_short_phrase(tts, speaker, reps=d["short_reps"]),
            "server": bench_torch.run_server_load(tts, n_requests=d["server_requests"]),
        }
        launches = {name: w["wrapper"].launches for name, w in KERNELS.items()}
        counts = dict(graphs.counts)
        tts.loop.run_until_complete(tts.shutdown())
    result = {}
    for name, sec in sections.items():
        result.update(sec.metrics)
        say(f"  [{name}] captures_in_timed {sec.captures_in_timed} {sec.captured_keys}; "
            f"{json.dumps({**sec.metrics, **sec.book()})}")
    say(f"  launches in the sections {launches}; graphs {graphs_text(counts)} ({smi})")
    failed = sum(sec.failed for sec in (warm, *sections.values()))
    if failed:
        raise AssertionError(f"phase 8: {failed} requests failed")
    missing = [k for k in bench_torch.RESULT_KEYS
               if k not in ("metric", "unit", "skipped_sections")
               and not isinstance(result.get(k), (int, float, list))]
    if missing:
        raise AssertionError(f"phase 8: no number for {missing}")
    for name in BF16_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by phase 8's sections")
    must_replay("phase 8's sections", counts)
    must_replay_inserts("phase 8's sections", counts)
    del tts, engine
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- serving defaults
# the card's serving defaults as PERF.md §5's table ("Serving defaults on
# the H100") sets them: what an engine built with no flag on one card must
# resolve to
DEFAULTS_TABLE = {"prefill_flash": False, "flash_decode": True, "ragged_decode": False,
                  "kv_int8": False, "decode_w8a8": False, "prefill_w8a8": False,
                  "decode_attn_fp": False, "w8a8_policy": False, "w8a8_crossover": 0,
                  "slot_bucketing": False, "attn_fp_max_cells": 64 * 1280}
DEFAULTS_SLOTS = 4  # phase 9's decode slots (the half bucket 2)
DEFAULTS_TOKENS = 60  # tokens a chunk in phase 9's requests
DEFAULTS_GREEDY_TOKENS = 24


def run_defaults(dev, smi: str, tokenizer) -> dict:
    """Phase 9: a full-width engine built with no flag (the configuration
    `TTS.from_pretrained`, the CLI server and bench_torch's `default` serve)
    on the card. Its resolved defaults print and must equal DEFAULTS_TABLE;
    both precompile hooks on the fresh engine, their memory growth against
    the slot fit's pool estimate (4g's check), and the program each decode
    key was captured with against the W8A8 policy at its (length bound,
    slot bound), which must pick W8A8 on one side of the crossover and bf16
    weights on the other when it is armed; `TTS.warmup()`, then 4
    concurrent requests with no capture, decode programs replaying and K2
    and K3 launching; a short greedy request bit-equal (tokens and PCM) to an
    engine given the same flags explicitly. Returns the kernel launches of
    the drives."""
    import bench_torch
    from auralis_tpu_torch.runtime import engine_core

    with tempfile.TemporaryDirectory() as tmp:
        wav_path = write_voice(tmp)
        torch.cuda.empty_cache()
        engine = build_engine(dev, tokenizer, {}, None, decode_slots=DEFAULTS_SLOTS)
        de = engine.decode_engine
        got = bench_torch.resolved_flags(engine)
        say(f"  resolved serving defaults: {got}; PERF.md's table: {DEFAULTS_TABLE}")
        if got != DEFAULTS_TABLE:
            raise AssertionError(f"9: the flagless engine resolved {got}, not {DEFAULTS_TABLE}")

        # TTS.warmup() on the fresh engine (both precompile hooks, then a
        # traffic pass), with the program each decode key was captured with
        ran = {}
        step = engine_core.decode_steps_status

        def recorded(params, cfg, state, n_steps, len_bound=None, slot_bound=None, **kw):
            ran[(n_steps, len_bound, slot_bound)] = de._program_name(cfg)
            return step(params, cfg, state, n_steps, len_bound, slot_bound, **kw)

        tts = TTS(scheduler_max_concurrency=4).with_engine(engine)
        torch.cuda.synchronize()
        start = torch.cuda.memory_reserved()
        graphs.reset_counts()
        engine_core.decode_steps_status = recorded
        try:
            t0 = time.perf_counter()
            tts.warmup(text="Hello world, this is a test of speech. The quick brown fox jumps "
                            "over the lazy dog.")
            torch.cuda.synchronize()
        finally:
            engine_core.decode_steps_status = step
        grown = torch.cuda.memory_reserved() - start
        say(f"  TTS.warmup() on the fresh engine: {time.perf_counter() - t0:.1f} s, graphs "
            f"{graphs_text(graphs.counts)}; memory reserved +{grown / 2**30:.2f} GiB, of it the "
            f"graph pools: decode state {pool_gib(de._programs.pool):.2f} GiB, vocoder "
            f"{pool_gib(engine._vocoder_programs.pool):.2f} GiB; the slot fit's pool estimate "
            f"{engine.pool_bytes / 2**30:.2f} GiB ({engine.pool_bytes / max(grown, 1):.2f}x) "
            f"({smi})")
        if engine.pool_bytes < grown:
            raise AssertionError(f"9: pool estimate {engine.pool_bytes} below the warmup's "
                                 f"growth {grown}")
        keys = de.precompile_keys()
        if len(decode_keys(de)) != len(keys):
            raise AssertionError(f"9: warmup captured {len(decode_keys(de))} of {len(keys)} "
                                 "decode keys")
        policy = de._w8a8_policy
        want = {}
        for n, sb, lb in keys:
            c = de._cfg_for(lb, sb)
            want[(n, lb, sb)] = de._program_name(c)
            if policy is not None:
                w8 = policy(lb or de.cfg.max_seq_len, sb or de.num_slots)
                if c.decode_w8a8 != w8:
                    raise AssertionError(f"9: _cfg_for({lb}, {sb}) is {de._program_name(c)}, the "
                                         f"policy says W8A8={w8}")
        table = {f"steps={n} len={lb} slots={sb or de.num_slots}": ran.get((n, lb, sb))
                 for n, sb, lb in keys}
        say(f"  decode programs captured by key (policy: KV bytes < "
            f"{engine.w8a8_crossover} x weight bytes): {table}")
        if any(ran.get(k) != v for k, v in want.items()):
            raise AssertionError(f"9: captured programs {ran}, the policy picks {want}")
        names = set(want.values())
        if policy is not None and not ({de._program_name(de.cfg)} < names):
            raise AssertionError(f"9: the armed policy picked {names} over the keys: no block "
                                 "on both sides of the crossover")

        # 4 concurrent requests with nothing left to capture
        for w in KERNELS.values():
            w["wrapper"].launches = 0
        graphs.reset_counts()
        t0 = time.perf_counter()
        outs = tts.loop.run_until_complete(asyncio.gather(*(
            tts.generate_speech_async(TTSRequest(text=SENTENCE, speaker_files=[wav_path],
                                                 language="en",
                                                 max_new_tokens=DEFAULTS_TOKENS))
            for _ in range(4))))
        for i, o in enumerate(outs):
            check_waveform(f"9 request {i}", o)
        launches = {name: w["wrapper"].launches for name, w in KERNELS.items()}
        audio = sum(o.array.size for o in outs) / 24000
        say(f"  4 concurrent requests after TTS.warmup(): {audio:.2f} s audio in "
            f"{time.perf_counter() - t0:.2f} s; graphs {graphs_text(graphs.counts)}; launches "
            f"{launches} ({smi})")
        if graphs.counts["captures"]:
            raise AssertionError(f"9: {graphs.counts['captures']} programs captured after "
                                 f"TTS.warmup(): {graphs.captured_keys}")
        must_replay("phase 9's requests", graphs.counts)
        for name in ("flash_decode_append", "mrf_stage"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by phase 9's requests")

        # the same flags given explicitly: bit-equal greedy tokens and PCM
        text = "Hello world, this is a test of speech."
        want_tok, want_wav = tts.loop.run_until_complete(
            _greedy_chunk(engine, wav_path, text, DEFAULTS_GREEDY_TOKENS))
        tts.loop.run_until_complete(tts.shutdown())
        del tts, engine, de
        torch.cuda.empty_cache()
        flags = {k: got[k] for k in ("kv_int8", "prefill_w8a8", "slot_bucketing")}
        flags["decode_w8a8"] = None if got["w8a8_policy"] else got["decode_w8a8"]
        twin = build_engine(dev, tokenizer, {}, flags, decode_slots=DEFAULTS_SLOTS)
        if bench_torch.resolved_flags(twin) != got:
            raise AssertionError(f"9: the explicit engine resolved "
                                 f"{bench_torch.resolved_flags(twin)}")
        runs = [asyncio.run(_greedy_chunk(twin, wav_path, text, DEFAULTS_GREEDY_TOKENS))
                for _ in range(2)]  # lazy captures, then replays
        for tag, (tok, wav) in zip(("first (eager, then captured)", "second (replayed)"), runs):
            same = np.array_equal(tok, want_tok) and np.array_equal(wav, want_wav)
            say(f"  greedy request on the engine given {flags}, {tag}: {len(tok)} tokens, "
                f"{'bit-equal' if same else 'DIFFERENT'} tokens and PCM against the flagless "
                "engine's")
            if not same:
                raise AssertionError(f"9: the explicit engine's {tag} greedy request differs")
        del twin
        torch.cuda.empty_cache()
    return launches


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
        gpt_np, core_np = seed0_weights()
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
        graphs.reset_counts()
        serve_in_process(["--model", core_dir, "--gpt_model", gpt_dir, "--max_concurrency", "4",
                          "--decode_slots", "8", "--voices_dir", voices], smi, wav_path)
        launches = {name: w["wrapper"].launches for name, w in KERNELS.items()}
        say(f"  launches during the in-process server: {launches}; graphs "
            f"{graphs_text(graphs.counts)}")
        for name in BF16_PATH:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by phase 6's server")
        must_replay("phase 6's in-process server", graphs.counts)
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
    check_shard_shapes(dev, results)
    check_k4_shard(dev, results)
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
    phase("[4g] captured programs: decode blocks and vocoder programs as CUDA graphs against "
          "eager, precompile")
    engines = run_graphs(dev, smi, tokenizer)
    torch.cuda.empty_cache()
    phase("[4h] captured programs: inserts, bursts, migrate_slot and conditioning against "
          "eager")
    run_insert_programs(engines, smi)
    del engines
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
    torch.cuda.empty_cache()
    phase("[7a] data-parallel replicas: two engines on one card behind the facade")
    replicas = run_replicas(dev, smi, tokenizer)
    phase("[7b] tensor parallelism: a mesh of two model shards on one card, bf16 and int8 "
          "ragged")
    tensor = run_tensor_parallel(dev, smi)
    phase("[7d] the data and dcn axes of a decode state: DecodeEngines on data x model meshes "
          "of one card")
    data_axes = run_data_axes(dev, smi)
    phase("[8] bench_torch at reduced depth: bench.py's four sections on a fresh bf16 engine")
    bench = run_bench_sections(dev, smi)
    phase("[9] serving defaults: a full-width engine built with no flag, its resolved defaults, "
          "the W8A8 policy's programs, warmup and an explicit twin")
    defaults = run_defaults(dev, smi, tokenizer)
    for name in KERNELS:
        launches[name] += (replicas[name] + tensor[name] + data_axes[name] + bench[name]
                           + defaults[name])

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
    say(f"every phase passed in {time.perf_counter() - T_START:.1f} s")
    say(json.dumps(line))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
