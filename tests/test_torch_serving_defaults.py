"""The engine's serving defaults (`serving_defaults`), the port of the JAX
engine's accelerator branch, on the CPU.

- On a CPU device every value resolves as the JAX engine resolves it on its
  CPU backend, for the flagless config, flash_decode and ragged_decode, and
  each engine flag given True or False; `"cuda"` resolves to the card's
  table (PERF.md §5); under tensor parallelism both device types refuse
  the int8 weight flags, as JAX does.
- The W8A8 policy equals the JAX engine's closure at its TPU crossover, and
  at the card's crossover gives the card's table at full width; a runner
  given the armed policy picks the program JAX's `_cfg_for` picks for every
  precompile key.
- A replica takes its donor's resolved configuration as it is.
- One prod_step_torch.py cell per variant and bench_torch.py's `default`
  configuration build and run at tiny width (untimed: there is no CPU
  timing)."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import bench_torch  # noqa: E402
import prod_step_torch  # noqa: E402
from helpers import build_tiny_engine  # noqa: E402

from auralis_tpu.models.xttsv2 import gpt as jgpt  # noqa: E402
from auralis_tpu.models.xttsv2.engine import XTTSv2Engine as JaxEngine  # noqa: E402
from auralis_tpu.runtime import engine_core as jcore  # noqa: E402
from auralis_tpu_torch.models.xttsv2 import engine as tengine  # noqa: E402
from auralis_tpu_torch.models.xttsv2 import gpt as tgpt  # noqa: E402
from auralis_tpu_torch.models.xttsv2 import weights as tw  # noqa: E402
from auralis_tpu_torch.models.xttsv2.config import XTTSGPTConfig, tiny_test_config  # noqa: E402
from auralis_tpu_torch.models.xttsv2.engine import (  # noqa: E402
    ServingDefaults,
    XTTSv2Engine,
    serving_defaults,
)
from auralis_tpu_torch.parallel.replica import ReplicatedTTSEngine  # noqa: E402
from auralis_tpu_torch.runtime import engine_core as tcore  # noqa: E402

# PERF.md §5's table: what one card without tensor parallelism resolves an
# engine built with no flag to
CARD = {"kv_int8": False, "w8a8_auto": False, "prefill_w8a8": False, "slot_bucketing": False,
        "crossover": 0, "attn_fp_max_cells": 64 * 1280}
# PERF.md §5's policy table at full width on the card: the (slots, length
# bound) blocks of the grid below that run the int8 decode weights, by KV
# cache
CARD_W8A8_BLOCKS = {True: set(), False: set()}
FLAGS = ("kv_int8", "decode_w8a8", "prefill_w8a8", "slot_bucketing")
KERNEL_CONFIGS = {"flagless": {}, "flash_decode": {"flash_decode": True},
                  "ragged_decode": {"ragged_decode": True}}


def _cases():
    """(kernel config, engine flags) pairs the JAX engine accepts: none, and
    each flag alone True and False; ragged_decode always with kv_int8 (it
    requires the int8 cache), flash_decode never with it (they exclude)."""
    for name, gpt_flags in KERNEL_CONFIGS.items():
        base = {"kv_int8": True} if name == "ragged_decode" else {}
        for flag in (None, *FLAGS):
            for value in ((None,) if flag is None else (True, False)):
                flags = dict(base)
                if flag is not None:
                    flags[flag] = value
                if name == "flash_decode" and flags.get("kv_int8"):
                    continue
                if name == "ragged_decode" and flags.get("kv_int8") is False:
                    continue
                yield pytest.param(name, flags, id=f"{name}-{flags or 'none'}")


def _resolved(defaults: ServingDefaults) -> dict:
    g = defaults.gpt_config
    return {"kv_int8": g.kv_int8, "decode_w8a8": g.decode_w8a8, "prefill_w8a8": g.prefill_w8a8,
            "w8a8_auto": defaults.w8a8_auto, "slot_bucketing": defaults.slot_bucketing}


@pytest.fixture(scope="module")
def jax_tiny():
    """One tiny JAX engine, whose params and core the cases' engines share."""
    return build_tiny_engine(max_concurrency=1)


@pytest.mark.parametrize("name, flags", list(_cases()))
def test_cpu_defaults_equal_jax_cpu_engine(jax_tiny, name, flags):
    cfg = dataclasses.replace(jax_tiny.gpt_config, **KERNEL_CONFIGS[name])
    je = JaxEngine(jax_tiny.hifi_config, cfg, params=jax_tiny.params, core=jax_tiny.core,
                   max_concurrency=1, **flags)
    want = {"kv_int8": je.gpt_config.kv_int8, "decode_w8a8": je.gpt_config.decode_w8a8,
            "prefill_w8a8": je.gpt_config.prefill_w8a8, "w8a8_auto": je._w8a8_auto,
            "slot_bucketing": je.decode_engine.slot_bucketing}
    port_cfg = dataclasses.replace(tiny_test_config().gpt, **KERNEL_CONFIGS[name])
    got = serving_defaults("cpu", 1, port_cfg, **flags)
    assert _resolved(got) == want
    assert got.crossover == tengine.W8A8_KV_TO_WEIGHT_CROSSOVER_TPU


def test_cuda_defaults_are_the_card_table():
    """One card, no tensor parallelism: the flagless config resolves to the
    table; flash_decode keeps its bf16 cache and ragged_decode its int8 one,
    neither arms the policy; an explicit argument wins; the caller's config
    is never mutated."""
    cfg = XTTSGPTConfig()
    before = dataclasses.asdict(cfg)
    got = serving_defaults("cuda", 1, cfg)
    assert _resolved(got) == {"kv_int8": CARD["kv_int8"], "decode_w8a8": False,
                              "prefill_w8a8": CARD["prefill_w8a8"],
                              "w8a8_auto": CARD["w8a8_auto"],
                              "slot_bucketing": CARD["slot_bucketing"]}
    assert got.crossover == CARD["crossover"] == tengine.W8A8_KV_TO_WEIGHT_CROSSOVER_CUDA
    assert tcore.ATTN_FP_MAX_CELLS_CUDA == CARD["attn_fp_max_cells"]
    changed = serving_defaults("cuda", 1, cfg, kv_int8=True, prefill_w8a8=True)
    assert changed.gpt_config.kv_int8 and changed.gpt_config.prefill_w8a8
    assert dataclasses.asdict(cfg) == before  # a replaced copy, never the caller's config
    flash = serving_defaults("cuda", 1, dataclasses.replace(cfg, flash_decode=True))
    assert not flash.gpt_config.kv_int8 and not flash.w8a8_auto
    assert flash.gpt_config.prefill_w8a8 == CARD["prefill_w8a8"]
    ragged = serving_defaults("cuda", 1, dataclasses.replace(cfg, ragged_decode=True),
                              kv_int8=True)
    assert ragged.gpt_config.kv_int8 and not ragged.w8a8_auto
    off = serving_defaults("cuda", 1, cfg, kv_int8=False, decode_w8a8=False,
                           slot_bucketing=False)
    assert _resolved(off) == {"kv_int8": False, "decode_w8a8": False, "prefill_w8a8": False,
                              "w8a8_auto": False, "slot_bucketing": False}
    forced = serving_defaults("cuda", 1, cfg, decode_w8a8=True)
    assert forced.gpt_config.decode_w8a8 and not forced.w8a8_auto
    assert serving_defaults("cuda", 1, cfg, prefill_w8a8=False).gpt_config.prefill_w8a8 is False


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_tensor_parallelism_refuses_int8_weights(jax_tiny, monkeypatch, device_type):
    """Under tensor_parallel_size=2 the int8 weight flags are refused with
    JAX's warnings and int8 KV defaults off, on either device type, as the
    JAX engine resolves them on its 2-device mesh."""
    warned = []
    monkeypatch.setattr(tengine.logger, "warning", lambda msg, *a: warned.append(msg % a))
    for flags in ({"decode_w8a8": True, "prefill_w8a8": True}, {}):
        je = JaxEngine(jax_tiny.hifi_config, jax_tiny.gpt_config, params=jax_tiny.params,
                       core=jax_tiny.core, max_concurrency=1, tensor_parallel_size=2, **flags)
        want = {"kv_int8": je.gpt_config.kv_int8, "decode_w8a8": je.gpt_config.decode_w8a8,
                "prefill_w8a8": je.gpt_config.prefill_w8a8, "w8a8_auto": je._w8a8_auto,
                "slot_bucketing": je.decode_engine.slot_bucketing}
        got = serving_defaults(device_type, 2, tiny_test_config().gpt, **flags)
        assert {k: v for k, v in _resolved(got).items() if k != "slot_bucketing"} == {
            k: v for k, v in want.items() if k != "slot_bucketing"}
        assert not (got.gpt_config.decode_w8a8 or got.gpt_config.prefill_w8a8 or got.w8a8_auto
                    or got.gpt_config.kv_int8)
        if device_type == "cpu":
            assert got.slot_bucketing == want["slot_bucketing"]
    # the config's own flags are refused too
    cfg = dataclasses.replace(tiny_test_config().gpt, decode_w8a8=True, prefill_w8a8=True)
    got = serving_defaults(device_type, 2, cfg)
    assert not (got.gpt_config.decode_w8a8 or got.gpt_config.prefill_w8a8)
    # the JAX engine logs through the same logger ("xttsv2"): its two
    # warnings, the port's two, then the port's two for the config's flags
    assert [w.split(" is unsupported")[0] for w in warned] == ["decode_w8a8", "prefill_w8a8"] * 3


def _block_shapes(d: int, inner: int, layers: int) -> dict:
    """The GPT block parameters' shapes (init_gpt_params's)."""
    vec = {"ln1_scale": d, "ln1_bias": d, "attn_b": 3 * d, "attn_proj_b": d, "ln2_scale": d,
           "ln2_bias": d, "fc_b": inner, "fc_proj_b": d}
    mat = {"attn_w": (d, 3 * d), "attn_proj_w": (d, d), "fc_w": (d, inner),
           "fc_proj_w": (inner, d)}
    return {**{k: (layers, n) for k, n in vec.items()},
            **{k: (layers, *s) for k, s in mat.items()}}


def _policy(cfg: XTTSGPTConfig, cache_dtype, crossover, blocks: dict):
    """The port's policy function for an engine holding `blocks`."""
    host = SimpleNamespace(gpt_config=cfg, cache_dtype=cache_dtype, params={"blocks": blocks})
    return XTTSv2Engine.w8a8_policy(host, crossover)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_policy_equals_jax_closure_and_card_table(monkeypatch, kv_int8):
    """The port's policy equals the JAX engine's closure (KV bytes < 3 x the
    block weights' bytes, built as on a TPU) on the tiny config, over slots
    {1, 8, 64} x bounds {256, 512, 1024, 1280}; at full width with bf16
    blocks and the card's crossover it picks W8A8 exactly on the card's
    table, with an int8 and with a bf16 KV cache."""
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        je = build_tiny_engine(max_concurrency=1, vocoder_dtype=None, kv_int8=kv_int8,
                               unroll_layers=False, prefill_w8a8=False, slot_bucketing=False)
    jax_policy = je.decode_engine._w8a8_policy
    blocks = tw.tree_to_torch(jax.device_get(je.params["blocks"]), "cpu")
    g = tiny_test_config().gpt
    assert {k: tuple(v.shape) for k, v in blocks.items()} == _block_shapes(
        g.hidden_size, g.n_inner, g.num_hidden_layers)
    policy = _policy(dataclasses.replace(g, kv_int8=kv_int8), torch.float32,
                     tengine.W8A8_KV_TO_WEIGHT_CROSSOVER_TPU, blocks)
    grid = [(s, b) for s in (1, 8, 64) for b in (256, 512, 1024, 1280)]
    answers = {(s, b): policy(b, s) for s, b in grid}
    assert answers == {(s, b): jax_policy(b, s) for s, b in grid}
    assert set(answers.values()) == {True, False}
    full = XTTSGPTConfig()
    meta = {k: torch.empty(s, dtype=torch.bfloat16, device="meta") for k, s in _block_shapes(
        full.hidden_size, full.n_inner, full.num_hidden_layers).items()}
    card = _policy(dataclasses.replace(full, kv_int8=kv_int8), torch.bfloat16, CARD["crossover"],
                   meta)
    assert {(s, b) for s, b in grid if card(b, s)} == CARD_W8A8_BLOCKS[kv_int8]


@pytest.mark.parametrize("kv_int8", [False, True])
def test_runner_with_armed_policy_picks_jax_programs(kv_int8):
    """A CPU DecodeEngine given the engine's armed policy picks, for every
    key of precompile_keys(), the config JAX's DecodeEngine._cfg_for picks
    with the same policy (the JAX runner's attn_fp region on the CPU)."""
    g = tiny_test_config().gpt
    p = tw.init_gpt_params(g, 3)
    jp, tp = jax.tree.map(jnp.asarray, p), tw.tree_to_torch(p, "cpu")
    engine = XTTSv2Engine(tiny_test_config(), g, params=tp, core=tw.params_from_numpy(
        *tw.random_init(tiny_test_config(), 0), device="cpu")[1], max_concurrency=1,
        device="cpu", kv_int8=kv_int8, cache_dtype=torch.float32,
        vocoder_dtype=torch.float32, decode_slots=16)
    # a policy that flips inside the tiny grid (f32 blocks of 2 x 64 lanes)
    policy = engine.w8a8_policy(8)
    jp["blocks_q8"] = jax.jit(jgpt.quantize_decode_weights)(jp["blocks"])
    cfg = engine.gpt_config
    jc = dataclasses.replace(build_tiny_engine(max_concurrency=1).gpt_config, kv_int8=kv_int8)
    je = jcore.DecodeEngine(jp, jc, num_slots=16, cache_dtype=jnp.float32, steps_per_sync=16,
                            slot_bucketing=True, w8a8_policy=policy)
    tp["blocks_q8"] = tgpt.quantize_decode_weights(tp["blocks"])
    te = tcore.DecodeEngine(tp, cfg, num_slots=16, cache_dtype=torch.float32,
                            slot_bucketing=True, w8a8_policy=policy, device="cpu",
                            stream_block_steps=engine.decode_engine.stream_block_steps)
    assert te._attn_fp_max_cells == je._attn_fp_max_cells == tcore.ATTN_FP_MAX_CELLS_TPU
    picks = set()
    for _, sb, lb in te.precompile_keys():
        got, want = te._cfg_for(lb, sb), je._cfg_for(lb, sb)
        assert (got.decode_w8a8, got.decode_attn_fp) == (want.decode_w8a8,
                                                          want.decode_attn_fp), (lb, sb)
        picks.add((got.decode_w8a8, got.decode_attn_fp))
    assert (True, False) in picks and (False, False) in picks
    assert ((True, True) in picks) == kv_int8


def test_engine_arms_the_resolved_policy_and_replicas_copy_it():
    """An engine given a resolved configuration with the policy armed (what
    serving_defaults gives on one card) makes blocks_q8 and hands its policy
    to the runner; ReplicatedTTSEngine.from_engine passes that resolution
    on as it is: same flags, policy and bucketing, blocks_q8 shared on the
    donor's device."""
    cfg = tiny_test_config()
    params, core = tw.params_from_numpy(*tw.random_init(cfg, 0), device="cpu")
    serving = ServingDefaults(dataclasses.replace(cfg.gpt, kv_int8=True, prefill_w8a8=True),
                              w8a8_auto=True, crossover=3, slot_bucketing=True)
    donor = XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cpu",
                         max_concurrency=2, cache_dtype=torch.float32,
                         vocoder_dtype=torch.float32, serving=serving)
    assert "blocks_q8" in donor.params and donor.gpt_config is serving.gpt_config
    de = donor.decode_engine
    assert de._w8a8_policy is not None and de.slot_bucketing and donor.w8a8_crossover == 3
    assert de.state.cache.quantized
    rep = ReplicatedTTSEngine.from_engine(donor, devices=["cpu", "cpu"]).engines[1]
    assert rep.serving is donor.serving and rep.gpt_config == donor.gpt_config
    assert rep.params["blocks_q8"] is donor.params["blocks_q8"]
    assert rep.decode_engine._w8a8_policy is not None and rep.decode_engine.slot_bucketing
    # without a resolution the CPU engine arms nothing
    plain = XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cpu",
                         max_concurrency=2, cache_dtype=torch.float32,
                         vocoder_dtype=torch.float32)
    assert not plain._w8a8_auto and plain.decode_engine._w8a8_policy is None
    assert "blocks_q8" not in plain.params and not plain.decode_engine.slot_bucketing


# ------------------------------------------------ prod_step_torch.py
@pytest.fixture(scope="module")
def tiny_params():
    """prod_step_torch's weights at tiny width, the stop token's logit
    pushed far down so every slot decodes to the bound (the tiny model's
    random weights otherwise stop some within a few steps)."""
    g = tiny_test_config().gpt
    params = prod_step_torch.gpt_params(g, "cpu")
    params["mel_head_b"][g.stop_audio_token] = -1e4
    return params


@pytest.mark.parametrize("variant", list(prod_step_torch.VARIANTS))
def test_prod_step_cell_on_cpu(tiny_params, variant):
    """One cell per variant at tiny width through the plain kernels: the
    block runs eagerly (captured on the card), the fill is restored, and
    after the warm and timed blocks every slot sits 2 rows below the bound;
    nothing is timed on the CPU."""
    cfg = prod_step_torch.variant_config(tiny_test_config().gpt, variant)
    assert all(getattr(cfg, k) == v for k, v in prod_step_torch.VARIANTS[variant].items())
    de = prod_step_torch.decode_engine(tiny_params, cfg, 4, 2, "cpu")
    cell = prod_step_torch.decode_cell(de, 64, steps=2, rounds=2)
    assert cell["fill"] == 64 - 3 * 2 - 2 and cell["len_bound"] == 64
    assert cell["ms_per_step"] is None and cell["rtf"] is None
    assert de.state.seq_lens.tolist() == [62] * 4 and bool(de.state.active.all())
    full = de.state.cache.max_len
    assert prod_step_torch.decode_cell(de, full, steps=2, rounds=1)["len_bound"] is None
    ratio = prod_step_torch.kv_to_weight(tiny_params, cfg, 4, 64)
    kv = 4 * 64 * 2 * cfg.hidden_size * cfg.num_hidden_layers * (1 if cfg.kv_int8 else 2)
    assert ratio == pytest.approx(kv / sum(v.numel() * 2 for v in tiny_params["blocks"].values()))


@pytest.mark.parametrize("prefill_w8a8", [False, True])
def test_prod_step_inserts_on_cpu(tiny_params, prefill_w8a8):
    """The single insert and the burst of 8 at bucket 32 fill their slots."""
    cfg = dataclasses.replace(tiny_test_config().gpt, prefill_w8a8=prefill_w8a8)
    de = prod_step_torch.decode_engine(tiny_params, cfg, 8, 2, "cpu")
    one = prod_step_torch.insert_cell(de, 1, 2, bucket=32)
    assert (one["k"], one["ms"], one["ms_per_chunk"]) == (1, None, None)
    burst = prod_step_torch.insert_cell(de, 8, 2, bucket=32)
    assert burst["k"] == 8 and bool(de.state.active.all())
    assert de.state.seq_lens.tolist() == [32] * 8


def test_prod_step_without_a_card_exits_nonzero(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.json"
    assert prod_step_torch.main(["--out", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err and not out.exists()


def test_prod_step_imports_no_jax():
    code = ("import sys, prod_step_torch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax' or "
            "m.startswith('jaxlib') or m == 'auralis_tpu' or m.startswith('auralis_tpu.'))\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------ bench_torch.py's configs
def test_bench_default_config_builds_on_cpu(monkeypatch):
    """`--config default` sets no flag, so a CPU engine resolves the JAX CPU
    defaults (nothing armed); the environment overrides reach the engine."""
    for var in (*bench_torch.FLAG_ENV, "BENCH_SLOT_BUCKETING"):
        monkeypatch.delenv(var, raising=False)
    settings = {"decode_slots": 4, "steps_per_sync": 4, "slot_bucketing": None}
    assert bench_torch.engine_kwargs("default", settings) == {"decode_slots": 4,
                                                              "steps_per_sync": 4}
    engine = bench_torch.build_engine("default", settings, device="cpu",
                                      base=tiny_test_config())
    flags = bench_torch.resolved_flags(engine)
    assert not any(flags[k] for k in ("prefill_flash", "flash_decode", "ragged_decode",
                                      "kv_int8", "decode_w8a8", "prefill_w8a8", "w8a8_policy",
                                      "slot_bucketing"))
    json.dumps(flags)
    monkeypatch.setenv("BENCH_KV_INT8", "1")
    monkeypatch.setenv("BENCH_PREFILL_W8A8", "1")
    engine = bench_torch.build_engine("default", settings, device="cpu",
                                      base=tiny_test_config())
    assert engine.gpt_config.kv_int8 and engine.gpt_config.prefill_w8a8


def test_bench_engine_kwargs_pin_bf16_and_int8(monkeypatch):
    """bf16 and int8 fall back to no bucketing where BENCH_SLOT_BUCKETING is
    unset, and it overrides them both ways; the flag variables override a
    configuration's pinned flags; default leaves every flag to the engine."""
    for var in (*bench_torch.FLAG_ENV, "BENCH_SLOT_BUCKETING"):
        monkeypatch.delenv(var, raising=False)
    for config in ("bf16", "int8"):
        kw = bench_torch.engine_kwargs(config, bench_torch.engine_settings())
        assert kw == {**bench_torch.CONFIGS[config][1], "decode_slots": 64,
                      "steps_per_sync": 64}
        assert kw["slot_bucketing"] is False
    monkeypatch.setenv("BENCH_SLOT_BUCKETING", "1")
    assert bench_torch.engine_kwargs("bf16", bench_torch.engine_settings())["slot_bucketing"]
    monkeypatch.setenv("BENCH_SLOT_BUCKETING", "0")
    assert bench_torch.engine_kwargs("default",
                                     bench_torch.engine_settings())["slot_bucketing"] is False
    monkeypatch.setenv("BENCH_DECODE_W8A8", "0")
    assert bench_torch.engine_kwargs("int8", bench_torch.engine_settings())[
        "decode_w8a8"] is False
    assert bench_torch.engine_kwargs("default", bench_torch.engine_settings())[
        "decode_w8a8"] is False
