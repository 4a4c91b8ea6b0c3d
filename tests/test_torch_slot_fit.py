"""The slot fit counts the captured programs' memory pools
(XTTSv2Engine._program_pool_bytes): the device's memory is faked through
torch.cuda.mem_get_info / memory_reserved / memory_allocated on a CPU-built
tiny engine whose device is then set to the card, so only the fit's
arithmetic runs."""
import numpy as np
import pytest
import torch

from auralis_tpu_torch.models.xttsv2 import engine as tengine
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config
from auralis_tpu_torch.models.xttsv2.engine import HBM_HEADROOM, XTTSv2Engine
from auralis_tpu_torch.models.xttsv2.weights import params_from_numpy, random_init
from auralis_tpu_torch.runtime.decode_loop import PREFILL_BUCKETS

CUDA = torch.device("cuda")


@pytest.fixture()
def engine(monkeypatch):
    cfg = tiny_test_config()
    params, core = params_from_numpy(*random_init(cfg, 0), device="cpu")
    eng = XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cpu", max_concurrency=8,
                       cache_dtype=torch.float32, vocoder_dtype=torch.float32)
    assert eng._program_pool_bytes() == (0, 0)  # nothing is captured on the CPU
    eng.device = CUDA
    monkeypatch.setattr(tengine, "_ENGINES_ON", {})
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return eng


def _card(monkeypatch, free, total):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (int(free), int(total)))


def test_pool_estimate_from_the_programs_shapes(engine):
    """The fixed term is the vocoder pool (twice the largest program's peak
    plus every program's static tensors), the largest insert program's peak
    and the eager first run of the largest program; it grows with the
    shapes the programs hold. Per slot, the dense decode bodies' f32 copies of a slot's rows."""
    keys = engine.vocoder_keys()
    peaks = [engine._vocoder_peak_bytes(*k) for k in keys]
    assert peaks == sorted(peaks, reverse=True) and len(keys) == 8 + 4 + 4 * len(
        {engine.row_bucket(n) for n in range(1, engine.gpt_config.max_audio_tokens + 1)})
    assert keys[0][:2] == ("row", 4)
    g = engine.gpt_config
    inserts = max(engine._insert_peak_bytes(b, k) for b in PREFILL_BUCKETS
                  if b <= g.max_seq_len for k in (1, 2, 4, 8))
    statics = sum(engine._vocoder_static_bytes(*k) for k in keys)
    fixed, per_slot = engine._program_pool_bytes()
    assert fixed == 2 * peaks[0] + statics + inserts + max(peaks[0], inserts)
    t_pad = engine.decode_engine.state.cache.max_len
    assert per_slot == 2 * t_pad * g.hidden_size * 4
    # a wider row bucket holds more samples: the estimate follows the shapes
    assert engine._vocoder_peak_bytes("row", 4, 512) > engine._vocoder_peak_bytes("row", 4, 256)
    assert engine._vocoder_peak_bytes("row", 4, 256) > engine._vocoder_peak_bytes("row", 2, 256)
    assert engine._insert_peak_bytes(512, 8) == 8 * g.num_attention_heads * 512 * 512 * 18


def test_default_slot_count_is_clamped_once_the_pools_count(engine, monkeypatch):
    """16 slots fit the free memory left after the headroom, but not once
    the pools are subtracted: a default count is clamped to what fits."""
    _, slot = engine._hbm_plan_bytes()
    pools, pool_slot = engine._program_pool_bytes()
    total = 10 * 2**30
    free = total * HBM_HEADROOM + pools + 10 * (slot + pool_slot)
    _card(monkeypatch, free, total)
    fit = int(free - int(total * HBM_HEADROOM) - pools) // (slot + pool_slot)
    assert fit == 10 and pools > 6 * slot
    assert engine._fit_slots_to_hbm(16, slots_explicit=False) == fit
    # without the pools 16 would fit: the term is what clamps
    monkeypatch.setattr(engine, "_program_pool_bytes", lambda: (0, 0))
    assert engine._fit_slots_to_hbm(16, slots_explicit=False) == 16


def test_explicit_slot_count_that_no_longer_fits_raises(engine, monkeypatch):
    _, slot = engine._hbm_plan_bytes()
    pools, pool_slot = engine._program_pool_bytes()
    total = 10 * 2**30
    _card(monkeypatch, total * HBM_HEADROOM + 16 * (slot + pool_slot) + pools - 1, total)
    with pytest.raises(ValueError, match="decode_slots=16 .* captured-program pools"):
        engine._fit_slots_to_hbm(16, slots_explicit=True)
    _card(monkeypatch, total * HBM_HEADROOM + 16 * (slot + pool_slot) + pools + 1, total)
    assert engine._fit_slots_to_hbm(16, slots_explicit=True) == 16


def test_unwarmed_engines_on_the_card_count_for_the_next(engine, monkeypatch):
    """A replica built on the same card before the first one's warmup sees
    the first one's pools as taken; once its precompile hooks have run the
    card's free memory shows them and they are no longer pending."""
    _, slot = engine._hbm_plan_bytes()
    pools, pool_slot = engine._program_pool_bytes()
    total = 10 * 2**30
    _card(monkeypatch, total * HBM_HEADROOM + pools + 8 * (slot + pool_slot), total)
    assert engine._fit_slots_to_hbm(8, slots_explicit=False) == 8

    class Other:
        _pools_pending = 4 * (slot + pool_slot)

    other = Other()
    tengine._ENGINES_ON[torch.device("cuda", 0)] = [other]  # `cuda` is card 0 here
    assert engine._fit_slots_to_hbm(8, slots_explicit=False) == 4
    other._pools_pending = 0
    assert engine._fit_slots_to_hbm(8, slots_explicit=False) == 8


def test_memory_plan_counts_the_pools_apart(engine):
    weights, slot = engine._hbm_plan_bytes()
    pools, pool_slot = engine._program_pool_bytes()
    gib = engine.get_memory_usage_curve()
    assert engine.pool_bytes == pools + pool_slot * engine.decode_slots
    assert gib == pytest.approx((weights + slot * engine.decode_slots + engine.pool_bytes)
                                / 2**30, rel=1e-12)


def test_precompile_captures_largest_first(engine, monkeypatch):
    """The insert programs are formed largest bucket and burst first (the
    vocoder's order is vocoder_keys'), so later captures reuse the blocks
    that the earlier ones freed in the shared pool."""
    de = engine.decode_engine
    order = []
    monkeypatch.setattr(de._programs, "captures", True)
    monkeypatch.setattr(de, "_insert_tokens",
                        lambda conds, ids, n_ids, slots, opts: order.append(
                            (len(conds) + ids.shape[1], len(slots))))
    monkeypatch.setattr(de, "_release_state", lambda slots: None)
    monkeypatch.setattr(de, "_migrate", lambda src, dst: order.append("migrate"))
    de.device = torch.device("cpu")
    de.precompile_inserts(4)
    sizes = [b * b * k for b, k in order[:-1]]
    assert order[-1] == "migrate" and order[0] == (max(b for b, _ in order[:-1]), 8)
    assert sizes == sorted(sizes, reverse=True)
    assert np.all(np.diff([b for b, _ in order[:-1]]) <= 0)
