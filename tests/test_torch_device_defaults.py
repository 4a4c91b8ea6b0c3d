"""The port's entry points run on the card unless the caller names another
device: without a card, building an engine, converting weights or making
decode state (KV cache, slot state, sampling state) with no `device=`
raises through torch's own error instead of carrying on on the CPU. Whether a card is present is decided inside each test (never at
import): with one, these tests skip."""
import pytest
import torch

from auralis_tpu_torch.models.xttsv2.config import tiny_test_config
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.models.xttsv2.gpt import make_kv_cache
from auralis_tpu_torch.models.xttsv2.weights import params_from_numpy, random_init
from auralis_tpu_torch.runtime.decode_loop import _prompt_seen_row, init_decode_state
from auralis_tpu_torch.runtime.engine_core import DecodeEngine
from auralis_tpu_torch.runtime.sampler import init_sampling_state

# a CPU-only torch raises AssertionError("Torch not compiled with CUDA
# enabled"); a CUDA build on a machine without a card raises RuntimeError
NO_CARD = (AssertionError, RuntimeError)
MATCH = r"(?i)cuda|nvidia"


def _skip_with_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config()
    gpt_np, core_np = random_init(cfg, seed=0)
    return cfg, gpt_np, core_np


def test_random_init_defaults_to_the_card(tiny):
    _skip_with_card()
    cfg, _, _ = tiny
    with pytest.raises(NO_CARD, match=MATCH):
        XTTSv2Engine.random_init(cfg)


def test_params_from_numpy_defaults_to_the_card(tiny):
    _skip_with_card()
    _, gpt_np, core_np = tiny
    with pytest.raises(NO_CARD, match=MATCH):
        params_from_numpy(gpt_np, core_np)


def test_engine_defaults_to_the_card(tiny):
    """CPU weights and no device: the engine's own state goes to the card."""
    _skip_with_card()
    cfg, gpt_np, core_np = tiny
    params, core = params_from_numpy(gpt_np, core_np, device="cpu")
    with pytest.raises(NO_CARD, match=MATCH):
        XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, max_concurrency=1)


def test_decode_engine_defaults_to_the_card(tiny):
    _skip_with_card()
    cfg, gpt_np, core_np = tiny
    params, _ = params_from_numpy(gpt_np, core_np, device="cpu")
    with pytest.raises(NO_CARD, match=MATCH):
        DecodeEngine(params, cfg.gpt, num_slots=2)



def test_kv_cache_defaults_to_the_card(tiny):
    _skip_with_card()
    cfg, _, _ = tiny
    with pytest.raises(NO_CARD, match=MATCH):
        make_kv_cache(cfg.gpt, 2)
    assert make_kv_cache(cfg.gpt, 2, device="cpu").k.device.type == "cpu"


def test_decode_state_defaults_to_the_card(tiny):
    _skip_with_card()
    cfg, _, _ = tiny
    with pytest.raises(NO_CARD, match=MATCH):
        init_decode_state(cfg.gpt, 2)
    assert init_decode_state(cfg.gpt, 2, device="cpu").seq_lens.device.type == "cpu"


def test_sampling_state_and_seen_row_default_to_the_card(tiny):
    _skip_with_card()
    cfg, _, _ = tiny
    with pytest.raises(NO_CARD, match=MATCH):
        init_sampling_state(2, cfg.gpt.num_audio_tokens)
    with pytest.raises(NO_CARD, match=MATCH):
        _prompt_seen_row(cfg.gpt)
