"""K2 reads a decode step's q, k and v rows where the QKV product left them.

Skips without a CUDA device. On an H100 (the repository's conftest imports
JAX, which a card's machine may lack, so leave it out):

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_k2_in_place_card.py

- K2 launched on the `split` views of a [S, 3*H*64] buffer, at the buffer's
  row stride, gives the ctx and the caches of a launch on contiguous copies
  of the same views, with copies of the caches, bit for bit: bf16 and f32,
  S = 1, 8 and 64, ragged write positions that hold 0 and T - 1.
- The in-place launches leave the tracing counter `k2.input_copies` where
  it was; a launch on rows that start one element into their buffer, or on
  contiguous rows that start off 16 bytes, copies them first (the counter
  rises by one) and gives the same bits.
"""
import pytest
import torch

from auralis_tpu_torch.common import tracing
from auralis_tpu_torch.ops.experimental.attention import (
    CHUNK,
    flash_decode_append_attention,
    k2_row_stride,
)

H, D, LAYERS, T = 16, 64, 2, 2 * CHUNK
HD = H * D


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; none is visible")
    return torch.device("cuda", 0)


def copies() -> int:
    return tracing.profile_summary().get("k2.input_copies", {"count": 0})["count"]


def write_positions(s: int, layer: int, dev) -> torch.Tensor:
    """Ragged positions in [0, T): slot 0 at 0 and the last slot at T - 1
    on layer 0, the other way round on layer 1 (one slot: 0, then T - 1)."""
    g = torch.Generator().manual_seed(s)
    wp = torch.randint(0, T, (s,), generator=g)
    wp[0], wp[-1] = (0, T - 1) if layer == 0 else (T - 1, 0)
    if s == 1:
        wp[0] = 0 if layer == 0 else T - 1
    return wp.to(torch.int32).to(dev)


def launch_both(q, k, v, caches, layer, wp) -> None:
    """K2 on (q, k, v) as given into `caches`, and on contiguous copies into
    copies of the caches: ctx and both caches bit-equal."""
    k_cache, v_cache = caches
    k_ref, v_ref = k_cache.clone(), v_cache.clone()
    got = flash_decode_append_attention(q, k, v, k_cache, v_cache, layer, wp)
    want = flash_decode_append_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         k_ref, v_ref, layer, wp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(k_cache, k_ref) and torch.equal(v_cache, v_ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 8, 64])
def test_k2_on_split_views_equals_copied_launch(card, s, dtype):
    g = torch.Generator(device=card).manual_seed(s)
    qkv = torch.randn((s, 3 * HD), generator=g, device=card).to(dtype)
    q, k, v = qkv.split(HD, dim=-1)
    q = q.reshape(s, H, D)
    assert k2_row_stride(q, k, v) == (3 * HD if s > 1 else HD)
    caches = [torch.randn((LAYERS, s, T, HD), generator=g, device=card).to(dtype)
              for _ in range(2)]
    for layer in range(LAYERS):
        wp = write_positions(s, layer, card)
        before = copies()
        got = flash_decode_append_attention(q, k, v, *caches, layer, wp)
        assert copies() == before  # read in place: no copy
        launch_both(q, k, v, caches, layer, wp)
        assert got.shape == (s, H, D) and torch.isfinite(got.float()).all()
        # the append wrote this step's rows where each slot's position says
        slots = torch.arange(s, device=card)
        assert torch.equal(caches[0][layer, slots, wp.long()], k)
        assert torch.equal(caches[1][layer, slots, wp.long()], v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_copies_rows_off_16_bytes(card, dtype):
    """Rows one element into their buffer, at a row stride that is itself
    on 16 bytes, and contiguous k/v rows that start off 16 bytes: the
    wrapper copies them (one count a launch) and the bits are those of the
    contiguous launch."""
    s = 8
    g = torch.Generator(device=card).manual_seed(11)
    caches = [torch.randn((LAYERS, s, T, HD), generator=g, device=card).to(dtype)
              for _ in range(2)]
    wp = write_positions(s, 0, card)
    buf = torch.randn((s, 3 * HD + 8), generator=g, device=card).to(dtype)
    q, k, v = buf[:, 1:1 + 3 * HD].split(HD, dim=-1)
    q = q.reshape(s, H, D)
    assert k2_row_stride(q, k, v) is None
    before = copies()
    flash_decode_append_attention(q, k, v, *caches, 0, wp)
    assert copies() == before + 1
    launch_both(q, k, v, caches, 0, wp)

    flat = torch.randn((2, s * HD + 1), generator=g, device=card).to(dtype)
    k, v = (row[1:].view(s, HD) for row in flat)  # contiguous, 1 element off
    q = torch.randn((s, H, D), generator=g, device=card).to(dtype)
    assert k.is_contiguous() and k2_row_stride(q, k, v) is None
    before = copies()
    flash_decode_append_attention(q, k, v, *caches, 1, wp)
    assert copies() == before + 1
    launch_both(q, k, v, caches, 1, wp)
