"""The torch port's signal ops and conditioning/vocoder modules against the
JAX package on the same numpy inputs and weights (CPU, f32).

Tolerances: the two frameworks run the same f32 math with different kernels
(FFT, convolution, matmul summation order), so outputs agree to ~1e-6
relative; every bound below is stated against that, with headroom."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from auralis_tpu.models.xttsv2 import hifigan as jhifi
from auralis_tpu.models.xttsv2 import modules as jmod
from auralis_tpu.ops import interpolate as jinterp
from auralis_tpu.ops import mel as jmel
from auralis_tpu.ops import resample as jres
from auralis_tpu_torch.models.xttsv2 import hifigan as thifi
from auralis_tpu_torch.models.xttsv2 import modules as tmod
from auralis_tpu_torch.models.xttsv2 import weights as tw
from auralis_tpu_torch.ops import interpolate as tinterp
from auralis_tpu_torch.ops import mel as tmel
from auralis_tpu_torch.ops import resample as tres
from auralis_tpu_torch.ops.mrf import pack_hifigan_mrf


def _wav(n, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    sig = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal((batch, n))
    return sig.astype(np.float32)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("scale", [1024 / 256, 24000 / 22050])
@pytest.mark.parametrize("t", [1, 7, 64])
def test_interp_linear_scale(scale, t):
    x = np.random.default_rng(t).standard_normal((2, 3, t)).astype(np.float32)
    want = jinterp.interp_linear_scale(jnp.asarray(x), scale)
    got = tinterp.interp_linear_scale(torch.from_numpy(x), scale)
    assert got.shape == want.shape
    _close(got, want, atol=1e-6)  # two products and a sum per sample


@pytest.mark.parametrize("orig,new", [(22050, 16000), (16000, 24000), (44100, 22050)])
def test_resample(orig, new):
    x = _wav(3001, seed=orig)
    want = np.asarray(jres.resample_jax(jnp.asarray(x), orig, new))
    got = tres.resample_torch(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == want.shape
    _close(got, want, atol=1e-5)  # a ~20-tap f32 dot per sample
    # the host resampler is a verbatim copy: identical output
    np.testing.assert_array_equal(tres.resample_np(x, orig, new), jres.resample_np(x, orig, new))


def test_stft_and_mel_spectrogram():
    x = _wav(4000, batch=2)
    want = jmel.stft_mag(jnp.asarray(x), 512, 128, 400)
    got = tmel.stft_mag(torch.from_numpy(x), 512, 128, 400)
    scale = float(np.abs(want).max())
    _close(got, want, atol=1e-5 * scale)  # f32 FFT, relative to the peak bin
    want = jmel.mel_spectrogram(jnp.asarray(x), 22050, 1024, 256, 1024, 80, norm="slaney")
    got = tmel.mel_spectrogram(torch.from_numpy(x), 22050, 1024, 256, 1024, 80, norm="slaney")
    _close(got, want, atol=1e-5 * float(np.abs(want).max()))


def test_wav_to_mel_cloning():
    x = _wav(22050)
    norms = np.linspace(0.5, 2.0, 80).astype(np.float32)
    kw = dict(n_fft=2048, hop_length=256, win_length=1024)
    want = jmel.wav_to_mel_cloning(jnp.asarray(x), jnp.asarray(norms), **kw)
    got = tmel.wav_to_mel_cloning(torch.from_numpy(x), torch.from_numpy(norms), **kw)
    assert got.shape == want.shape
    _close(got, want, atol=1e-4)  # log of f32 mel; 1e-5 clamp bounds the log's slope


def test_speaker_encoder_mel():
    x = _wav(16000) * 0.5
    want = jmel.speaker_encoder_mel(jnp.asarray(x))
    got = tmel.speaker_encoder_mel(torch.from_numpy(x))
    assert got.shape == want.shape
    # log(mel + 1e-6): near-silent bins amplify f32 FFT noise by up to 1e6
    _close(got, want, atol=5e-4, rtol=1e-5)


def test_conditioning_encoder_and_perceiver():
    d, heads = 64, 4
    ce = tw.init_conditioning_encoder_params(0, spec_dim=80, embed_dim=d, attn_blocks=2)
    rng = np.random.default_rng(1)
    for blk in ce["blocks"]:  # the init zeroes proj_out; exercise it
        blk["proj_w"] = (0.02 * rng.standard_normal(blk["proj_w"].shape)).astype(np.float32)
        blk["norm_scale"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    pv = tw.init_perceiver_params(2, dim=d, num_latents=8)
    mel = rng.standard_normal((1, 40, 80)).astype(np.float32)

    want = jmod.conditioning_encoder(_jax_tree(ce), jnp.asarray(mel), heads)
    got = tmod.conditioning_encoder(tw.tree_to_torch(ce, "cpu"), torch.from_numpy(mel), heads)
    _close(got, want, atol=1e-4)  # f32, two GroupNorm+attention blocks
    want_p = jmod.perceiver_resampler(_jax_tree(pv), want)
    got_p = tmod.perceiver_resampler(tw.tree_to_torch(pv, "cpu"), torch.from_numpy(np.array(want)))
    assert got_p.shape == (1, 8, d)
    _close(got_p, want_p, atol=1e-4)  # f32, RMSNorm output is O(1)


def test_speaker_encoder():
    se = tw.init_speaker_encoder_params(3)
    x = _wav(16000, seed=4)
    want = jmod.speaker_encoder(_jax_tree(se), jnp.asarray(x))
    got = tmod.speaker_encoder(tw.tree_to_torch(se, "cpu"), torch.from_numpy(x))
    assert got.shape == (1, 512)
    _close(got, want, atol=1e-4)  # f32 SE-ResNet; the output is L2-normalized


@pytest.mark.parametrize("n_latents", [3, 9])
def test_hifi_decoder(n_latents):
    """The tiny vocoder (64 -> 32/16/8/4 channels) end to end, every MRF
    stage through the K3 wrapper (its plain version on CPU); 3 latents make
    the last stages' sequences barely longer than one conv's reach."""
    hp = tw.init_hifigan_params(5, in_channels=64, cond_channels=512, upsample_initial=64)
    rng = np.random.default_rng(6)
    for rb in hp["resblocks"]:  # non-zero biases exercise the bias path
        for conv in rb["convs1"] + rb["convs2"]:
            conv["b"] = (0.05 * rng.standard_normal(conv["b"].shape)).astype(np.float32)
    lat = rng.standard_normal((1, n_latents, 64)).astype(np.float32)
    g = rng.standard_normal((1, 512)).astype(np.float32)
    want = jhifi.hifi_decoder(_jax_tree(hp), jnp.asarray(lat), jnp.asarray(g))
    params = tw.tree_to_torch(hp, "cpu")
    stages = pack_hifigan_mrf(params["resblocks"], thifi.RESBLOCK_KERNELS, torch.float32, "cpu")
    got = thifi.hifi_decoder(params, torch.from_numpy(lat), torch.from_numpy(g), stages)
    assert got.shape == want.shape
    _close(got, want, atol=1e-5)  # tanh output, f32 convs
