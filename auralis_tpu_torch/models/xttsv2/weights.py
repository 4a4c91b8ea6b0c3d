"""Weights for the torch port: seeded random parameters and the converter
from the JAX package's parameter pytrees.

Both directions keep the JAX package's layouts, so a parameter has the same
key path, shape and meaning in both packages:
- GPT: flat dict, per-layer tensors stacked on a leading [L] axis, dense
  weights [Din, Dout] (`x @ w`);
- conditioning encoder / perceiver: dense weights [I, O];
- speaker encoder: conv weights [kh, kw, I, O], BatchNorm folded;
- HiFi-GAN: conv weights [K, I, O]; transposed-conv weights stored flipped
  [K, I, O] (the JAX lhs-dilated form). hifigan.py permutes them to
  torch's layouts inside each call.

`random_init` builds numpy pytrees with exactly the keys and shapes of the JAX
`init_*` functions (values differ: numpy's generator, not jax.random), and
`params_from_numpy` turns any such pytree — random, or the JAX package's own
parameters fetched to host — into torch tensors on a device.

Checkpoint I/O (the JAX package's weights.py): `load_gpt_params` and
`load_core_params` read the dual-safetensors layout (`gpt2_model.safetensors`
for the audio GPT, `xtts-v2.safetensors` for conditioning and the vocoder)
into numpy f32 pytrees of the same JAX layout, which `params_from_numpy` then
puts on the device, as it does `random_init`'s. Weight-norm and BatchNorm
reparametrisations are folded at load time, conv kernels transposed to
[K, I, O] (transposed convs flipped). `convert_coqui_checkpoint` turns an
original Coqui `.pth` into that layout. The numpy helpers, `load_safetensors`,
`find_artifact`, `split_coqui_state`, `infer_architecture` and
`convert_coqui_checkpoint` are verbatim copies of the JAX package's
(tests/test_torch_shared_copies.py holds them equal); `safetensors` is
imported inside the functions that need it.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from ...ops.quant import int8_weight
from .config import XTTSConfig, XTTSGPTConfig
from .hifigan import RESBLOCK_DILATIONS, RESBLOCK_KERNELS, UPSAMPLE_KERNELS


class _Init:
    """normal(scale) draws in float32 from one seeded numpy generator."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def n(self, shape, scale=0.02):
        return (scale * self.rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)


def _ones(*shape):
    return np.ones(shape, np.float32)


def _zeros(*shape):
    return np.zeros(shape, np.float32)


def init_gpt_params(cfg: XTTSGPTConfig, seed: int) -> dict:
    """Keys/shapes of auralis_tpu gpt.init_gpt_params."""
    r = _Init(seed)
    d, i, l = cfg.hidden_size, cfg.n_inner, cfg.num_hidden_layers
    return {
        "wte": r.n((cfg.num_audio_tokens, d)),
        "wpe": r.n((cfg.audio_position_table, d)),
        "text_wte": r.n((cfg.number_text_tokens, d)),
        "text_wpe": r.n((cfg.text_position_table, d)),
        "blocks": {
            "ln1_scale": _ones(l, d),
            "ln1_bias": _zeros(l, d),
            "attn_w": r.n((l, d, 3 * d)),
            "attn_b": _zeros(l, 3 * d),
            "attn_proj_w": r.n((l, d, d)),
            "attn_proj_b": _zeros(l, d),
            "ln2_scale": _ones(l, d),
            "ln2_bias": _zeros(l, d),
            "fc_w": r.n((l, d, i)),
            "fc_b": _zeros(l, i),
            "fc_proj_w": r.n((l, i, d)),
            "fc_proj_b": _zeros(l, d),
        },
        "ln_f_scale": _ones(d),
        "ln_f_bias": _zeros(d),
        "final_norm_scale": _ones(d),
        "final_norm_bias": _zeros(d),
        "mel_head_w": r.n((d, cfg.num_audio_tokens)),
        "mel_head_b": _zeros(cfg.num_audio_tokens),
    }


def init_conditioning_encoder_params(seed: int, spec_dim: int = 80, embed_dim: int = 1024,
                                     attn_blocks: int = 6) -> dict:
    """Keys/shapes of auralis_tpu modules.init_conditioning_encoder_params."""
    r = _Init(seed)
    blocks = [
        {
            "norm_scale": _ones(embed_dim),
            "norm_bias": _zeros(embed_dim),
            "qkv_w": r.n((embed_dim, 3 * embed_dim)),
            "qkv_b": _zeros(3 * embed_dim),
            "proj_w": _zeros(embed_dim, embed_dim),  # zero-init proj_out
            "proj_b": _zeros(embed_dim),
        }
        for _ in range(attn_blocks)
    ]
    return {"init_w": r.n((spec_dim, embed_dim)), "init_b": _zeros(embed_dim),
            "blocks": blocks}


def init_perceiver_params(seed: int, dim: int = 1024, depth: int = 2, num_latents: int = 32,
                          dim_head: int = 64, heads: int = 8, ff_mult: int = 4) -> dict:
    """Keys/shapes of auralis_tpu modules.init_perceiver_params."""
    r = _Init(seed)
    inner = dim_head * heads
    ff_inner = int(dim * ff_mult * 2 / 3)
    layers = [
        {
            "attn": {"to_q": r.n((dim, inner)), "to_kv": r.n((dim, inner * 2)),
                     "to_out": r.n((inner, dim))},
            "ff": {"w1": r.n((dim, ff_inner * 2)), "b1": _zeros(ff_inner * 2),
                   "w2": r.n((ff_inner, dim)), "b2": _zeros(dim)},
        }
        for _ in range(depth)
    ]
    return {"latents": r.n((num_latents, dim)), "layers": layers,
            "norm_gamma": _ones(dim)}


def init_speaker_encoder_params(seed: int) -> dict:
    """Keys/shapes of auralis_tpu modules.init_speaker_encoder_params."""
    r = _Init(seed)
    n = lambda shape: r.n(shape, 0.05)
    filters = [32, 64, 128, 256]
    layer_sizes = [3, 4, 6, 3]

    def se(ch):
        red = ch // 8
        return {"fc1_w": n((ch, red)), "fc1_b": _zeros(red),
                "fc2_w": n((red, ch)), "fc2_b": _zeros(ch)}

    def block(in_ch, ch, downsample):
        p = {
            "conv1_w": n((3, 3, in_ch, ch)),
            "bn1_scale": _ones(ch), "bn1_shift": _zeros(ch),
            "conv2_w": n((3, 3, ch, ch)),
            "bn2_scale": _ones(ch), "bn2_shift": _zeros(ch),
            "se": se(ch),
        }
        if downsample:
            p["down_w"] = n((1, 1, in_ch, ch))
            p["down_bn_scale"] = _ones(ch)
            p["down_bn_shift"] = _zeros(ch)
        return p

    params = {
        "conv1_w": n((3, 3, 1, filters[0])), "conv1_b": _zeros(filters[0]),
        "bn1_scale": _ones(filters[0]), "bn1_shift": _zeros(filters[0]),
    }
    in_ch = filters[0]
    for li, (ch, blocks) in enumerate(zip(filters, layer_sizes)):
        params[f"layer{li + 1}"] = [
            block(in_ch if j == 0 else ch, ch, j == 0 and (li > 0 or in_ch != ch))
            for j in range(blocks)
        ]
        in_ch = ch
    feat = filters[3] * (64 // 8)
    params.update({
        "att1_w": n((feat, 128)), "att1_b": _zeros(128),
        "att_bn_scale": _ones(128), "att_bn_shift": _zeros(128),
        "att2_w": n((128, feat)), "att2_b": _zeros(feat),
        "fc_w": n((feat * 2, 512)), "fc_b": _zeros(512),
    })
    return params


def init_hifigan_params(seed: int, in_channels: int = 1024, cond_channels: int = 512,
                        upsample_initial: int = 512) -> dict:
    """Keys/shapes of auralis_tpu hifigan.init_hifigan_params."""
    r = _Init(seed)
    params = {
        "conv_pre_w": r.n((7, in_channels, upsample_initial)),
        "conv_pre_b": _zeros(upsample_initial),
        "cond_w": r.n((cond_channels, upsample_initial)),
        "cond_b": _zeros(upsample_initial),
        "ups": [], "conds": [], "resblocks": [],
    }
    ch = upsample_initial
    for i, kernel in enumerate(UPSAMPLE_KERNELS):
        out_ch = upsample_initial // (2 ** (i + 1))
        params["ups"].append({"w": r.n((kernel, ch, out_ch)), "b": _zeros(out_ch)})
        params["conds"].append({"w": r.n((cond_channels, out_ch)), "b": _zeros(out_ch)})
        for rk in RESBLOCK_KERNELS:
            params["resblocks"].append({
                "convs1": [{"w": r.n((rk, out_ch, out_ch)), "b": _zeros(out_ch)}
                           for _ in RESBLOCK_DILATIONS],
                "convs2": [{"w": r.n((rk, out_ch, out_ch)), "b": _zeros(out_ch)}
                           for _ in RESBLOCK_DILATIONS],
            })
        ch = out_ch
    params["conv_post_w"] = r.n((7, ch, 1))
    return params


def random_init(cfg: XTTSConfig, seed: int = 0) -> tuple[dict, dict]:
    """(gpt, core) numpy pytrees shaped like the JAX engine's random_init."""
    g = cfg.gpt
    gpt = init_gpt_params(g, seed)
    core = {
        "cond_encoder": init_conditioning_encoder_params(
            seed + 1, spec_dim=80, embed_dim=g.hidden_size),
        "perceiver": init_perceiver_params(
            seed + 2, dim=g.hidden_size, num_latents=g.num_cond_latents),
        "speaker_encoder": init_speaker_encoder_params(seed + 3),
        "hifigan": init_hifigan_params(
            seed + 4, in_channels=g.hidden_size, cond_channels=cfg.d_vector_dim,
            upsample_initial=64 if g.hidden_size <= 128 else 512),
        "mel_stats": _ones(80),
    }
    return gpt, core


# ------------------------------------------------------- checkpoint I/O


def _fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """w = g * v / ||v|| with the norm over all dims except dim 0."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g.astype(np.float64) * v.astype(np.float64) / np.maximum(norm, 1e-12)).astype(
        np.float32
    )


def _get_conv_w(state: dict, prefix: str) -> np.ndarray:
    """Fetch a conv weight, folding weight-norm parametrization if present."""
    plain = f"{prefix}.weight"
    if plain in state:
        return np.asarray(state[plain])
    g = np.asarray(state[f"{prefix}.parametrizations.weight.original0"])
    v = np.asarray(state[f"{prefix}.parametrizations.weight.original1"])
    return _fold_weight_norm(g, v)


def _fold_bn(state: dict, prefix: str, eps: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    gamma = np.asarray(state[f"{prefix}.weight"], np.float64)
    beta = np.asarray(state[f"{prefix}.bias"], np.float64)
    mean = np.asarray(state[f"{prefix}.running_mean"], np.float64)
    var = np.asarray(state[f"{prefix}.running_var"], np.float64)
    scale = gamma / np.sqrt(var + eps)
    shift = beta - mean * scale
    return scale.astype(np.float32), shift.astype(np.float32)


def _conv1d_w(w: np.ndarray) -> np.ndarray:
    """torch Conv1d [O, I, K] -> [K, I, O]."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _convT1d_w(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose1d [I, O, K] -> kernel-flipped [K, I, O]."""
    return np.ascontiguousarray(np.transpose(w[:, :, ::-1], (2, 0, 1)))


def _conv2d_w(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [O, I, kh, kw] -> [kh, kw, I, O]."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _f32(x: np.ndarray) -> np.ndarray:
    """A leaf on the host in f32 (the JAX loaders' `_j(x, jnp.float32)`);
    `params_from_numpy` casts and uploads it."""
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------- GPT


def load_gpt_params(state: dict, cfg: XTTSGPTConfig) -> dict:
    """`gpt2_model.safetensors` tensors -> GPT numpy f32 pytree (text
    embeddings are merged in later from the core artifact)."""
    l = cfg.num_hidden_layers

    def stack(pattern: str) -> np.ndarray:
        return np.stack([_f32(state[pattern.format(i)]) for i in range(l)])

    params = {
        "wte": _f32(state["gpt.wte.weight"]),
        "wpe": _f32(state["gpt.wpe.emb.weight"]),
        "blocks": {
            "ln1_scale": stack("gpt.h.{}.ln_1.weight"),
            "ln1_bias": stack("gpt.h.{}.ln_1.bias"),
            "attn_w": stack("gpt.h.{}.attn.c_attn.weight"),  # Conv1D is [in,out]
            "attn_b": stack("gpt.h.{}.attn.c_attn.bias"),
            "attn_proj_w": stack("gpt.h.{}.attn.c_proj.weight"),
            "attn_proj_b": stack("gpt.h.{}.attn.c_proj.bias"),
            "ln2_scale": stack("gpt.h.{}.ln_2.weight"),
            "ln2_bias": stack("gpt.h.{}.ln_2.bias"),
            "fc_w": stack("gpt.h.{}.mlp.c_fc.weight"),
            "fc_b": stack("gpt.h.{}.mlp.c_fc.bias"),
            "fc_proj_w": stack("gpt.h.{}.mlp.c_proj.weight"),
            "fc_proj_b": stack("gpt.h.{}.mlp.c_proj.bias"),
        },
        "ln_f_scale": _f32(state["gpt.ln_f.weight"]),
        "ln_f_bias": _f32(state["gpt.ln_f.bias"]),
        "final_norm_scale": _f32(state["final_norm.weight"]),
        "final_norm_bias": _f32(state["final_norm.bias"]),
        # nn.Linear is [out,in] -> ours [in,out]
        "mel_head_w": _f32(np.asarray(state["mel_head.weight"]).T),
        "mel_head_b": _f32(state["mel_head.bias"]),
    }
    return params


# -------------------------------------------------------------- core stack


def load_core_params(state: dict, cfg: XTTSConfig) -> dict:
    """`xtts-v2.safetensors` tensors -> conditioning/vocoder numpy f32
    pytrees."""
    gcfg = cfg.gpt

    # conditioning encoder
    n_blocks = 0
    while f"conditioning_encoder.attn.{n_blocks}.norm.weight" in state:
        n_blocks += 1
    cond_encoder = {
        # 1x1 conv [O, I, 1] -> matmul weight [I, O]
        "init_w": _f32(np.asarray(state["conditioning_encoder.init.weight"])[:, :, 0].T),
        "init_b": _f32(state["conditioning_encoder.init.bias"]),
        "blocks": [],
    }
    for i in range(n_blocks):
        p = f"conditioning_encoder.attn.{i}"
        cond_encoder["blocks"].append(
            {
                "norm_scale": _f32(state[f"{p}.norm.weight"]),
                "norm_bias": _f32(state[f"{p}.norm.bias"]),
                "qkv_w": _f32(np.asarray(state[f"{p}.qkv.weight"])[:, :, 0].T),
                "qkv_b": _f32(state[f"{p}.qkv.bias"]),
                "proj_w": _f32(np.asarray(state[f"{p}.proj_out.weight"])[:, :, 0].T),
                "proj_b": _f32(state[f"{p}.proj_out.bias"]),
            }
        )

    # perceiver resampler
    depth = 0
    while f"conditioning_perceiver.layers.{depth}.0.to_q.weight" in state:
        depth += 1
    perceiver = {
        "latents": _f32(state["conditioning_perceiver.latents"]),
        "layers": [],
        "norm_gamma": _f32(state["conditioning_perceiver.norm.gamma"]),
    }
    for i in range(depth):
        p = f"conditioning_perceiver.layers.{i}"
        perceiver["layers"].append(
            {
                "attn": {
                    "to_q": _f32(np.asarray(state[f"{p}.0.to_q.weight"]).T),
                    "to_kv": _f32(np.asarray(state[f"{p}.0.to_kv.weight"]).T),
                    "to_out": _f32(np.asarray(state[f"{p}.0.to_out.weight"]).T),
                },
                "ff": {
                    "w1": _f32(np.asarray(state[f"{p}.1.0.weight"]).T),
                    "b1": _f32(state[f"{p}.1.0.bias"]),
                    "w2": _f32(np.asarray(state[f"{p}.1.2.weight"]).T),
                    "b2": _f32(state[f"{p}.1.2.bias"]),
                },
            }
        )

    # speaker encoder (BN folded)
    se_prefix = "hifigan_decoder.speaker_encoder"

    def se_block(p: str) -> dict:
        blk = {
            "conv1_w": _f32(_conv2d_w(np.asarray(state[f"{p}.conv1.weight"]))),
            "conv2_w": _f32(_conv2d_w(np.asarray(state[f"{p}.conv2.weight"]))),
            "se": {
                "fc1_w": _f32(np.asarray(state[f"{p}.se.fc.0.weight"]).T),
                "fc1_b": _f32(state[f"{p}.se.fc.0.bias"]),
                "fc2_w": _f32(np.asarray(state[f"{p}.se.fc.2.weight"]).T),
                "fc2_b": _f32(state[f"{p}.se.fc.2.bias"]),
            },
        }
        for bn in ("bn1", "bn2"):
            scale, shift = _fold_bn(state, f"{p}.{bn}")
            blk[f"{bn}_scale"], blk[f"{bn}_shift"] = _f32(scale), _f32(shift)
        if f"{p}.downsample.0.weight" in state:
            blk["down_w"] = _f32(_conv2d_w(np.asarray(state[f"{p}.downsample.0.weight"])))
            scale, shift = _fold_bn(state, f"{p}.downsample.1")
            blk["down_bn_scale"], blk["down_bn_shift"] = _f32(scale), _f32(shift)
        return blk

    speaker = {
        "conv1_w": _f32(_conv2d_w(np.asarray(state[f"{se_prefix}.conv1.weight"]))),
        "conv1_b": _f32(state[f"{se_prefix}.conv1.bias"]),
        "att1_w": _f32(np.asarray(state[f"{se_prefix}.attention.0.weight"])[:, :, 0].T),
        "att1_b": _f32(state[f"{se_prefix}.attention.0.bias"]),
        "att2_w": _f32(np.asarray(state[f"{se_prefix}.attention.3.weight"])[:, :, 0].T),
        "att2_b": _f32(state[f"{se_prefix}.attention.3.bias"]),
        "fc_w": _f32(np.asarray(state[f"{se_prefix}.fc.weight"]).T),
        "fc_b": _f32(state[f"{se_prefix}.fc.bias"]),
    }
    scale, shift = _fold_bn(state, f"{se_prefix}.bn1")
    speaker["bn1_scale"], speaker["bn1_shift"] = _f32(scale), _f32(shift)
    scale, shift = _fold_bn(state, f"{se_prefix}.attention.2")
    speaker["att_bn_scale"], speaker["att_bn_shift"] = _f32(scale), _f32(shift)
    for li in range(1, 5):
        blocks = []
        j = 0
        while f"{se_prefix}.layer{li}.{j}.conv1.weight" in state:
            blocks.append(se_block(f"{se_prefix}.layer{li}.{j}"))
            j += 1
        speaker[f"layer{li}"] = blocks

    # hifigan generator (weight-norm folded)
    hg = "hifigan_decoder.waveform_decoder"
    n_ups = 0
    while f"{hg}.ups.{n_ups}.parametrizations.weight.original0" in state or f"{hg}.ups.{n_ups}.weight" in state:
        n_ups += 1
    n_res = 0
    while (
        f"{hg}.resblocks.{n_res}.convs1.0.parametrizations.weight.original0" in state
        or f"{hg}.resblocks.{n_res}.convs1.0.weight" in state
    ):
        n_res += 1

    def rb(p: str, n_convs: int = 3) -> dict:
        return {
            "convs1": [
                {"w": _f32(_conv1d_w(_get_conv_w(state, f"{p}.convs1.{i}"))),
                 "b": _f32(state[f"{p}.convs1.{i}.bias"])}
                for i in range(n_convs)
            ],
            "convs2": [
                {"w": _f32(_conv1d_w(_get_conv_w(state, f"{p}.convs2.{i}"))),
                 "b": _f32(state[f"{p}.convs2.{i}.bias"])}
                for i in range(n_convs)
            ],
        }

    hifigan = {
        "conv_pre_w": _f32(_conv1d_w(_get_conv_w(state, f"{hg}.conv_pre"))),
        "conv_pre_b": _f32(state[f"{hg}.conv_pre.bias"]),
        "cond_w": _f32(np.asarray(state[f"{hg}.cond_layer.weight"])[:, :, 0].T),
        "cond_b": _f32(state[f"{hg}.cond_layer.bias"]),
        "ups": [
            {"w": _f32(_convT1d_w(_get_conv_w(state, f"{hg}.ups.{i}"))),
             "b": _f32(state[f"{hg}.ups.{i}.bias"])}
            for i in range(n_ups)
        ],
        "conds": [
            {"w": _f32(np.asarray(state[f"{hg}.conds.{i}.weight"])[:, :, 0].T),
             "b": _f32(state[f"{hg}.conds.{i}.bias"])}
            for i in range(n_ups)
        ],
        "resblocks": [rb(f"{hg}.resblocks.{i}") for i in range(n_res)],
        "conv_post_w": _f32(_conv1d_w(_get_conv_w(state, f"{hg}.conv_post"))),
    }

    return {
        "cond_encoder": cond_encoder,
        "perceiver": perceiver,
        "speaker_encoder": speaker,
        "hifigan": hifigan,
        "mel_stats": _f32(state.get("mel_stats", np.ones(80, np.float32))),
        "text_wte": _f32(state["text_embedding.weight"]),
        "text_wpe": _f32(state["text_pos_embedding.emb.weight"]),
        "final_norm_scale": _f32(state["final_norm.weight"]),
        "final_norm_bias": _f32(state["final_norm.bias"]),
    }


def load_safetensors(path: str | Path) -> dict:
    from safetensors.numpy import load_file

    return load_file(str(path))


def find_artifact(model_dir: str | Path, names: tuple[str, ...]) -> Path:
    model_dir = Path(model_dir)
    for name in names:
        for cand in (model_dir / name, *model_dir.glob(f"**/{name}")):
            if cand.is_file():
                return cand
    raise FileNotFoundError(f"None of {names} found under {model_dir}")


# ------------------------------------------------------- coqui converter


GPT_BLOCK_SUFFIXES = (
    "ln_1.weight", "ln_1.bias", "attn.c_attn.weight", "attn.c_attn.bias",
    "attn.c_proj.weight", "attn.c_proj.bias", "ln_2.weight", "ln_2.bias",
    "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias",
)


def split_coqui_state(model_state: dict) -> tuple[dict, dict]:
    """Split a Coqui/Auralis flat state dict into (gpt, core) tensor maps with
    the key remapping of the reference converter (checkpoint_converter.py:
    225-284): mel_embedding -> gpt.wte, mel_pos_embedding -> gpt.wpe.emb,
    transformer blocks under gpt.h, everything else (minus dvae/training
    featurizers) into the core artifact."""
    drop = ("dvae", "torch_mel_spectrogram_style_encoder", "torch_mel_spectrogram_dvae")
    gpt_state: dict = {}
    core_state: dict = {}
    for key, tensor in model_state.items():
        if any(d in key for d in drop):
            continue
        key = key.replace("xtts.", "")
        if "mel_embedding.weight" in key:
            gpt_state["gpt.wte.weight"] = tensor
        elif "mel_pos_embedding.emb.weight" in key:
            gpt_state["gpt.wpe.emb.weight"] = tensor
        elif "mel_head" in key:
            gpt_state[key.replace("gpt.", "")] = tensor
        elif any(key.endswith(s) for s in GPT_BLOCK_SUFFIXES) and ".h." in key:
            gpt_state[key.replace("gpt.gpt.", "gpt.")] = tensor
        elif key.endswith(("ln_f.weight", "ln_f.bias")):
            gpt_state[key.replace("gpt.gpt.", "gpt.")] = tensor
        elif "final_norm" in key:
            clean = key.replace("gpt.", "")
            gpt_state[clean] = tensor
            core_state[clean] = tensor
        else:
            core_state[key.replace("gpt.", "")] = tensor
    return gpt_state, core_state


def infer_architecture(gpt_state: dict) -> dict:
    """Shape-driven architecture inference (capability parity with reference
    analyze_model_architecture, checkpoint_converter.py:10-68)."""
    arch: dict = {}
    if "gpt.wte.weight" in gpt_state:
        v, d = np.asarray(gpt_state["gpt.wte.weight"]).shape
        arch.update(num_audio_tokens=v, hidden_size=d, decoder_input_dim=d,
                    start_audio_token=v - 2, stop_audio_token=v - 1)
    layers = [
        int(m.group(1))
        for k in gpt_state
        if (m := re.match(r"gpt\.h\.(\d+)\.", k))
    ]
    if layers:
        arch["num_hidden_layers"] = max(layers) + 1
    for k, t in gpt_state.items():
        if k.endswith("attn.c_attn.weight"):
            d = np.asarray(t).shape[0]
            arch["num_attention_heads"] = d // 64 if d % 64 == 0 else 1
        if k.endswith("mlp.c_fc.weight"):
            arch["n_inner"] = np.asarray(t).shape[1]
    if "gpt.wpe.emb.weight" in gpt_state:
        arch["max_audio_tokens"] = np.asarray(gpt_state["gpt.wpe.emb.weight"]).shape[0] - 3
    return arch


def convert_coqui_checkpoint(checkpoint_path: str, output_dir: str) -> tuple[str, str]:
    """Coqui `.pth` -> dual safetensors + configs (the reference's converter
    CLI capability). Uses torch only here, for unpickling the checkpoint."""
    import torch
    from safetensors.numpy import save_file

    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    model_state = ckpt.get("model", ckpt)
    model_state = {k: np.asarray(v.detach().float().numpy()) if hasattr(v, "detach") else np.asarray(v)
                   for k, v in model_state.items()}
    gpt_state, core_state = split_coqui_state(model_state)
    arch = infer_architecture(gpt_state)

    gpt_dir = Path(output_dir) / "gpt"
    core_dir = Path(output_dir) / "core_xttsv2"
    gpt_dir.mkdir(parents=True, exist_ok=True)
    core_dir.mkdir(parents=True, exist_ok=True)

    save_file(gpt_state, str(gpt_dir / "gpt2_model.safetensors"))
    save_file(core_state, str(core_dir / "xtts-v2.safetensors"))

    gpt_cfg = XTTSGPTConfig.from_dict(arch)
    core_cfg = XTTSConfig.from_dict({"gpt_config": gpt_cfg.to_dict(), **{
        k: v for k, v in arch.items() if k in ("decoder_input_dim",)
    }})
    (gpt_dir / "config.json").write_text(json.dumps(gpt_cfg.to_dict(), indent=2, default=str))
    (core_dir / "config.json").write_text(json.dumps(core_cfg.to_dict(), indent=2, default=str))
    return str(gpt_dir), str(core_dir)


def tree_to_torch(tree, device, dtype: torch.dtype | None = None):
    """Map every array leaf of a nested dict/list pytree to a torch tensor on
    `device`; floating leaves are cast to `dtype` when given."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.require(np.asarray(tree), requirements=["C", "W"]))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(gpt: dict, core: dict, device="cuda",
                      dtype: torch.dtype = torch.float32) -> tuple[dict, dict]:
    """JAX-layout numpy pytrees -> (GPT params in `dtype`, core params in
    float32) as torch tensors on `device`. The engine casts the vocoder to
    its own dtype. A `blocks_q8` entry (gpt.quantize_decode_weights) keeps
    its types: int8 weights (laid out by `int8_weight`) and f32 scales, as
    in JAX."""
    gpt = dict(gpt)
    blocks_q8 = gpt.pop("blocks_q8", None)
    params = tree_to_torch(gpt, device, dtype)
    if blocks_q8 is not None:
        params["blocks_q8"] = {k: int8_weight(v) if k.endswith("_q") else v
                               for k, v in tree_to_torch(blocks_q8, device).items()}
    return params, tree_to_torch(core, device, torch.float32)
