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
parameters fetched to host — into torch tensors on a device. Loading the
XTTSv2 safetensors checkpoint is not part of this module yet.
"""
from __future__ import annotations

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
