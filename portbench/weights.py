"""Seeded random XTTSv2 weights, made on the device, in the layout of the
port's loading entry (`XTTSv2Engine(params=, core=)`): the converted
checkpoint's layout, which both the program and the reference read.

- GPT (`params`): a flat dict, per-layer tensors stacked on a leading [L]
  axis, dense weights [Din, Dout]; every leaf in the served type (bf16).
- Conditioning encoder, perceiver, speaker encoder (`core`): f32, dense
  weights [I, O], conv2d weights [kh, kw, I, O], BatchNorm folded to
  scale and shift.
- HiFi-GAN (`core["hifigan"]`): f32 tensors holding bf16 values (the engine
  serves the vocoder in bf16, so its cast is exact); conv weights [K, I, O],
  transposed-conv weights stored kernel-flipped [K, I, O].

Every leaf is a slice of one normal draw, made by a `torch.Generator` on
`device` seeded with the run's seed, then scaled: the GPT's, the
conditioning encoder's and the perceiver's matrices by 0.02 (GPT-2's
initialisation); the convolutions of the speaker encoder and the vocoder,
and the speaker encoder's dense layers, by gain / sqrt(fan-in), so that
activations keep their scale through the depth (with 0.02 a layer the
vocoder's signal fell under its biases and its output was a near-constant
level); biases by 0.02 (0.01 in the vocoder), norm scales as 1 + 0.02 N
(BatchNorm's as 1 + 0.05 N), the mel norms as exp(0.1 N). Biases and norm
scales are not left at 0 and 1, so the reference checks the paths that read
them.
"""
from __future__ import annotations

import math

import torch

# leaf kinds: (scale of the normal draw, offset)
_KINDS = {"w": (0.02, 0.0), "b": (0.02, 0.0), "one": (0.02, 1.0), "bn": (0.05, 1.0),
          "bnb": (0.05, 0.0), "vb": (0.01, 0.0), "cond": (0.1, 0.0)}
RELU_GAIN = math.sqrt(2.0)
STOP_LOGIT_BIAS = -1.0e4


def _fan(fan_in: int, gain: float = RELU_GAIN) -> tuple:
    """A leaf kind scaled by gain / sqrt(fan_in)."""
    return ("fan", gain / math.sqrt(fan_in))


def _gpt_spec(a: dict, arch: dict) -> dict:
    d, i, n = a["gpt_n_model_channels"], arch["gpt_n_inner"], a["gpt_layers"]
    audio = a["gpt_num_audio_tokens"]
    return {
        "wte": ((audio, d), "w"),
        "wpe": ((a["gpt_max_audio_tokens"] + 3, d), "w"),
        "text_wte": ((a["gpt_number_text_tokens"], d), "w"),
        "text_wpe": ((a["gpt_max_text_tokens"] + 2, d), "w"),
        "blocks": {
            "ln1_scale": ((n, d), "one"), "ln1_bias": ((n, d), "b"),
            "attn_w": ((n, d, 3 * d), "w"), "attn_b": ((n, 3 * d), "b"),
            "attn_proj_w": ((n, d, d), "w"), "attn_proj_b": ((n, d), "b"),
            "ln2_scale": ((n, d), "one"), "ln2_bias": ((n, d), "b"),
            "fc_w": ((n, d, i), "w"), "fc_b": ((n, i), "b"),
            "fc_proj_w": ((n, i, d), "w"), "fc_proj_b": ((n, d), "b"),
        },
        "ln_f_scale": ((d,), "one"), "ln_f_bias": ((d,), "b"),
        "final_norm_scale": ((d,), "one"), "final_norm_bias": ((d,), "b"),
        "mel_head_w": ((d, audio), "w"), "mel_head_b": ((audio,), "b"),
    }


def _core_spec(a: dict, arch: dict) -> dict:
    d = a["gpt_n_model_channels"]
    ce, pv, se, hg = arch["cond_encoder"], arch["perceiver"], arch["speaker_encoder"], arch["hifigan"]
    inner = pv["dim_head"] * pv["heads"]
    ff = int(d * pv["ff_mult"] * 2 / 3)
    cond = {"init_w": ((ce["spec_dim"], d), "w"), "init_b": ((d,), "b"),
            "blocks": [{"norm_scale": ((d,), "one"), "norm_bias": ((d,), "b"),
                        "qkv_w": ((d, 3 * d), "w"), "qkv_b": ((3 * d,), "b"),
                        "proj_w": ((d, d), "w"), "proj_b": ((d,), "b")}
                       for _ in range(ce["attn_blocks"])]}
    perceiver = {"latents": ((pv["num_latents"], d), "w"),
                 "layers": [{"attn": {"to_q": ((d, inner), "w"), "to_kv": ((d, 2 * inner), "w"),
                                      "to_out": ((inner, d), "w")},
                             "ff": {"w1": ((d, 2 * ff), "w"), "b1": ((2 * ff,), "b"),
                                    "w2": ((ff, d), "w"), "b2": ((d,), "b")}}
                            for _ in range(pv["depth"])],
                 "norm_gamma": ((d,), "one")}

    def se_block(cin, ch, down):
        red = ch // se["se_reduction"]
        p = {"conv1_w": ((3, 3, cin, ch), _fan(9 * cin)), "bn1_scale": ((ch,), "bn"),
             "bn1_shift": ((ch,), "bnb"), "conv2_w": ((3, 3, ch, ch), _fan(9 * ch, 1.0)),
             "bn2_scale": ((ch,), "bn"), "bn2_shift": ((ch,), "bnb"),
             "se": {"fc1_w": ((ch, red), _fan(ch)), "fc1_b": ((red,), "bnb"),
                    "fc2_w": ((red, ch), _fan(red, 1.0)), "fc2_b": ((ch,), "bnb")}}
        if down:
            p.update({"down_w": ((1, 1, cin, ch), _fan(cin, 1.0)),
                      "down_bn_scale": ((ch,), "bn"), "down_bn_shift": ((ch,), "bnb")})
        return p

    f = se["filters"]
    speaker = {"conv1_w": ((3, 3, 1, f[0]), _fan(9)), "conv1_b": ((f[0],), "bnb"),
               "bn1_scale": ((f[0],), "bn"), "bn1_shift": ((f[0],), "bnb")}
    cin = f[0]
    for li, (ch, nb) in enumerate(zip(f, se["layers"])):
        speaker[f"layer{li + 1}"] = [se_block(cin if j == 0 else ch, ch,
                                              j == 0 and (li > 0 or cin != ch))
                                     for j in range(nb)]
        cin = ch
    feat = f[-1] * (se["n_mels"] // 8)
    att = se["attention_dim"]
    speaker.update({"att1_w": ((feat, att), _fan(feat)), "att1_b": ((att,), "bnb"),
                    "att_bn_scale": ((att,), "bn"), "att_bn_shift": ((att,), "bnb"),
                    "att2_w": ((att, feat), _fan(att, 1.0)), "att2_b": ((feat,), "bnb"),
                    "fc_w": ((2 * feat, a["d_vector_dim"]), _fan(2 * feat, 1.0)),
                    "fc_b": ((a["d_vector_dim"],), "bnb")})

    g, ch = a["d_vector_dim"], hg["upsample_initial_channel"]
    din = a["decoder_input_dim"]
    hifigan = {"conv_pre_w": ((7, din, ch), _fan(7 * din, 1.0)), "conv_pre_b": ((ch,), "vb"),
               "cond_w": ((g, ch), "cond"), "cond_b": ((ch,), "vb"),
               "ups": [], "conds": [], "resblocks": []}
    for i, (k, rate) in enumerate(zip(hg["upsample_kernel_sizes"], hg["upsample_rates"])):
        out = hg["upsample_initial_channel"] // 2 ** (i + 1)
        hifigan["ups"].append({"w": ((k, ch, out), _fan(k // rate * ch)), "b": ((out,), "vb")})
        hifigan["conds"].append({"w": ((g, out), "cond"), "b": ((out,), "vb")})
        for rk in hg["resblock_kernel_sizes"]:
            hifigan["resblocks"].append({
                f"convs{j}": [{"w": ((rk, out, out), _fan(rk * out, 0.5)), "b": ((out,), "vb")}
                              for _ in hg["resblock_dilation_sizes"]] for j in (1, 2)})
        ch = out
    hifigan["conv_post_w"] = ((7, ch, 1), _fan(7 * ch, 0.5))
    return {"cond_encoder": cond, "perceiver": perceiver, "speaker_encoder": speaker,
            "hifigan": hifigan, "mel_stats": ((ce["spec_dim"],), "mel")}


def _leaves(spec, path=()):
    if isinstance(spec, dict):
        for k, v in spec.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(spec, list):
        for i, v in enumerate(spec):
            yield from _leaves(v, path + (i,))
    else:
        yield path, spec


def _fill(spec, draw: torch.Tensor, offset: list):
    """The spec's tree with each (shape, kind) leaf taken from `draw`."""
    if isinstance(spec, dict):
        return {k: _fill(v, draw, offset) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_fill(v, draw, offset) for v in spec]
    shape, kind = spec
    n = math.prod(shape)
    x = draw[offset[0]:offset[0] + n].view(shape)
    offset[0] += n
    if kind == "mel":
        return torch.exp(0.1 * x)
    scale, base = (kind[1], 0.0) if isinstance(kind, tuple) else _KINDS[kind]
    return x * scale + base


def _make(spec, generator: torch.Generator, device) -> dict:
    total = sum(math.prod(shape) for _, (shape, _) in _leaves(spec))
    draw = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    return _fill(spec, draw, [0])


def make_weights(config: dict, seed: int, device) -> tuple[dict, dict]:
    """(GPT params in bf16, core params in f32) for the configuration file
    `config` (its `model_args` and `architecture`), from `seed`, on
    `device`: two normal draws, one for the GPT and one for the rest."""
    a, arch = config["model_args"], config["architecture"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    gpt = _make(_gpt_spec(a, arch), gen, device)
    # random weights would sample the stop token at random steps; with its
    # logit held far down each chunk runs to its request's cap, which
    # stands in for the stop a trained model would sample
    gpt["mel_head_b"][a["gpt_stop_audio_token"]] = STOP_LOGIT_BIAS
    gpt = _map(gpt, lambda t: t.to(torch.bfloat16))
    core = _make(_core_spec(a, arch), gen, device)
    core["hifigan"] = _map(core["hifigan"], lambda t: t.to(torch.bfloat16).float())
    return gpt, core


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)
