"""The plain XTTSv2 reference: conditioning, the audio-token GPT and the
HiFi-GAN vocoder as straightforward PyTorch, computed in float32.

It follows the published model (Coqui TTS `xtts.py`, `gpt.py`,
`perceiver_encoder.py`, `hifigan_decoder.py`, `resnet.py`) and reads the
weights in the benchmark's layout (`portbench/weights.py`): dense weights
[I, O], conv1d weights [K, I, O], transposed-conv weights kernel-flipped
[K, I, O], conv2d weights [kh, kw, I, O], BatchNorm folded to scale and
shift. Nothing here imports the program. Departures from the published
code, each the program's documented semantics:
- the vocoder reads the latents zero-padded past the chunk's length
  (`PAD_LATENTS`), as the program's row vocoder reads its masked bucket,
  and the waveform is cut to the chunk's length;
- the repetition penalty's seen set starts with ids {1, start_audio}, as
  the upstream vLLM prompt of `[1] * len(embeds) + [start_audio]` has it.

`Numerics` runs every dense product and convolution. In f32 (the
reference) it is a plain product; the control (`fp8=True`) first rounds
the activations per row (per tensor for a convolution) and the weights per
output channel to float8 e4m3 with a scale of amax / 448, the precision a
later change to fp8 weights and activations would serve in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
# latents of zeros the vocoder reads past a chunk's end: more than the
# generator's receptive field (~14 frames) after the x4.35 interpolation
PAD_LATENTS = 32


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """x rounded to float8 e4m3 at a scale of its amax over `dim` / 448."""
    amax = x.abs().amax(dim=dim, keepdim=True) if dim is not None else x.abs().amax()
    scale = torch.clamp(amax, min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Numerics:
    """Dense products and convolutions in f32, or through fp8 (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
        """x [..., I] @ w [I, O] (+ b)."""
        x, w = x.float(), w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        y = x @ w
        return y if b is None else y + b.float()

    def conv1d(self, x, w, b=None, padding=0, dilation=1):
        """x [B, C, T]; w [O, I, K] (torch's layout)."""
        x, w = x.float(), w.float()
        if self.fp8:
            x, w = _fp8(x, None), _fp8(w, (1, 2))
        return F.conv1d(x, w, None if b is None else b.float(), padding=padding,
                        dilation=dilation)

    def conv_transpose1d(self, x, w, b, stride, padding):
        """x [B, I, T]; w [I, O, K] (torch's layout)."""
        x, w = x.float(), w.float()
        if self.fp8:
            x, w = _fp8(x, None), _fp8(w, (0, 2))
        return F.conv_transpose1d(x, w, b.float(), stride=stride, padding=padding)


def layer_norm(x, scale, bias, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)


# --------------------------------------------------------------------- GPT
def gpt_hidden(p: dict, heads: int, embeds: torch.Tensor, num: Numerics) -> torch.Tensor:
    """GPT-2 blocks (pre-LN, causal attention, exact GELU) over the whole
    sequence embeds [T, D] -> hidden states before ln_f [T, D]."""
    x = embeds.float()
    t, d = x.shape
    dh = d // heads
    bp = p["blocks"]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for layer in range(bp["attn_w"].shape[0]):
        xn = layer_norm(x, bp["ln1_scale"][layer], bp["ln1_bias"][layer])
        qkv = num.linear(xn, bp["attn_w"][layer], bp["attn_b"][layer])
        q, k, v = (z.reshape(t, heads, dh).transpose(0, 1) for z in qkv.split(d, dim=-1))
        s = (q @ k.transpose(1, 2)) / math.sqrt(dh)
        s = s.masked_fill(~causal, float("-inf"))
        ctx = (torch.softmax(s, dim=-1) @ v).transpose(0, 1).reshape(t, d)
        x = x + num.linear(ctx, bp["attn_proj_w"][layer], bp["attn_proj_b"][layer])
        xn = layer_norm(x, bp["ln2_scale"][layer], bp["ln2_bias"][layer])
        hmid = F.gelu(num.linear(xn, bp["fc_w"][layer], bp["fc_b"][layer]))
        x = x + num.linear(hmid, bp["fc_proj_w"][layer], bp["fc_proj_b"][layer])
    return x


def gpt_outputs(p: dict, heads: int, start_audio: int, cond: torch.Tensor, ids: list,
                tokens: list, num: Numerics) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass over [cond ⊕ text(ids) ⊕ start_audio ⊕ tokens[:-1]]:
    (logits [N, A], latents [N, D]) at the positions that predict the N
    served tokens. Text position i takes text_wpe[i]; the start-audio token
    and served token j take audio positions 0 and j + 1. The logits read
    final_norm(ln_f(h)); the vocoder latents final_norm applied once more."""
    dev = cond.device
    f = lambda t: t.float()  # noqa: E731
    ids_t = torch.tensor(ids, dtype=torch.long, device=dev)
    text = f(p["text_wte"])[ids_t] + f(p["text_wpe"])[: len(ids)]
    toks = torch.tensor([start_audio] + list(tokens[:-1]), dtype=torch.long, device=dev)
    audio = f(p["wte"])[toks] + f(p["wpe"])[: len(toks)]
    h = gpt_hidden(p, heads, torch.cat([cond.float(), text, audio]), num)[-len(toks):]
    g = layer_norm(h, p["ln_f_scale"], p["ln_f_bias"])
    f1 = layer_norm(g, p["final_norm_scale"], p["final_norm_bias"])
    logits = num.linear(f1, p["mel_head_w"], p["mel_head_b"])
    return logits, layer_norm(f1, p["final_norm_scale"], p["final_norm_bias"])


def penalized(logits: torch.Tensor, tokens: list, penalty: float, start_audio: int) -> torch.Tensor:
    """The repetition penalty as the served request applied it at each
    position j: ids seen before j ({1, start_audio} and tokens[:j]) have a
    positive logit divided by `penalty` and a negative one multiplied."""
    n, a = logits.shape
    dev = logits.device
    seen = torch.zeros(n, a, dtype=torch.bool, device=dev)
    seen[:, 1] = True
    seen[:, start_audio] = True
    if n > 1:
        tok = torch.tensor(tokens[:-1], dtype=torch.long, device=dev)
        first = torch.full((a,), n, dtype=torch.long, device=dev)
        first.scatter_reduce_(0, tok, torch.arange(1, n, device=dev), reduce="amin")
        seen |= torch.arange(n, device=dev)[:, None] >= first[None, :]
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


# ------------------------------------------------------------ conditioning
def _group_norm(x, scale, bias, groups, eps=1e-5):
    """x [B, C, T]."""
    return F.group_norm(x, groups, scale.float(), bias.float(), eps)


def _norm_groups(c: int) -> int:
    groups = 32 if c > 64 else (8 if c <= 16 else 16)
    while c % groups:
        groups //= 2
    return groups


def conditioning_encoder(p: dict, mel: torch.Tensor, heads: int, num: Numerics) -> torch.Tensor:
    """Tortoise conditioning encoder: mel [B, n_mels, T] -> [B, D, T]
    (1x1 conv, then attention blocks whose residual is the normed input)."""
    x = num.linear(mel.transpose(1, 2), p["init_w"], p["init_b"])  # [B, T, D]
    for blk in p["blocks"]:
        b, t, c = x.shape
        h = _group_norm(x.transpose(1, 2), blk["norm_scale"], blk["norm_bias"],
                        _norm_groups(c)).transpose(1, 2)
        qkv = num.linear(h, blk["qkv_w"], blk["qkv_b"]).reshape(b, t, heads, 3, c // heads)
        q, k, v = qkv.unbind(3)  # [B, T, H, ch], channels head-major
        scale = 1.0 / math.sqrt(math.sqrt(c // heads))
        w = torch.einsum("bthc,bshc->bhts", q * scale, k * scale).softmax(-1)
        a = torch.einsum("bhts,bshc->bthc", w, v).reshape(b, t, c)
        x = h + num.linear(a, blk["proj_w"], blk["proj_b"])
    return x


def perceiver(p: dict, x: torch.Tensor, heads: int, num: Numerics) -> torch.Tensor:
    """Perceiver resampler: x [B, T, D] -> [B, latents, D]."""
    b = x.shape[0]
    lat = p["latents"].float().expand(b, -1, -1)
    for layer in p["layers"]:
        at, ff = layer["attn"], layer["ff"]
        ctx = torch.cat([lat, x], dim=1)
        q = num.linear(lat, at["to_q"])
        k, v = num.linear(ctx, at["to_kv"]).chunk(2, dim=-1)
        dh = q.shape[-1] // heads
        q, k, v = (z.reshape(b, z.shape[1], heads, dh).transpose(1, 2) for z in (q, k, v))
        o = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), -1) @ v
        lat = num.linear(o.transpose(1, 2).reshape(b, -1, heads * dh), at["to_out"]) + lat
        h, gate = num.linear(lat, ff["w1"], ff["b1"]).chunk(2, dim=-1)
        lat = num.linear(F.gelu(gate) * h, ff["w2"], ff["b2"]) + lat
    return F.normalize(lat, dim=-1) * math.sqrt(lat.shape[-1]) * p["norm_gamma"].float()


def _conv2d(x, w, b=None, stride=1, padding=1):
    """x [B, C, H, W]; w [kh, kw, I, O]."""
    return F.conv2d(x, w.float().permute(3, 2, 0, 1), None if b is None else b.float(),
                    stride=stride, padding=padding)


def _bn(x, scale, shift):
    return x * scale.float()[None, :, None, None] + shift.float()[None, :, None, None]


def speaker_encoder(p: dict, feats: torch.Tensor) -> torch.Tensor:
    """SE-ResNet speaker encoder with attentive statistics pooling: log-mel
    features [B, 64, frames] -> unit-norm d-vector [B, 512]."""
    x = F.instance_norm(feats.float(), eps=1e-5)[:, None]  # [B, 1, 64, frames]
    h = _bn(torch.relu(_conv2d(x, p["conv1_w"], p["conv1_b"])), p["bn1_scale"], p["bn1_shift"])
    for i in range(4):
        for j, blk in enumerate(p[f"layer{i + 1}"]):
            stride = 2 if (i > 0 and j == 0) else 1
            r = h
            y = _bn(torch.relu(_conv2d(h, blk["conv1_w"], stride=stride)),
                    blk["bn1_scale"], blk["bn1_shift"])
            y = _bn(_conv2d(y, blk["conv2_w"]), blk["bn2_scale"], blk["bn2_shift"])
            se = blk["se"]
            s = torch.relu(y.mean(dim=(2, 3)) @ se["fc1_w"].float() + se["fc1_b"].float())
            y = y * torch.sigmoid(s @ se["fc2_w"].float() + se["fc2_b"].float())[:, :, None, None]
            if "down_w" in blk:
                r = _bn(_conv2d(h, blk["down_w"], stride=stride, padding=0),
                        blk["down_bn_scale"], blk["down_bn_shift"])
            h = torch.relu(y + r)
    b, c, hh, t = h.shape
    x = h.permute(0, 3, 1, 2).reshape(b, t, c * hh)  # channel-major features
    w = torch.relu(x @ p["att1_w"].float() + p["att1_b"].float())
    w = w * p["att_bn_scale"].float() + p["att_bn_shift"].float()
    w = torch.softmax(w @ p["att2_w"].float() + p["att2_b"].float(), dim=1)
    mu = (x * w).sum(1)
    sg = torch.sqrt(torch.clamp((x * x * w).sum(1) - mu * mu, min=1e-5))
    out = torch.cat([mu, sg], -1) @ p["fc_w"].float() + p["fc_b"].float()
    return F.normalize(out, dim=-1)


# ----------------------------------------------------------------- vocoder
def hifigan(p: dict, arch: dict, frames: torch.Tensor, g: torch.Tensor,
            num: Numerics) -> torch.Tensor:
    """HiFi-GAN generator with the d-vector added at its input and after
    every upsample: frames [B, D, T] -> waveform [B, T * prod(rates)]."""
    f = lambda t: t.float()  # noqa: E731
    conv_w = lambda w: w.permute(2, 1, 0)  # noqa: E731  [K, I, O] -> [O, I, K]
    g = g.float()
    x = num.conv1d(frames, conv_w(p["conv_pre_w"]), p["conv_pre_b"], padding=3)
    x = x + (g @ f(p["cond_w"]) + f(p["cond_b"]))[:, :, None]
    kernels, dils = arch["resblock_kernel_sizes"], arch["resblock_dilation_sizes"]
    for i, (rate, k) in enumerate(zip(arch["upsample_rates"], arch["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, 0.1)
        up = p["ups"][i]
        x = num.conv_transpose1d(x, up["w"].flip(0).permute(1, 2, 0), up["b"], stride=rate,
                                 padding=(k - rate) // 2)
        x = x + (g @ f(p["conds"][i]["w"]) + f(p["conds"][i]["b"]))[:, :, None]
        acc = 0.0
        for j, rk in enumerate(kernels):
            blk = p["resblocks"][i * len(kernels) + j]
            y = x
            for d, c1, c2 in zip(dils, blk["convs1"], blk["convs2"]):
                t = num.conv1d(F.leaky_relu(y, 0.1), conv_w(c1["w"]), c1["b"],
                               padding=(rk - 1) // 2 * d, dilation=d)
                y = y + num.conv1d(F.leaky_relu(t, 0.1), conv_w(c2["w"]), c2["b"],
                                   padding=(rk - 1) // 2)
            acc = acc + y
        x = acc / len(kernels)
    x = num.conv1d(F.leaky_relu(x, 0.01), conv_w(p["conv_post_w"]), padding=3)
    return torch.tanh(x)[:, 0]


def frames_of(n: int, args: dict) -> int:
    """Post-interpolation frames of n latents: the x(code stride / hop)
    stretch, then the output-rate resampling, each floored."""
    z = math.floor(n * args["gpt_code_stride_len"] / args["output_hop_length"])
    if args["output_sample_rate"] != args["input_sample_rate"]:
        z = math.floor(z * args["output_sample_rate"] / args["input_sample_rate"])
    return z


def vocode(p: dict, args: dict, arch: dict, latents: torch.Tensor, g: torch.Tensor,
           num: Numerics) -> torch.Tensor:
    """latents [n, D] + d-vector [D_g] -> the chunk's waveform
    [frames_of(n) * hop], from the latents zero-padded by PAD_LATENTS and
    linearly interpolated as the published HifiDecoder does."""
    n = latents.shape[0]
    z = F.pad(latents.float(), (0, 0, 0, PAD_LATENTS)).T[None]  # [1, D, n + pad]
    z = F.interpolate(z, scale_factor=args["gpt_code_stride_len"] / args["output_hop_length"],
                      mode="linear")
    if args["output_sample_rate"] != args["input_sample_rate"]:
        z = F.interpolate(z, scale_factor=args["output_sample_rate"] / args["input_sample_rate"],
                          mode="linear")
    wav = hifigan(p, arch, z, g.reshape(1, -1), num)[0]
    return wav[: frames_of(n, args) * math.prod(arch["upsample_rates"])]
