"""The HiFi-GAN MRF stage (kernel K3).

Replaces the Pallas kernel behind `_run_fused_stage`
(auralis_tpu/ops/mrf.py:216, body `_make_stage_kernel` :123, driven by
`PackedMRFStage` / `pack_hifigan_mrf`): N ResBlock1 chains (k = 3/7/11, each
3 x [lrelu -> dilated conv d = 1/3/5 -> lrelu -> conv -> + residual]) over
one input, emitting the mean of the chain outputs.

Precision contract, kept by the kernel and the plain version alike:
conv inputs are rounded to the block dtype, accumulation is f32, the
residual is carried in f32 across the chain, and each chain's output is cast
to the block dtype before the f32 mean, in the order ((z1 + z2) + z3) / 3.
In f32 this is exactly the reference `_resblock1` mean.

On the H100 (csrc/mrf.cu) each conv is one launch of a fused
"[lrelu on load] -> dilated conv (f32 accumulate) -> bias -> [lrelu] /
[+ residual]" kernel, the last of each chain carrying the stage-mean
epilogue: 18 launches per 3-chain stage. The stage is FLOP-bound (~1.5 TFLOP
of convs for a 600-token chunk); the TPU's time-into-lane folding is not
carried over (see the .cu header).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

LRELU = 0.1
DILATIONS = (1, 3, 5)


class PackedMRFStage:
    """One MRF stage's weights in the kernel's layout: per chain, six
    (w [k, C, C] (the JAX [K, I, O] layout), b [C], dilation) triples in
    chain order (it0 conv1, it0 conv2, it1 conv1, ...), all in the block
    dtype on the stage's device."""

    def __init__(self, blocks: list, kernels, dtype: torch.dtype, device):
        assert len(blocks) == len(kernels)
        self.c = int(blocks[0]["convs1"][0]["w"].shape[1])
        self.dtype = dtype
        self.chains = []
        for p, k in zip(blocks, kernels):
            convs = []
            for it, (c1, c2) in enumerate(zip(p["convs1"], p["convs2"])):
                for conv, dil in ((c1, DILATIONS[it]), (c2, 1)):
                    w = torch.as_tensor(conv["w"]).to(device=device, dtype=dtype).contiguous()
                    assert w.shape == (k, self.c, self.c), w.shape
                    b = torch.as_tensor(conv["b"]).to(device=device, dtype=dtype).contiguous()
                    convs.append((w, b, dil))
            self.chains.append(convs)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return run_fused_stage(x, self)


def pack_hifigan_mrf(resblocks: list, kernels, dtype: torch.dtype, device) -> list:
    """One PackedMRFStage per generator stage (resblocks as in
    params['resblocks'], stage-major)."""
    n = len(kernels)
    assert len(resblocks) % n == 0
    return [
        PackedMRFStage(resblocks[i * n:(i + 1) * n], kernels, dtype, device)
        for i in range(len(resblocks) // n)
    ]


def _conv(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dil: int) -> torch.Tensor:
    """f32 dilated 'same' conv of [B, T, C] with a [K, I, O] weight."""
    k = w.shape[0]
    y = F.conv1d(t.float().transpose(1, 2), w.float().permute(2, 1, 0), b.float(),
                 padding=(k - 1) // 2 * dil, dilation=dil)
    return y.transpose(1, 2)


def mrf_stage_plain(x: torch.Tensor, stage: PackedMRFStage) -> torch.Tensor:
    """Plain PyTorch version of the stage under the precision contract.
    x [B, T, C] in the block dtype -> [B, T, C] in the block dtype."""
    dt = stage.dtype
    acc = None
    for convs in stage.chains:
        y = x.float()
        for it in range(len(convs) // 2):
            w1, b1, d1 = convs[2 * it]
            w2, b2, d2 = convs[2 * it + 1]
            t = F.leaky_relu(y, LRELU).to(dt)
            h = _conv(t, w1, b1, d1)
            t2 = F.leaky_relu(h, LRELU).to(dt)
            y = y + _conv(t2, w2, b2, d2)
        z = y.to(dt).float()
        acc = z if acc is None else acc + z
    return (acc / len(stage.chains)).to(dt)


def run_fused_stage(x: torch.Tensor, stage: PackedMRFStage) -> torch.Tensor:
    """x [B, T, C] (block dtype) -> stage mean [B, T, C] (block dtype).

    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise. Every conv launch adds one to `run_fused_stage.launches`."""
    if not x.is_cuda:
        return mrf_stage_plain(x, stage)
    _build.require_cuda(x, stage.chains[0][0][0])
    b, t, c = x.shape
    if c != stage.c or c % 32:
        raise ValueError(f"MRF kernel needs C == {stage.c} and C % 32 == 0, got {c}")
    if x.dtype != stage.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"input dtype {x.dtype} != stage dtype {stage.dtype}")
    x = x.contiguous()
    is_bf16 = int(x.dtype == torch.bfloat16)
    y = torch.empty((b, t, c), dtype=torch.float32, device=x.device)
    act = torch.empty_like(x)
    acc = torch.empty_like(y)
    out = torch.empty_like(x)
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    n_chains = len(stage.chains)
    for ch, convs in enumerate(stage.chains):
        n_it = len(convs) // 2
        for it in range(n_it):
            (w1, b1, d1), (w2, b2, d2) = convs[2 * it], convs[2 * it + 1]
            src = x if it == 0 else y
            src_f32 = int(it > 0 or not is_bf16)
            _build.check(
                lib.mrf_conv_lrelu(src.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                   act.data_ptr(), b, t, c, w1.shape[0], d1, is_bf16,
                                   src_f32, stream),
                "mrf_conv_lrelu",
            )
            run_fused_stage.launches += 1
            if it < n_it - 1:
                epilogue = 0
            else:
                epilogue = 2 if ch == n_chains - 1 else 1
            _build.check(
                lib.mrf_conv_residual(act.data_ptr(), src.data_ptr(), w2.data_ptr(),
                                      b2.data_ptr(), y.data_ptr(), acc.data_ptr(),
                                      out.data_ptr(), b, t, c, w2.shape[0], d2, is_bf16,
                                      src_f32, epilogue, int(ch == 0), n_chains, stream),
                "mrf_conv_residual",
            )
            run_fused_stage.launches += 1
    return out


run_fused_stage.launches = 0
