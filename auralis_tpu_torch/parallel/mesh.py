"""Device mesh and sharding rules over the model axis.

Counterpart of auralis_tpu/parallel/mesh.py. The axes keep their names and
meaning:
- "data": slot-parallel serving (the decode state's slot dimension split
  across data shards);
- "model": Megatron-style tensor parallelism over attention heads and MLP
  columns, a latency knob (tp in the reference, XTTSv2.py:57);
- "dcn": data parallelism across hosts.

The JAX package places pytrees with NamedShardings and lets GSPMD emit the
collectives. Here one process drives the mesh as JAX's single controller
does: `shard_gpt_params` gives each model shard its slice of the weights on
its device (`ShardedParams`), `shard_decode_state` splits the KV cache's
lanes per head (`ShardedKVCache`), and the GPT's sharded forward
(models/xttsv2/gpt.py) sums the row-parallel partials on every device. A
mesh may repeat one device, which runs the sharded math on one card.

The specs are plain data (a tuple of axis names per leaf, the JAX
PartitionSpec's entries), so they compare with the JAX package's.

Not ported yet: the data and dcn axes of a decode state (slots split across
data shards), which only the JAX package's tests use; `shard_gpt_params`
and `shard_decode_state` refuse a mesh with data or dcn shards
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"  # inter-host data parallelism (multi-slice serving)

_DATA_AXES_ERROR = (
    "the data and dcn axes of a decode state (slots split across data shards) are not "
    "ported yet (ROADMAP.md, queue 1); use a mesh with data=1 and dcn_data=1")


def P(*axes) -> tuple:
    """A partition spec: the mesh axis (or None) of each dimension, as JAX's
    PartitionSpec lists them."""
    return axes


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Multi-process bootstrap (`torch.distributed.init_process_group`, NCCL
    on the card, gloo on the CPU). Reads the environment when arguments are
    omitted (AURALIS_COORDINATOR_ADDRESS / AURALIS_NUM_PROCESSES /
    AURALIS_PROCESS_ID, or their JAX_* names, as the JAX package does); a
    no-op returning False in a single process. The coordinator is
    `host:port` or a URL (`tcp://host:port`)."""

    def env(*names):
        for n in names:
            v = os.environ.get(n)
            if v:
                return v
        return None

    coordinator_address = coordinator_address or env(
        "AURALIS_COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        v = env("AURALIS_NUM_PROCESSES", "JAX_NUM_PROCESSES")
        num_processes = int(v) if v else 1
    if num_processes <= 1:
        return False
    if process_id is None:
        v = env("AURALIS_PROCESS_ID", "JAX_PROCESS_ID")
        process_id = int(v) if v else None
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"{num_processes} processes need a coordinator address and this process's id "
            "(arguments or AURALIS_COORDINATOR_ADDRESS / AURALIS_PROCESS_ID)")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    torch.distributed.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo", init_method=coordinator_address,
        world_size=num_processes, rank=process_id)
    return True


class Mesh:
    """A grid of torch devices with named axes (the jax.sharding.Mesh
    subset this package uses). A device may appear more than once."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def model_devices(self) -> list:
        """The devices of the model axis, shard 0 first. A mesh with data or
        dcn shards raises NotImplementedError (see the module docstring)."""
        if self.devices.size != self.shape[MODEL_AXIS]:
            raise NotImplementedError(_DATA_AXES_ERROR)
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def default_devices() -> list:
    """Every visible GPU, in order, or the CPU when there is none."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]


def make_mesh(
    devices: Optional[list] = None, data: int = 1, model: int = 1,
    dcn_data: int = 1,
) -> Mesh:
    """Device mesh of data x model devices, with a leading "dcn" axis when
    `dcn_data` > 1 (the JAX package's axes; one process drives it, so the
    hybrid placement of a multi-host JAX mesh is a plain reshape here).
    `devices` defaults to every visible GPU and may repeat a device."""
    devices = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    n = dcn_data * data * model
    if n > len(devices):
        raise ValueError(
            f"mesh {dcn_data}x{data}x{model} needs {n} devices, have {len(devices)}"
        )
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = d
    if dcn_data <= 1:
        return Mesh(grid.reshape(data, model), (DATA_AXIS, MODEL_AXIS))
    return Mesh(grid.reshape(dcn_data, data, model), (DCN_AXIS, DATA_AXIS, MODEL_AXIS))


# --------------------------------------------------------------- GPT params
def gpt_param_specs() -> dict:
    """Partition specs of the GPT parameter dict (gpt.py), those of the JAX
    package. Column-parallel: qkv and mlp-in split their output dim;
    row-parallel: attn-proj and mlp-out split their input dim (the sharded
    forward sums their partials). The embeddings and heads replicate."""
    tp = MODEL_AXIS
    return {
        # embedding tables and the mel head are ~2 MB total and the audio
        # vocab (1026) doesn't divide common tp degrees — replicate them
        "wte": P(),
        "wpe": P(),
        "text_wte": P(),
        "text_wpe": P(),
        "blocks": {
            "ln1_scale": P(None, None),
            "ln1_bias": P(None, None),
            "attn_w": P(None, None, tp),
            "attn_b": P(None, tp),
            "attn_proj_w": P(None, tp, None),
            "attn_proj_b": P(None, None),
            "ln2_scale": P(None, None),
            "ln2_bias": P(None, None),
            "fc_w": P(None, None, tp),
            "fc_b": P(None, tp),
            "fc_proj_w": P(None, tp, None),
            "fc_proj_b": P(None, None),
        },
        "ln_f_scale": P(),
        "ln_f_bias": P(),
        "final_norm_scale": P(),
        "final_norm_bias": P(),
        "mel_head_w": P(),
        "mel_head_b": P(),
    }


def decode_state_specs(dcn: bool = False) -> dict:
    """Partition specs of the decode state, those of the JAX package: slots
    ride the data axis (and "dcn" on hybrid meshes), KV lanes (flat H*Dh)
    ride the model axis; head h owns lanes [h*Dh, (h+1)*Dh), so lane
    sharding IS head sharding as long as tp divides the head count."""
    dp = (DCN_AXIS, DATA_AXIS) if dcn else DATA_AXIS
    tp = MODEL_AXIS
    return {
        "cache": {
            "k": P(None, dp, None, tp),
            "v": P(None, dp, None, tp),
            # int8-mode per-token scales [L, S, T]: slot-sharded, replicated
            # over the model axis (every head shard needs every token scale)
            "k_scale": P(None, dp, None),
            "v_scale": P(None, dp, None),
        },
        "sampling": {
            "temperature": P(dp),
            "top_p": P(dp),
            "top_k": P(dp),
            "repetition_penalty": P(dp),
            "do_sample": P(dp),
            "max_new": P(dp),
            "seen": P(dp, None),
        },
        "seq_lens": P(dp),
        "audio_pos": P(dp),
        "last_token": P(dp),
        "active": P(dp),
        "done": P(dp),
        "tokens_buf": P(dp, None),
        "latents_buf": P(dp, None, None),
        "n_generated": P(dp),
        "rng": P(),
    }


def _model_slice(x: torch.Tensor, spec: tuple, r: int, tp: int, fused: int = 1) -> torch.Tensor:
    """Shard r's piece of x by `spec`: the dimension that names the model
    axis cut into tp equal parts. With `fused` > 1 that dimension holds
    `fused` concatenated blocks (q | k | v), and the shard takes its part of
    each, concatenated in order."""
    if MODEL_AXIS not in spec:
        return x
    dim = spec.index(MODEL_AXIS)
    if x.shape[dim] % (tp * fused):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {fused} x {tp}")
    blocks = x.chunk(fused, dim=dim)
    return torch.cat([b.chunk(tp, dim=dim)[r] for b in blocks], dim=dim)


def shard_gpt_params(params: dict, mesh: Mesh):
    """The GPT parameters placed on the mesh's model shards per
    `gpt_param_specs`: a `ShardedParams` whose `shards[r]` is shard r's
    parameter dict on its device. The fused qkv weight and bias split per
    head, so shard r holds [q_r | k_r | v_r] with q_r the columns of heads
    [r H/tp, (r+1) H/tp) (JAX's contiguous cut of the 3D axis is repaired by
    GSPMD's collectives; a literal copy would hand shard 0 all of q and half
    of k). Leaves the specs do not name replicate. The W8A8 copy
    (`blocks_q8`) is refused: the engine disables W8A8 under tensor
    parallelism, as the JAX engine does."""
    from ..models.xttsv2.gpt import ShardedParams

    if "blocks_q8" in params:
        raise ValueError("W8A8 weights (blocks_q8) are not sharded: tensor parallelism runs "
                         "the bf16/f32 block weights (decode_w8a8 and prefill_w8a8 off)")
    devices = mesh.model_devices()
    tp = len(devices)
    specs = gpt_param_specs()
    shards = []
    for r, dev in enumerate(devices):
        shard = {}
        for key, leaf in params.items():
            if key == "blocks":
                shard[key] = {
                    name: _model_slice(w, specs[key].get(name, P()), r, tp,
                                       fused=3 if name in ("attn_w", "attn_b") else 1)
                    .to(dev).contiguous()
                    for name, w in leaf.items()}
            else:
                shard[key] = leaf.to(dev)
        shards.append(shard)
    return ShardedParams(shards)


def shard_decode_state(state, mesh: Mesh):
    """The decode state on the mesh: the KV cache split on its lane axis per
    head (`ShardedKVCache`; under kv_int8 the int8 rows split the same way
    and every shard holds the per-token scales, which the specs replicate
    over the model axis). Every other field lives once, on the mesh's first
    device, where sampling and the vocoder read it: the single-controller
    form of the specs' replication. A mesh with data or dcn shards raises
    NotImplementedError."""
    import dataclasses

    from ..models.xttsv2.gpt import KVCache, ShardedKVCache

    devices = mesh.model_devices()
    tp = len(devices)
    spec = decode_state_specs()["cache"]
    cache = state.cache
    shards = []
    for r, dev in enumerate(devices):
        def put(name):
            t = getattr(cache, name)
            return None if t is None else _model_slice(t, spec[name], r, tp).to(dev).contiguous()

        shards.append(KVCache(put("k"), put("v"), put("k_scale"), put("v_scale")))
    first = mesh.first_device
    moved = {f.name: getattr(state, f.name).to(first) for f in dataclasses.fields(state)
             if f.name not in ("cache", "sampling", "generator")}
    sampling = type(state.sampling)(*(t.to(first) for t in state.sampling.tensors()))
    return dataclasses.replace(state, cache=ShardedKVCache(shards), sampling=sampling, **moved)


def replicate(tree, mesh: Mesh):
    """The tree's tensors on the mesh's first device, where one process
    reads them (the single-controller form of JAX's replication)."""
    first = mesh.first_device
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree.to(first) if torch.is_tensor(tree) else tree
