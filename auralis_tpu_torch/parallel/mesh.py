"""Device mesh and sharding rules over the data, dcn and model axes.

Counterpart of auralis_tpu/parallel/mesh.py. The axes keep their names and
meaning:
- "data": slot-parallel serving (the decode state's slot dimension split
  across data shards);
- "model": Megatron-style tensor parallelism over attention heads and MLP
  columns, a latency knob (tp in the reference, XTTSv2.py:57);
- "dcn": data parallelism across hosts; the slots split over ("dcn",
  "data"), dcn-major.

The JAX package places pytrees with NamedShardings and lets GSPMD emit the
collectives. Here one process drives the mesh as JAX's single controller
does. Each data shard (one (dcn, data) cell of the mesh) holds a
contiguous range of the slots, as `P(dp)` cuts the slot axis, and its own
model devices:
- `shard_gpt_params` gives each data shard its parameters: with model
  shards, each model shard's slice of the weights on its device
  (`ShardedParams`), else the whole dict on the shard's device; data shards
  on the same devices share one set;
- `shard_decode_state` gives each data shard its slots: their KV cache,
  split on the lane axis per head over its model shards (`ShardedKVCache`),
  and their per-slot fields on its first device. With more than one data
  shard the result is a `DataShardedState` (runtime/decode_loop.py), whose
  functions step every shard on its own devices and draw the sampling
  noise once for all slots, as JAX's replicated key does;
- the GPT's sharded forward (models/xttsv2/gpt.py) sums the row-parallel
  partials on every device of a data shard.
A mesh may repeat one device, which runs the sharded math on one card.

The specs are plain data (a tuple of axis names per leaf, the JAX
PartitionSpec's entries), so they compare with the JAX package's.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"  # inter-host data parallelism (multi-slice serving)


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

    @property
    def multi_device(self) -> bool:
        """Whether the mesh spans more than one distinct device."""
        return len(set(self.devices.flat)) > 1

    def shard_devices(self) -> list:
        """For each data shard, dcn-major then data (the order in which
        JAX's (DCN_AXIS, DATA_AXIS) flattens the slot axis), the devices of
        its model axis, model shard 0 first."""
        m = self.shape[MODEL_AXIS]
        flat = list(self.devices.flat)
        return [flat[i:i + m] for i in range(0, len(flat), m)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def default_devices() -> list:
    """Every visible GPU, in order. Raises RuntimeError when there is none:
    a caller that wants CPU shards names CPU devices."""
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("no CUDA device is visible: a mesh of CPU shards needs its "
                           "devices named (make_mesh(devices=[torch.device('cpu')] * n, ...))")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    devices: Optional[list] = None, data: int = 1, model: int = 1,
    dcn_data: int = 1,
) -> Mesh:
    """Device mesh of data x model devices, with a leading "dcn" axis when
    `dcn_data` > 1 (the JAX package's axes; one process drives it, so the
    hybrid placement of a multi-host JAX mesh is a plain reshape here).
    `devices` defaults to every visible GPU (RuntimeError without one) and
    may repeat a device."""
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


def _model_params(params: dict, devices: list):
    """One data shard's parameters: `ShardedParams` over its model devices
    (more than one), else the dict on its one device."""
    from ..models.xttsv2.gpt import ShardedParams

    def put(tree, dev):
        return {k: put(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    if len(devices) == 1:
        return put(params, devices[0])
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


def shard_gpt_params(params: dict, mesh: Mesh):
    """The GPT parameters placed on the mesh per `gpt_param_specs`. Each
    data shard gets, with model shards, a `ShardedParams` whose `shards[r]`
    is model shard r's parameter dict on its device, else the dict on its
    one device; data shards on the same devices share one set (no second
    copy). One data shard's set is returned as it is; several come as a
    `DataShardedParams`. The fused qkv weight and bias split per head, so
    model shard r holds [q_r | k_r | v_r] with q_r the columns of heads
    [r H/tp, (r+1) H/tp) (JAX's contiguous cut of the 3D axis is repaired
    by GSPMD's collectives; a literal copy would hand shard 0 all of q and
    half of k). Leaves the specs do not name replicate. The W8A8 copy
    (`blocks_q8`) is refused: the engine disables W8A8 under tensor
    parallelism, as the JAX engine does."""
    from ..runtime.decode_loop import DataShardedParams

    if "blocks_q8" in params:
        raise ValueError("W8A8 weights (blocks_q8) are not sharded: a mesh runs the bf16/f32 "
                         "block weights (decode_w8a8 and prefill_w8a8 off)")
    made: dict = {}
    per_shard = []
    for devices in mesh.shard_devices():
        key = tuple(devices)
        if key not in made:
            made[key] = _model_params(params, devices)
        per_shard.append(made[key])
    return per_shard[0] if len(per_shard) == 1 else DataShardedParams(per_shard)


def _copy(t: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous copy of t on dev that shares no memory with t."""
    return t.to(dev).clone(memory_format=torch.contiguous_format)


def shard_decode_state(state, mesh: Mesh):
    """The decode state on the mesh. The slots split into one contiguous
    equal range per data shard (dcn-major, then data: JAX's `P(dp)` cut of
    the slot axis); `num_slots` must divide by dcn x data (ValueError).
    Each data shard's KV cache is split on its lane axis per head over its
    model shards (`ShardedKVCache`; under kv_int8 the int8 rows split the
    same way and every model shard holds the per-token scales, which the
    specs replicate over the model axis), or lives whole on its one device.
    Its per-slot fields (sampling rows, counters, token and latent
    buffers) live on its first device, so a decode step moves none of them
    between data shards. One data shard's state is a `DecodeState`; several
    make a `DataShardedState` that keeps the state's one generator (JAX's
    replicated rng). The result shares no memory with `state`."""
    import dataclasses

    from ..models.xttsv2.gpt import KVCache, ShardedKVCache
    from ..runtime.decode_loop import DataShardedState

    groups = mesh.shard_devices()
    n_slots = state.seq_lens.shape[0]
    if n_slots % len(groups):
        raise ValueError(f"num_slots={n_slots} must divide by the mesh's {len(groups)} data "
                         f"shards (dcn x data)")
    per = n_slots // len(groups)
    spec = decode_state_specs()["cache"]
    shards = []
    for i, devices in enumerate(groups):
        lo, hi, tp = i * per, (i + 1) * per, len(devices)

        def put(name, r):
            t = getattr(state.cache, name)
            return None if t is None else _copy(_model_slice(t[:, lo:hi], spec[name], r, tp),
                                                devices[r])

        caches = [KVCache(*(put(name, r) for name in ("k", "v", "k_scale", "v_scale")))
                  for r in range(tp)]
        first = devices[0]
        moved = {f.name: _copy(getattr(state, f.name)[lo:hi], first)
                 for f in dataclasses.fields(state)
                 if f.name not in ("cache", "sampling", "generator")}
        sampling = type(state.sampling)(*(_copy(t[lo:hi], first)
                                          for t in state.sampling.tensors()))
        shards.append(dataclasses.replace(
            state, cache=caches[0] if tp == 1 else ShardedKVCache(caches), sampling=sampling,
            **moved))
    return shards[0] if len(shards) == 1 else DataShardedState(shards, state.generator)


def replicate(tree, mesh: Mesh):
    """The tree's tensors on the mesh's first device, where one process
    reads them (the single-controller form of JAX's replication)."""
    first = mesh.first_device
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree.to(first) if torch.is_tensor(tree) else tree
