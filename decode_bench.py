"""The decode kernels K2, K4 and K5 at chip_smoke phase 3's shapes, timed
cold and hot, for one tree or for two trees in turns.

    python3 decode_bench.py OTHER_TREE [--out chiprun_out/decode_ab.json]

Times K2 (`flash_decode_append_attention`) and K4 (`ragged_decode_attention`)
of OTHER_TREE's `auralis_tpu_torch` (for example a `git archive` of an
earlier commit, unpacked) and of this tree's, at every write-position set
of WRITE_POS_SETS, and K5 (`fused_mlp_w8`) at S = 8, D = 1024, I = 4096,
tile_i 1024, in four processes in the order other, this, this, other, on
one card. Each process imports only its own tree's package and builds its
kernels; the timing is this file's. K5 gets its weights in the layout its
tree's wrapper takes: the module's WEIGHT_LAYOUT, and row-major (contiguous)
copies for a tree whose module has none (before K5 read the serving
layout). Prints one line per (shape, kernel) and writes every number to
--out. Needs a CUDA device.

Timing (`time_ms`): repeated calls captured in one CUDA graph, the graph
replayed 5 times and timed with CUDA events, the median replay over the
calls. "cold": call i reads layer i % 30 (of a [30, 8, 1280, 1024] cache,
or of 30 layers' MLP weights, 240 MB), so each call finds its slab outside
the 50 MB L2, as a decode step does (it reads each of the 30 layers once).
"hot": every call reads layer 17, whose rows or weights then stay in L2.

chip_smoke.py imports `time_ms`, the shapes and the input builders.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys

LAYERS, SLOTS, T_MAX, HEADS, HEAD_DIM, HOT_LAYER = 30, 8, 1280, 16, 64, 17
INNER = 4 * HEADS * HEAD_DIM  # K5's I: the GPT MLP's inner width
COLD_CALLS, HOT_CALLS = 2 * LAYERS, 50
# write_pos per slot: the ragged mix across the 256-row chunk edges; the
# 128-row split edges and the cache's last row; every split but the first
# empty; young decode (one split each); every slot long
WRITE_POS_SETS = {
    "ragged": [0, 7, 255, 256, 511, 600, 1000, 1046],
    "split edges": [127, 128, 129, 1279, 255, 256, 257, 640],
    "all 0": [0] * SLOTS,
    "all 127": [127] * SLOTS,
    "all 1046": [1046] * SLOTS,
}


def time_ms(fn, calls: int) -> float:
    """Device time per call of fn(), without the host's launch overhead:
    `calls` calls are captured in one CUDA graph, the graph is replayed 5
    times, each replay timed with CUDA events; the median replay / calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up library handles before capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def cold_hot_ms(call) -> tuple[float, float]:
    """(cold, hot) ms per call of call(layer): cold rotates the layer over
    all LAYERS (a slab outside L2 each call), hot stays on HOT_LAYER."""
    rot = itertools.count()
    cold = time_ms(lambda: call(next(rot) % LAYERS), COLD_CALLS)
    return cold, time_ms(lambda: call(HOT_LAYER), HOT_CALLS)


def k2_inputs(dev, seed: int = 2, slots: int = SLOTS):
    """q [slots, 16, 64], k_new/v_new [slots, 1024] and K/V caches [30,
    slots, 1280, 1024], bf16 standard normal (slots 8 by default)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (LAYERS, slots, T_MAX, HEADS * HEAD_DIM)
    kc = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((slots, HEADS, HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((slots, HEADS * HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((slots, HEADS * HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    return q, kn, vn, kc, vc


def k4_inputs(dev, seed: int = 4, slots: int = SLOTS):
    """q [slots, 16, 64] and k_new/v_new [slots, 1024] bf16; int8 K/V caches
    [30, slots, 1280, 1024] and f32 scale rows [30, slots, 1280] at the size
    randn rows of 1024 lanes give (max|x| / 127); slots 8 by default."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (LAYERS, slots, T_MAX, HEADS * HEAD_DIM)
    kc, vc = (torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (0.02 + 0.01 * torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2))
    q = torch.randn((slots, HEADS, HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((slots, HEADS * HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((slots, HEADS * HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    return q, kn, vn, (kc, vc, ks, vs)


def k5_inputs(dev, seed: int = 5):
    """x [8, 1024] bf16 standard normal; fc_wq [30, 1024, 4096] and proj_wq
    [30, 4096, 1024] int8 in the serving layout (each matrix column-major,
    as quantize_decode_weights stores it) with their per-output-channel f32
    scales [30, 4096] / [30, 1024], quantised from 0.02 x standard normal
    weights by that function's recipe; f32 biases 0.01 x standard normal."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    d, i = HEADS * HEAD_DIM, INNER

    def q8(din: int, dout: int):
        wq = torch.empty((LAYERS, dout, din), dtype=torch.int8, device=dev)
        ws = torch.empty((LAYERS, dout), device=dev)
        for layer in range(LAYERS):  # one f32 layer at a time
            w = 0.02 * torch.randn((dout, din), generator=gen, device=dev)
            ws[layer] = torch.clamp(w.abs().amax(dim=1), min=1e-8) * (1.0 / 127.0)
            wq[layer] = torch.round(w / ws[layer][:, None]).to(torch.int8)
        return wq.transpose(-1, -2), ws

    fc_wq, fc_ws = q8(d, i)
    proj_wq, proj_ws = q8(i, d)
    fc_b = 0.01 * torch.randn((LAYERS, i), generator=gen, device=dev)
    proj_b = 0.01 * torch.randn((LAYERS, d), generator=gen, device=dev)
    x = torch.randn((SLOTS, d), generator=gen, device=dev).to(torch.bfloat16)
    return x, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b


def worker(tree: str) -> dict:
    """Cold and hot ms of TREE's K2 and K4 at every write-position set, and
    of its K5."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from auralis_tpu_torch.ops.experimental import attention

    dev = torch.device("cuda", 0)
    out = {"tree": os.path.abspath(tree), "module": attention.__file__, "ms": {}}
    q, kn, vn, kc, vc = k2_inputs(dev)
    for name, wp_list in WRITE_POS_SETS.items():
        wp = torch.tensor(wp_list, dtype=torch.int32, device=dev)
        out["ms"][f"K2 {name}"] = cold_hot_ms(
            lambda layer: attention.flash_decode_append_attention(q, kn, vn, kc, vc, layer, wp))
    del kc, vc
    q, kn, vn, caches = k4_inputs(dev)
    for name, wp_list in WRITE_POS_SETS.items():
        wp = torch.tensor(wp_list, dtype=torch.int32, device=dev)
        out["ms"][f"K4 {name}"] = cold_hot_ms(
            lambda layer: attention.ragged_decode_attention(q, kn, vn, 0.125, layer, wp, *caches))
    del caches
    from auralis_tpu_torch.ops.experimental import fused_mlp

    x, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b = k5_inputs(dev)
    out["k5_layout"] = getattr(fused_mlp, "WEIGHT_LAYOUT", "row-major")
    if out["k5_layout"] == "row-major":
        fc_wq, proj_wq = fc_wq.contiguous(), proj_wq.contiguous()
    out["ms"]["K5 S=8 tile_i=1024"] = cold_hot_ms(lambda layer: fused_mlp.fused_mlp_w8(
        x, fc_wq[layer], fc_ws[layer], fc_b[layer], proj_wq[layer], proj_ws[layer],
        proj_b[layer]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="root of the other tree")
    ap.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="write the JSON results here")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if not args.other:
        ap.error("name the other tree")
    import torch

    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, tree in (("other", args.other), ("this", here), ("this", here),
                        ("other", args.other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"  {label} run {len(runs)}: {runs[-1][1]['module']} (K5 weights "
              f"{runs[-1][1]['k5_layout']})", flush=True)
    rows = {}
    for key in runs[0][1]["ms"]:
        by = {lab: [r["ms"][key] for lab2, r in runs if lab2 == lab] for lab in ("other", "this")}
        cold = {lab: statistics.median(c for c, _ in v) for lab, v in by.items()}
        hot = {lab: statistics.median(h for _, h in v) for lab, v in by.items()}
        rows[key] = {"runs": by, "cold_ms": cold, "hot_ms": hot}
        print(f"  {key}: cold other {cold['other']:.4f} / this {cold['this']:.4f} ms "
              f"({cold['other'] / cold['this']:.2f}x); hot other {hot['other']:.4f} / this "
              f"{hot['this']:.4f} ms; runs (cold, hot) {by}", flush=True)
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                       "order": [lab for lab, _ in runs], "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
