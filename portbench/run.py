"""The benchmark of auralis_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (`portbench/configs/<name>.json`:
model sizes, kernel and engine flags, slots, block length) and a traffic mix
(`portbench/traffic/<name>.json`, read by `generator.py`); each metric is read
by `portbench/metrics/<name>.py`, and the limits of the correctness check are
`portbench/limits/<cell>.json`. So a configuration, a mix, a metric or a cell
is added by adding files and entries, and no file here changes.

One run, in one process on one GPU:
1. set-up: the weights drawn on the card from the seed (`weights.py`), the
   engine built through the port's own entry (`XTTSv2Engine(params=,
   core=)`) and wrapped in its `TTS` facade, every decode, insert and
   vocoder program captured (`precompile_decode_programs`,
   `precompile_vocoder_buckets`), each voice of the mix conditioned (so the
   cache holds it) and two short requests of the mix served;
2. the load: the mix's clients (closed loop) or arrivals (open loop) through
   `TTS.generate_speech_async`, ramped for `ramp_s` seconds, then measured
   for `--seconds`; an open loop's requests due in the window are followed
   to their end (at most `drain_s` seconds), the rest are cancelled;
3. with `--trace 1`, torch.profiler over the last `trace_s` seconds of the
   window (stopped once the load has drained), reduced in memory to the
   device's busy time, each kernel's time and the longest idle gaps;
4. the memory peak read, the program freed, then the correctness check
   (`check.py`) on a sample of the finished requests;
5. the metrics of the cell (end to end, or per layer with `--trace 1`).
Earlier lines (stderr) say how late an open loop ran, the CUDA-graph
captures made inside the window with their keys, the runner's counters and
each number compared beside its limit; the last line of stdout is one JSON
object with `correct`, `attempted`, `failed`, `metrics`, `device`
(`breakdown` when traced) and `check`.

It exits non-zero and prints no result without CUDA or with fewer GPUs than
the cell asks for, and when `jax`, `jaxlib`, `flax` or `auralis_tpu` (the
JAX package) is loaded once the window has closed. `--control 1` adds the
control's readings (the reference through fp8) to `check`: the tool that
set the limits; the benchmark's runs do not use it.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import contextvars  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import struct  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".portbench_cache" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: host thread pools that spin after CPU work
# would take cores from the event loop that drives the card
os.environ.setdefault("OMP_NUM_THREADS", "1")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, generator, readers, tokenizer, weights  # noqa: E402
from portbench.reference import frontend  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "auralis_tpu")
SAMPLE_RATE = 24000
# the requests' conditioning parameters (TTSRequest's defaults), which the
# reference repeats
COND = {"max_ref_length": 60, "gpt_cond_len": 30, "gpt_cond_chunk_len": 4}
WARM_CAP = 32  # tokens of each warm-up request
# the chunks of the request running in this context: the recorder appends
_CHUNKS = contextvars.ContextVar("portbench_chunks", default=None)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------ the files
def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration file, its mix)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = json.loads((root / "portbench" / "configs" / f"{cell['config']}.json").read_text())
    return bench, cell, config, generator.load_mix(root, cell["traffic"])


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports: per layer when traced, else end to end."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def write_wav_f32(path: str, wav: np.ndarray, rate: int) -> None:
    data = wav.astype("<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, rate, rate * 4, 4, 32))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def nvidia_smi(field: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unavailable"


# ------------------------------------------------------------ the engine
def build_engine(config: dict, mix: dict, params: dict, core: dict, tokenizer_json: str,
                 seed: int, device, **overrides):
    """The port's engine for the configuration file, through its loading
    entry, and its TTS facade; `overrides` replace engine arguments."""
    from tokenizers import Tokenizer

    from auralis_tpu_torch import TTS
    from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer
    from auralis_tpu_torch.models.xttsv2.config import XTTSConfig, XTTSGPTConfig
    from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine

    a, arch = config["model_args"], config["architecture"]
    gpt = XTTSGPTConfig(
        hidden_size=a["gpt_n_model_channels"], n_inner=arch["gpt_n_inner"],
        num_hidden_layers=a["gpt_layers"], num_attention_heads=a["gpt_n_heads"],
        vocab_size=a["gpt_number_text_tokens"], number_text_tokens=a["gpt_number_text_tokens"],
        start_text_token=a["gpt_start_text_token"], stop_text_token=a["gpt_stop_text_token"],
        num_audio_tokens=a["gpt_num_audio_tokens"], start_audio_token=a["gpt_start_audio_token"],
        stop_audio_token=a["gpt_stop_audio_token"], max_audio_tokens=a["gpt_max_audio_tokens"],
        gpt_max_audio_tokens=a["gpt_max_audio_tokens"], max_text_tokens=a["gpt_max_text_tokens"],
        max_prompt_tokens=a["gpt_max_prompt_tokens"], decoder_input_dim=a["decoder_input_dim"],
        num_cond_latents=arch["perceiver"]["num_latents"], **config["kernel_flags"])
    cfg = XTTSConfig(
        input_sample_rate=a["input_sample_rate"], output_sample_rate=a["output_sample_rate"],
        output_hop_length=a["output_hop_length"], decoder_input_dim=a["decoder_input_dim"],
        d_vector_dim=a["d_vector_dim"], gpt_code_stride_len=a["gpt_code_stride_len"],
        cond_d_vector_in_each_upsampling_layer=a["cond_d_vector_in_each_upsampling_layer"],
        duration_const=a["duration_const"], num_chars=a["num_chars"], gpt=gpt)
    kwargs = dict(max_concurrency=mix["max_concurrency"], decode_slots=config["decode_slots"],
                  steps_per_sync=config["steps_per_sync"], device=device,
                  cache_dtype=torch.bfloat16, seed=int(seed) % 2**63, **config["engine_flags"])
    engine = XTTSv2Engine(cfg, gpt, params=params, core=core,
                          tokenizer=TTSTokenizer(Tokenizer.from_str(tokenizer_json)),
                          **{**kwargs, **overrides})
    return engine, TTS(scheduler_max_concurrency=mix["max_concurrency"]).with_engine(engine)


def record_chunks(decode_engine) -> None:
    """Wrap the runner's `generate` so each chunk's prompt ids, submission
    and end times, tokens and latent count go to the request that made it
    (the context variable its client task set). The wrapper only copies the
    arrays; `chunk_lists` turns them into lists once the window has closed."""
    inner = decode_engine.generate

    async def generate(prompt, options=None, stream_queue=None, on_young_block=None):
        entry = {"ids": np.array(prompt.ids), "t_submit": time.perf_counter(),
                 "t_done": None, "n": 0, "tokens": None}
        chunks = _CHUNKS.get()
        if chunks is not None:
            chunks.append(entry)
        tokens, row, n = await inner(prompt, options, stream_queue, on_young_block)
        entry.update(t_done=time.perf_counter(), n=int(n), tokens=np.array(tokens))
        return tokens, row, n

    decode_engine.generate = generate


def chunk_lists(records: list) -> None:
    """The recorded chunks' prompt ids and tokens as lists of ints."""
    for r in records:
        for c in r["chunks"]:
            c["ids"] = [int(i) for i in c["ids"]]
            c["tokens"] = ([] if c["tokens"] is None
                           else [int(t) for t in c["tokens"].reshape(-1)])


# ------------------------------------------------------------ the load
class Load:
    """The run's requests in flight and their records."""

    def __init__(self, tts, mix: dict, voice_paths: list):
        self.tts, self.mix, self.voice_paths = tts, mix, voice_paths
        self.records: list = []

    def request(self, req, cap=None):
        from auralis_tpu_torch import TTSRequest

        return TTSRequest(text=req.text, speaker_files=[self.voice_paths[req.voice]],
                          language="en", stream=req.stream,
                          max_new_tokens=cap or req.cap, do_sample=not req.greedy,
                          **self.mix["sampling"], **COND)

    async def one(self, req, due=None, keep=True, cap=None) -> dict:
        """Serve one request; its record: times, audio, chunks, failure."""
        rec = {"idx": req.idx, "due": due, "sent": time.perf_counter(), "first": None,
               "done": None, "ended": None, "audio": None, "failed": False, "error": None,
               "stream": req.stream, "greedy": req.greedy, "voice": req.voice,
               "text": req.text, "chunks": [], "outputs": [],
               "repetition_penalty": self.mix["sampling"]["repetition_penalty"]}
        if keep:
            self.records.append(rec)
        _CHUNKS.set(rec["chunks"])
        parts = []
        try:
            if req.stream:
                agen = await self.tts.generate_speech_async(self.request(req, cap))
                try:
                    async for out in agen:
                        parts.append(np.asarray(out.array, np.float32))
                        rec["outputs"].append((time.perf_counter(), parts[-1].shape[0]))
                finally:
                    await agen.aclose()
            else:
                out = await self.tts.generate_speech_async(self.request(req, cap))
                parts.append(np.asarray(out.array, np.float32))
                rec["outputs"].append((time.perf_counter(), parts[-1].shape[0]))
            rec["first"] = rec["outputs"][0][0] if rec["outputs"] else None
            rec["done"] = time.perf_counter()
            rec["audio"] = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        except Exception as e:  # the request failed: it counts in `failed`
            rec["failed"], rec["error"] = True, repr(e)
            log(f"request {req.idx} failed: {e!r}")
        rec["ended"] = time.perf_counter()
        return rec


async def closed_loop(load: Load, reqs: list, clients: int, stagger_s: float, w1: float,
                      drain_s: float) -> None:
    """`clients` clients, client c starting c / clients of `stagger_s` after
    the first, each sending its next request as the last one returns, until
    the window ends; the requests then in flight are followed to their end
    (at most `drain_s` seconds), the rest cancelled."""
    async def client(c):
        await asyncio.sleep(stagger_s * c / clients)
        for req in reqs[c::clients]:
            if time.perf_counter() >= w1:
                return
            await load.one(req)

    tasks = [asyncio.ensure_future(client(c)) for c in range(clients)]
    await asyncio.wait(tasks, timeout=max(0.0, w1 + drain_s - time.perf_counter()))
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


async def open_loop(load: Load, reqs: list, t0: float, w0: float, w1: float,
                    drain_s: float) -> dict:
    """Requests sent at t0 + their due offsets. Sending goes on until the
    requests due in the window have all ended, or `drain_s` after the
    window; then the rest are cancelled. Returns how late the sender ran."""
    window_tasks, others, late = [], [], []
    deadline = w1 + drain_s
    for req in reqs:
        due = t0 + req.due
        now = time.perf_counter()
        if due >= w1 and all(t.done() for t in window_tasks):
            break
        if now >= deadline:
            break
        if due > now:
            await asyncio.sleep(due - now)
        late.append(time.perf_counter() - due)
        task = asyncio.ensure_future(load.one(req, due=due))
        (window_tasks if w0 <= due < w1 else others).append(task)
    pending = [t for t in window_tasks if not t.done()]
    if pending:
        await asyncio.wait(pending, timeout=max(0.0, deadline - time.perf_counter()))
    for t in window_tasks + others:
        t.cancel()
    await asyncio.gather(*window_tasks, *others, return_exceptions=True)
    late.sort()
    return {"sent": len(late), "late_p50_ms": late[len(late) // 2] * 1e3 if late else None,
            "late_max_ms": late[-1] * 1e3 if late else None}


# ------------------------------------------------------------ the trace
class Trace:
    """torch.profiler over a sub-window, reduced in memory: the union of the
    device operations' intervals (busy), each kernel's time, the longest
    idle gaps labelled with the host operation under their middle, and the
    device operations that took most time. No trace file is written.

    The sub-window ends at `mark_end` (the window's end); the profiler is
    stopped later, in `stop`, once the load has drained and no thread
    launches work: stopping it while a worker thread replayed a CUDA graph
    hung the run. It starts at the first device operation recorded: the
    kernels of a graph launched before the profiler started are not
    traced, so the time before that would read as idle."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.host_start = self.host_end = None

    def _profiler(self):
        # on the card the device activity alone: it brings the host's CUDA
        # calls that label the idle gaps, and recording every host operation
        # of every thread as well once hung a run's event loop
        act = torch.profiler.ProfilerActivity
        return torch.profiler.profile(
            activities=[act.CUDA] if self.device.type == "cuda" else [act.CPU])

    def warm(self):
        """Start and stop the profiler once in set-up: its first start loads
        and initialises the tracer, seconds in which it holds the event
        loop."""
        t0 = time.perf_counter()
        with self._profiler():
            torch.ones(8, device=self.device).sum().item()
        log(f"[trace] the profiler's first start and stop took {time.perf_counter() - t0:.3f} s")

    def start(self):
        self.prof = self._profiler()
        self.host_start = time.perf_counter()
        self.prof.start()
        log(f"[trace] start took {time.perf_counter() - self.host_start:.3f} s")

    def mark_end(self):
        self.host_end = time.perf_counter()

    def stop(self):
        t0 = time.perf_counter()
        self.prof.stop()
        log(f"[trace] stop, {t0 - self.host_end:.3f} s after the sub-window's end, "
            f"took {time.perf_counter() - t0:.3f} s")

    def reduce(self) -> dict:
        from torch.autograd import DeviceType

        # the profiler's own records, without the per-event objects and the
        # tree that `events()` builds (minutes for a long sub-window); times
        # are from the trace's start, which the host clock read just before
        res = self.prof.profiler.kineto_results
        base = res.trace_start_ns()
        hi = (self.host_end - self.host_start) * 1e6
        dev, host = [], []
        for e in res.events():
            s = (e.start_ns() - base) * 1e-3
            t = s + e.duration_ns() * 1e-3
            if t <= 0 or s >= hi:
                continue
            (dev if e.device_type() == DeviceType.CUDA else host).append((s, min(t, hi), e.name()))
        lo = max(0.0, min((s for s, _, _ in dev), default=0.0))
        kernels: dict = {}
        for s, t, name in dev:
            kernels[name] = kernels.get(name, 0.0) + (t - max(s, lo)) * 1e-6
        busy, gaps, cur_s, cur_t, spans = 0.0, [], None, lo, []
        for s, t, _ in sorted(dev):
            s = max(s, lo)
            if cur_s is None or s > cur_t:
                if cur_s is not None:
                    busy += cur_t - cur_s
                    spans.append((cur_s, cur_t))
                gaps.append((s - (cur_t if cur_s is not None else lo), cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        if cur_s is not None:
            busy += cur_t - cur_s
            spans.append((cur_s, cur_t))
        gaps.append((hi - (cur_t if cur_s is not None else lo), cur_t, hi))
        gaps = sorted(g for g in gaps if g[0] > 0)[::-1][:10]
        idle = []
        for length, s, t in gaps:
            mid = (s + t) / 2
            under = [(h_t - h_s, name) for h_s, h_t, name in host if h_s <= mid < h_t]
            idle.append([f"host: {min(under)[1]}" if under else "host: no traced operation",
                         length * 1e-6])
        window_s = (hi - lo) * 1e-6
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
        # the device's busy intervals on the host clock, [n, 2] seconds
        busy_spans = self.host_start + np.asarray(spans, np.float64).reshape(-1, 2) * 1e-6
        return {"host_start": self.host_start + lo * 1e-6, "host_end": self.host_end,
                "window_s": window_s, "busy_s": busy * 1e-6, "busy_spans": busy_spans,
                "kernels": kernels,
                "breakdown": {"device_ops": [[k, v] for k, v in top], "idle_gaps": idle}}


# ------------------------------------------------------------ one run
def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> dict:
    """One run of a cell on `device`; the result line's object."""
    from auralis_tpu_torch.runtime import graphs

    device = torch.device(device)
    bench, cell, config, mix = load_cell(root, workload)
    metrics = cell_metrics(bench, workload, trace)
    tok_json = tokenizer.train(root)
    duration = mix["ramp_s"] + seconds + mix["drain_s"]
    reqs = generator.requests(root, mix, seed, duration)
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    voice_paths = []
    for i in range(mix["voices"]):
        path = os.path.join(tmp.name, f"voice{i}.wav")
        write_wav_f32(path, generator.voice(mix, seed, i), 22050)
        voice_paths.append(path)

    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    params, core = weights.make_weights(config, seed, device)
    engine, tts = build_engine(config, mix, params, core, tok_json, seed, device)
    del params, core
    de = engine.decode_engine
    record_chunks(de)
    load = Load(tts, mix, voice_paths)
    loop = tts.loop

    # warm-up: every program captured, every voice conditioned, two requests
    engine.precompile_decode_programs()
    engine.precompile_vocoder_buckets()

    async def warm():
        for path in voice_paths:
            await engine.get_audio_conditioning([path], COND["max_ref_length"],
                                                COND["gpt_cond_len"], COND["gpt_cond_chunk_len"],
                                                sound_norm_refs=False, load_sr=22050)
        await asyncio.gather(*(load.one(r, keep=False, cap=WARM_CAP) for r in reqs[-2:]))

    loop.run_until_complete(warm())
    tracer = Trace(device) if trace else None
    if tracer:
        tracer.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    setup_s = t0 - T_PROCESS
    w0, w1 = t0 + mix["ramp_s"], t0 + mix["ramp_s"] + seconds
    snaps = {}

    def snapshot(tag):
        from auralis_tpu_torch.common.tracing import profile_summary

        snaps[tag] = {"spans": profile_summary(), "stats": dict(de.stats),
                      "in_flight": sum(1 for r in load.records if r["ended"] is None),
                      "captures": len(graphs.captured_keys), "t": time.perf_counter()}

    samples = []

    async def sample_runner():
        """Every 50 ms from the ramp's start to just past the window's end:
        (time, the runner's step count, its owned slots)."""
        while True:
            now = time.perf_counter()
            samples.append((now, de._steps_total, de.num_active))
            if now >= w1:
                return
            await asyncio.sleep(0.05)

    async def watch():
        sampler = asyncio.ensure_future(sample_runner())
        await asyncio.sleep(max(0.0, w0 - time.perf_counter()))
        snapshot("start")
        if tracer:
            # the last trace_s of the window; the profiler is stopped after
            # the drain (`Trace`)
            await asyncio.sleep(max(0.0, w1 - min(mix["trace_s"], seconds) - time.perf_counter()))
            tracer.start()
        await asyncio.sleep(max(0.0, w1 - time.perf_counter()))
        snapshot("end")
        if tracer:
            tracer.mark_end()
        await sampler

    async def drive():
        watcher = asyncio.ensure_future(watch())
        if mix["loop"] == "closed":
            await closed_loop(load, reqs, mix["clients"], mix["stagger_s"], w1, mix["drain_s"])
            lateness = None
        else:
            lateness = await open_loop(load, reqs, t0, w0, w1, mix["drain_s"])
        await watcher
        return lateness

    lateness = loop.run_until_complete(drive())
    drain_end = time.perf_counter()
    if tracer:
        async def quiet(limit_s=10.0):
            """Until no slot decodes (at most `limit_s`)."""
            t_end = time.perf_counter() + limit_s
            while de.num_active and time.perf_counter() < t_end:
                await asyncio.sleep(0.05)

        loop.run_until_complete(quiet())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tracer.stop()
    if lateness:
        log(f"[load] open loop sent {lateness['sent']} requests; lateness p50 "
            f"{lateness['late_p50_ms']:.3f} ms, max {lateness['late_max_ms']:.3f} ms")
    new_keys = graphs.captured_keys[snaps["start"]["captures"]:snaps["end"]["captures"]]
    log(f"[captures] {len(new_keys)} CUDA-graph captures inside the window: "
        f"{[str(k) for k in new_keys]}")
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    st0, st1 = snaps["start"], snaps["end"]
    spans = {}
    for name, s1 in st1["spans"].items():
        s0 = st0["spans"].get(name, {"count": 0, "total_s": 0.0})
        spans[name] = {"count": s1["count"] - s0["count"],
                       "total_s": s1["total_s"] - s0["total_s"]}
    runner = {k: st1["stats"][k] - st0["stats"][k] for k in ("blocks", "occupancy_sum")}
    occupied = [a for t, _, a in samples if w0 <= t < w1]
    runner.update(steps=readers.steps_at(samples, w1) - readers.steps_at(samples, w0),
                  num_slots=de.num_slots, samples=samples,
                  occupied_mean=sum(occupied) / len(occupied) if occupied else None)
    runner_log = {k: v for k, v in runner.items() if k != "samples"}
    log(f"[runner] over the window: {runner_log}; stats {st1['stats']}")
    due = [r for r in load.records if r["due"] is not None and w0 <= r["due"] < w1]
    if due:
        ttfa = sorted((r["first"] or drain_end) - r["due"] for r in due)
        log(f"[load] {len(due)} requests due in the window; time to first audio p50 "
            f"{ttfa[len(ttfa) // 2] * 1e3:.1f} ms")
    log(f"[load] requests in flight at the window's start {st0['in_flight']}, at its end "
        f"{st1['in_flight']}")

    # the program is freed before the reference runs
    loop.run_until_complete(tts.shutdown())
    leftover = asyncio.all_tasks(loop)
    for t in leftover:
        t.cancel()
    loop.run_until_complete(asyncio.gather(*leftover, return_exceptions=True))
    loop.run_until_complete(loop.shutdown_default_executor())
    loop.close()
    del engine, tts, de, load.tts
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    tr = tracer.reduce() if tracer else None
    tracer = None
    chunk_lists(load.records)
    num_latents = config["architecture"]["perceiver"]["num_latents"]
    tok = frontend.encoder(tok_json)
    for r in load.records:
        ids = [frontend.prompt_ids(tok, c) for c in frontend.chunks(r["text"])]
        for c, own in zip(r["chunks"], ids + [None] * len(r["chunks"])):
            c["prompt_len"] = num_latents + len(own or c["ids"]) + 1
        r["audio_s"] = 0.0 if r["audio"] is None else r["audio"].shape[0] / SAMPLE_RATE

    window = {"start": w0, "end": w1, "seconds": w1 - w0}
    def counted(r):
        """Due in the window (open loop), or ended in it (closed loop)."""
        t = r["due"] if r["due"] is not None else r["ended"]
        return t is not None and w0 <= t < w1

    in_window = [r for r in load.records if counted(r)]
    failed = sum(1 for r in in_window if r["failed"] or r["done"] is None)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak),
                "power_limit": nvidia_smi("power.limit") if device.type == "cuda" else None}
    if tr:
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    rec = {"window": window, "setup_s": setup_s, "drain_end": drain_end,
           "requests": load.records, "spans": spans, "runner": runner, "trace": tr,
           "config": config, "device": dev_info}
    values = {}
    for m in metrics:
        v = reader(root, m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_check = time.perf_counter()
    chosen = check.choose(load.records, mix, seed)
    readings = check.judge(root, config, mix, seed, chosen, tok_json, voice_paths, device,
                           control=control)
    tmp.cleanup()
    correct, shown = check.verdict(readings, check.load_limits(root, workload), failed)
    log(f"[check] {len(chosen)} requests, {readings['tokens']} served tokens judged in "
        f"{time.perf_counter() - t_check:.1f} s")
    if control:
        shown.update({k: {"value": v, "limit": None} for k, v in readings.items()
                      if k.startswith("control_")})
    result = {"correct": correct, "attempted": len(in_window), "failed": failed,
              "metrics": values, "device": dev_info}
    if tr:
        result["breakdown"] = tr["breakdown"]
    result["check"] = shown
    for name, v in shown.items():
        log(f"check {name} {v['value']} limit {v['limit']}")
    return result


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run past 330 s prints every thread's stack and exits non-zero
    faulthandler.dump_traceback_later(330, exit=True)
    _, cell, _, _ = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        log("portbench: no CUDA device is visible; the benchmark runs only on a GPU")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"portbench: the cell asks for {cell['chips']} GPUs, "
            f"{torch.cuda.device_count()} are visible")
        return 2
    log(f"[device] {torch.cuda.get_device_name(0)}; {nvidia_smi('name,power.limit')}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), control=bool(args.control))
    found = banned_modules()
    if found:
        log(f"portbench: modules of JAX or the JAX package are loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
