"""The harness against the benchmark's contract, on the CPU: a dry run of
each fixture cell (the port's plain kernel versions on CPU tensors) gives
the result line's keys and the cell's metrics; the fixture's cells,
mixes, limits and metric are found by name with no file of the benchmark
edited; BENCHMARK.json's entries are consistent; nothing loaded is JAX or
the JAX package; without a GPU the command prints no result."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from conftest import REPO
from portbench import run

SEED = 2**31 + 3
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell,trace", [("tiny-ebook", 0), ("tiny-chat", 1)])
def test_dry_run_gives_the_result_line(bench_root, cell, trace):
    res = run.run_cell(bench_root, cell, SEED, 6.0, bool(trace), "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["check"]
    assert json.loads(json.dumps(res)) == res
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in run.cell_metrics(bench, cell, bool(trace))}
    assert set(res["metrics"]) <= want
    if trace:
        # the fixture's own metric, found by name in a file the benchmark lacks
        assert res["metrics"]["requests_done.fixture"]["value"] > 0
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    else:
        assert {"setup_s", "audio_s_per_s"} <= set(res["metrics"])
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in res["check"].values())


def test_nothing_of_jax_is_loaded(bench_root):
    code = ("import sys; sys.path.insert(0, %r); from pathlib import Path\n"
            "from portbench import run\n"
            "run.run_cell(Path(%r), 'tiny-chat', 7, 2.0, False, 'cpu')\n"
            "print(run.banned_modules(), 'auralis_tpu_torch' in sys.modules)"
            % (str(REPO), str(bench_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_without_a_gpu_the_command_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:  # a directory with only BENCHMARK.json and the benchmark
            import shutil

            shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
            shutil.copytree(REPO / "portbench", tmp_path / "portbench")
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "flash-single",
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""


def test_benchmark_entries_are_consistent():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    pb = REPO / "portbench"
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for name, w in cells.items():
        assert NAME.match(name) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (pb / "traffic" / f"{w['traffic']}.json").is_file()
        assert (pb / "limits" / f"{name}.json").is_file()
    reports = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and (pb / "metrics" / f"{m['name']}.py").is_file()
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        # a per-layer metric's cells all report the end-to-end metric it moves
        assert m["moves"] in e2e and set(m["workloads"]) <= reports[m["moves"]], m["name"]
    for name in cells:
        got = [m for m in bench["end_to_end"] if name in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert any(name in m["workloads"] for m in bench["per_layer"])
