"""Guards for the torch port's package boundary.

1. The host modules the port carries as copies (the JAX package cannot be
   imported without JAX: its __init__ reaches ops/resample.py, which imports
   jax.numpy) must stay byte-identical to their auralis_tpu originals, apart
   from the listed lines.
2. Every module of the port is either such a copy or a listed port, so a new
   file has to be classified here.
3. In a subprocess whose import system refuses jax, jaxlib, tokenizers,
   safetensors, aiohttp and pydantic — a stand-in for a GPU machine without
   them — the port, its engine module and chip_smoke.py import, chip_smoke's
   stand-in tokenizer works, and no jax* module is loaded. The HTTP server's
   modules need aiohttp and pydantic, so that import skips them.
"""
import ast
import difflib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "auralis_tpu"
PORT = ROOT / "auralis_tpu_torch"

# copied file -> original line numbers (1-based) allowed to differ
OAI_SERVER_LINES = (
    {150}  # a docstring's TPU time to first audio
    | {446, 447, 448}  # the persistent XLA compile cache (not ported)
    | {465}  # start_tts_engine forwards --kv_int8 and --device
    | {469, 531}  # the parser moves into build_parser(), which chip_smoke boots from
    # help strings and log lines that state TPU compile behaviour or TPU
    # figures: --warmup, --no_precompile, --decode_slots ("per chip"),
    # --tensor_parallel_size, --data_parallel_replicas, --slot_bucketing
    # (then the new --kv_int8 and --device), --ref_length_quantum_s, the
    # warmup log and the no-warmup warning
    | {482, 483} | set(range(487, 492)) | {495, 496, 500, 504} | set(range(508, 512))
    | {528, 529} | set(range(539, 544)) | set(range(548, 552))
)
COPIES = {
    **{f"common/{m}.py": set() for m in (
        "__init__", "logger", "metrics", "scheduler", "requests", "output", "audio_io",
        "enhancer", "dsp_np", "native_audio", "ffmpeg_codec")},
    **{str(p.relative_to(JAX_PKG)): set() for p in sorted((JAX_PKG / "frontend").rglob("*.py"))},
    "core/__init__.py": set(),
    "core/tts.py": set(),
    "models/__init__.py": set(),
    "models/base.py": set(),
    "models/registry.py": set(),
    "models/xttsv2/config.py": set(),
    "server/__init__.py": set(),
    "server/openai_schemas.py": set(),
    "server/oai_server.py": OAI_SERVER_LINES,
    "entrypoints/__init__.py": set(),
    "entrypoints/convert_checkpoint.py": {4},  # the usage line names the port's module
    "entrypoints/oai_server.py": {1},  # the docstring names the port's module
    "entrypoints/llm_server.py": {7},  # the usage line names the port's module
}
# port modules with their own torch code (held against the JAX package by
# the other tests/test_torch_*.py files)
PORTED = {
    "__init__.py", "common/tracing.py", "ops/__init__.py", "ops/_build.py", "ops/interpolate.py",
    "ops/resample.py", "ops/mel.py", "ops/prefill_attention.py", "ops/mrf.py",
    "ops/experimental/__init__.py", "ops/experimental/attention.py", "ops/experimental/fused_mlp.py", "ops/quant.py",
    "models/xttsv2/__init__.py", "models/xttsv2/gpt.py",
    "models/xttsv2/modules.py", "models/xttsv2/hifigan.py", "models/xttsv2/weights.py",
    "models/xttsv2/engine.py", "runtime/__init__.py", "runtime/sampler.py",
    "runtime/decode_loop.py", "runtime/engine_core.py", "runtime/graphs.py",
    "parallel/__init__.py", "parallel/mesh.py", "parallel/replica.py",
}
# numpy functions the port's ops modules carry verbatim
COPIED_FUNCTIONS = {
    "ops/resample.py": ("_sinc_kernel", "resample_np"),
    "ops/mel.py": ("hz_to_mel", "mel_to_hz", "mel_filterbank", "hann_window", "hamming_window"),
    "models/xttsv2/weights.py": (
        "_fold_weight_norm", "_get_conv_w", "_fold_bn", "_conv1d_w", "_convT1d_w", "_conv2d_w",
        "load_safetensors", "find_artifact", "split_coqui_state", "infer_architecture",
        "convert_coqui_checkpoint"),
}


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_matches_original(rel):
    orig = (JAX_PKG / rel).read_text().splitlines(keepends=True)
    copy = (PORT / rel).read_text().splitlines(keepends=True)
    allowed = COPIES[rel]
    sm = difflib.SequenceMatcher(a=orig, b=copy, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        touched = set(range(i1 + 1, i2 + 1)) or {max(i1, 1)}  # an insert follows line i1
        assert touched & allowed == touched, (
            f"{rel}: original lines {i1 + 1}-{i2} differ from the copy ({tag}); "
            f"copy lines {j1 + 1}-{j2}:\n{''.join(copy[j1:j2])}"
        )


def _function_sources(path: Path) -> dict:
    src = path.read_text()
    return {n.name: ast.get_source_segment(src, n)
            for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("rel", sorted(COPIED_FUNCTIONS))
def test_copied_functions_match_original(rel):
    orig, port = _function_sources(JAX_PKG / rel), _function_sources(PORT / rel)
    for name in COPIED_FUNCTIONS[rel]:
        assert port[name] == orig[name], f"{rel}:{name} drifted from the JAX package"


def test_every_port_module_is_classified():
    found = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert found == set(COPIES) | PORTED, (
        f"unclassified: {sorted(found - set(COPIES) - PORTED)}; "
        f"missing: {sorted(set(COPIES) | PORTED - found)}")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_jax_import_in_port_sources(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "auralis_tpu"), (path, name)


BLOCKED = ("jax", "jaxlib", "tokenizers", "safetensors", "aiohttp", "pydantic")


def test_port_imports_without_jax_and_optional_packages():
    """Import the port with those packages made unimportable, in a fresh
    interpreter (this process already holds jax)."""
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        import auralis_tpu_torch
        import auralis_tpu_torch.models.xttsv2.engine
        import auralis_tpu_torch.parallel.mesh
        import auralis_tpu_torch.parallel.replica
        import chip_smoke
        # the tokenizer needs `tokenizers`; the HTTP server aiohttp and pydantic
        NEEDS_BLOCKED = ("auralis_tpu_torch.frontend.tokenizer", "auralis_tpu_torch.server.",
                         "auralis_tpu_torch.entrypoints.oai_server")
        for m in pkgutil.walk_packages(auralis_tpu_torch.__path__, "auralis_tpu_torch."):
            if not m.name.startswith(NEEDS_BLOCKED) or m.name == "auralis_tpu_torch.server":
                importlib.import_module(m.name)
        tok = chip_smoke.build_tokenizer(6681)  # the stand-in: `tokenizers` is blocked
        ids = tok.encode_with_split("Hello world. This is a test.", "en")
        assert ids and all(5 <= i < 6681 for chunk in ids for i in chunk), ids
        loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
        assert not loaded, loaded
        assert "auralis_tpu" not in sys.modules
        print("OK", len([n for n in sys.modules if n.startswith("auralis_tpu_torch")]))
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1].startswith("OK"), proc.stdout
