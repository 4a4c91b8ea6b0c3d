"""Checkpoint loading and conversion in the port, against the JAX package.

Seeded numpy weights on the tiny config (the port's `random_init`) become a
Coqui-style `.pth` through tests/helpers.py's `export_coqui_state`, which
both converters then turn into the dual-safetensors layout: the JAX
package's `convert_coqui_checkpoint` and the port's CLI
(`auralis_tpu_torch.entrypoints.convert_checkpoint`). The two outputs must
be the same files; the port's loaders must give the JAX loaders' f32 trees
and the source weights bit for bit; and a JAX engine and a port engine
loaded through `TTS.from_pretrained` from the same artifacts must answer a
greedy request with the same tokens and waveforms within PCM_TOL."""
import ast
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from helpers import build_tiny_tokenizer, export_coqui_state, sine_wav

import chip_smoke
from auralis_tpu import TTS as JaxTTS
from auralis_tpu import TTSRequest as JaxRequest
from auralis_tpu.models.xttsv2 import weights as jw
from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.entrypoints import convert_checkpoint as port_cli
from auralis_tpu_torch.models.xttsv2 import weights as tw
from auralis_tpu_torch.models.xttsv2.config import XTTSConfig, XTTSGPTConfig, tiny_test_config
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine

# both engines ship 16-bit PCM: latents agree to f32 noise, so a sample may
# land one or two PCM steps apart after rounding (tests/test_torch_slice.py)
PCM_TOL = 2.5 / 32767
ARTIFACTS = {"gpt": ("gpt", "gpt2_model.safetensors"),
             "core": ("core_xttsv2", "xtts-v2.safetensors")}
KERNEL_FLAGS = {"prefill_flash": True, "flash_decode": True}


def convert_tiny(tmp: Path, seed: int = 7) -> SimpleNamespace:
    """The tiny config's seeded numpy weights -> Coqui `.pth` -> both
    converters (`jax/`, `port/`), with a tokenizer saved into each GPT
    directory."""
    cfg = tiny_test_config()
    gpt_np, core_np = tw.random_init(cfg, seed=seed)
    state = export_coqui_state(gpt_np, core_np)
    pth = tmp / "model.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, pth)
    jax_gpt, jax_core = jw.convert_coqui_checkpoint(str(pth), str(tmp / "jax"))
    port_cli.main([str(pth), str(tmp / "port")])
    port_gpt, port_core = str(tmp / "port" / "gpt"), str(tmp / "port" / "core_xttsv2")
    tok = build_tiny_tokenizer()
    for d in (jax_gpt, port_gpt):
        tok.save(str(Path(d) / "tokenizer.json"))
    return SimpleNamespace(cfg=cfg, gpt_np=gpt_np, core_np=core_np, state=state, tmp=tmp,
                           jax_dirs={"gpt": jax_gpt, "core": jax_core},
                           port_dirs={"gpt": port_gpt, "core": port_core})


def with_gpt_flags(core_dir: str, dest: Path, flags: dict) -> str:
    """A sibling model root whose config.json sets `flags` in gpt_config,
    its safetensors linked, not copied."""
    dest.mkdir(parents=True, exist_ok=True)
    cfg = json.loads((Path(core_dir) / "config.json").read_text())
    cfg["gpt_config"].update(flags)
    (dest / "config.json").write_text(json.dumps(cfg, indent=2))
    (dest / "xtts-v2.safetensors").symlink_to(Path(core_dir) / "xtts-v2.safetensors")
    return str(dest)


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    return convert_tiny(tmp_path_factory.mktemp("ckpt"))


def assert_tree_equal(got, want, path=""):
    """Same structure, same keys, every leaf a numpy f32 array equal to
    `want`'s bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.float32, (path, type(got))
        w = np.asarray(want)
        assert got.shape == w.shape, (path, got.shape, w.shape)
        np.testing.assert_array_equal(got, w, err_msg=path)


def _config(dirs: dict, cls):
    """The core config from the core directory, the GPT one from the GPT's."""
    cfg = json.loads((Path(dirs["core" if cls is XTTSConfig else "gpt"]) / "config.json")
                     .read_text())
    return cls.from_dict(cfg)


def _states(dirs: dict) -> dict:
    return {k: tw.load_safetensors(tw.find_artifact(dirs[k], (ARTIFACTS[k][1],)))
            for k in ARTIFACTS}


# ---------------------------------------------------------------- converter
@pytest.mark.parametrize("which", sorted(ARTIFACTS))
def test_converters_write_the_same_safetensors(ck, which):
    sub, name = ARTIFACTS[which]
    a = ck.tmp / "jax" / sub / name
    b = ck.tmp / "port" / sub / name
    want, got = jw.load_safetensors(a), tw.load_safetensors(b)
    assert list(got) == list(want) and got
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert b.read_bytes() == a.read_bytes()


@pytest.mark.parametrize("which", sorted(ARTIFACTS))
def test_converters_write_the_same_config(ck, which):
    sub, _ = ARTIFACTS[which]
    want = json.loads((ck.tmp / "jax" / sub / "config.json").read_text())
    got = json.loads((ck.tmp / "port" / sub / "config.json").read_text())
    assert got == want


def test_split_matches_jax(ck):
    got_gpt, got_core = tw.split_coqui_state(ck.state)
    want_gpt, want_core = jw.split_coqui_state(ck.state)
    assert list(got_gpt) == list(want_gpt) and list(got_core) == list(want_core)
    assert not any(k.startswith("xtts.") or "dvae" in k for k in (*got_gpt, *got_core))


def test_infer_architecture_matches_config(ck):
    gpt_state, _ = tw.split_coqui_state(ck.state)
    arch = tw.infer_architecture(gpt_state)
    assert arch == jw.infer_architecture(gpt_state)
    g = ck.cfg.gpt
    for key in ("hidden_size", "num_hidden_layers", "num_audio_tokens", "start_audio_token",
                "stop_audio_token", "max_audio_tokens", "n_inner", "decoder_input_dim"):
        assert arch[key] == getattr(g, key), key
    # heads are read off the qkv width at XTTSv2's head size of 64; the tiny
    # config's 64 wide hidden state is one such head (it runs 4 of 16)
    assert arch["num_attention_heads"] == g.hidden_size // 64
    gcfg = _config(ck.port_dirs, XTTSGPTConfig)
    assert gcfg.hidden_size == g.hidden_size and gcfg.n_inner == g.n_inner


def test_find_artifact(tmp_path):
    nested = tmp_path / "a" / "b"
    nested.mkdir(parents=True)
    (nested / "x.safetensors").write_bytes(b"")
    assert tw.find_artifact(tmp_path, ("y.safetensors", "x.safetensors")) == \
        jw.find_artifact(tmp_path, ("y.safetensors", "x.safetensors")) == nested / "x.safetensors"
    with pytest.raises(FileNotFoundError, match="y.safetensors"):
        tw.find_artifact(tmp_path, ("y.safetensors",))


# ------------------------------------------------------------------ loaders
def _loaded(dirs: dict):
    return _states(dirs), _config(dirs, XTTSConfig), _config(dirs, XTTSGPTConfig)


def test_gpt_loader_matches_jax(ck):
    states, _, gpt_cfg = _loaded(ck.port_dirs)
    got = tw.load_gpt_params(states["gpt"], gpt_cfg)
    want = jax.device_get(jw.load_gpt_params(states["gpt"], gpt_cfg, dtype=jnp.float32))
    assert_tree_equal(got, want)


def test_core_loader_matches_jax(ck):
    states, core_cfg, _ = _loaded(ck.port_dirs)
    got = tw.load_core_params(states["core"], core_cfg)
    want = jax.device_get(jw.load_core_params(states["core"], core_cfg, dtype=jnp.float32))
    assert_tree_equal(got, want)


def test_loaders_return_the_source_weights(ck):
    states, core_cfg, gpt_cfg = _loaded(ck.port_dirs)
    gpt = tw.load_gpt_params(states["gpt"], gpt_cfg)
    core = tw.load_core_params(states["core"], core_cfg)
    assert_tree_equal(gpt, {k: v for k, v in ck.gpt_np.items()
                            if k not in ("text_wte", "text_wpe")})
    assert_tree_equal({k: core[k] for k in ck.core_np}, ck.core_np)
    # the text embeddings and the final norm travel through the core artifact
    for key in ("text_wte", "text_wpe", "final_norm_scale", "final_norm_bias"):
        np.testing.assert_array_equal(core[key], ck.gpt_np[key], err_msg=key)


def test_loader_folds_weight_norm_as_jax():
    """A weight-norm parametrised conv (as Coqui's HiFi-GAN stores it): the
    copied fold gives the JAX package's array and g * v / |v|."""
    rng = np.random.default_rng(4)
    state = {"c.parametrizations.weight.original0": rng.random((8, 1, 1), np.float32) + 0.5,
             "c.parametrizations.weight.original1": rng.standard_normal((8, 4, 3),
                                                                        dtype=np.float32)}
    got = tw._get_conv_w(state, "c")
    np.testing.assert_array_equal(got, jw._get_conv_w(state, "c"))
    v = state["c.parametrizations.weight.original1"].astype(np.float64)
    want = state["c.parametrizations.weight.original0"] * v / np.linalg.norm(
        v.reshape(8, -1), axis=1)[:, None, None]
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------------- engine
def test_from_pretrained_loads_the_converted_trees(ck):
    eng = XTTSv2Engine.from_pretrained(ck.port_dirs["core"], gpt_model=ck.port_dirs["gpt"],
                                       dtype=torch.float32, device="cpu", max_concurrency=1,
                                       vocoder_dtype=None, torch_dtype="ignored")
    states, core_cfg, gpt_cfg = _loaded(ck.port_dirs)
    want_gpt = tw.load_gpt_params(states["gpt"], gpt_cfg)
    want_core = tw.load_core_params(states["core"], core_cfg)
    want_gpt["text_wte"], want_gpt["text_wpe"] = want_core["text_wte"], want_core["text_wpe"]
    to_np = lambda tree: jax.tree.map(lambda t: t.numpy(), tree)
    assert_tree_equal(to_np(eng.params), want_gpt)
    assert_tree_equal(to_np(eng.core), want_core)
    assert eng.device.type == "cpu" and eng.tokenizer is not None
    assert eng.gpt_config.to_dict() == gpt_cfg.to_dict()


def test_from_pretrained_casts_the_gpt_only(ck):
    """The default dtype is bf16 for the GPT tree; the core stack stays f32
    (the engine casts the generator to its vocoder dtype itself)."""
    eng = XTTSv2Engine.from_pretrained(ck.port_dirs["core"], gpt_model=ck.port_dirs["gpt"],
                                       device="cpu", max_concurrency=1, vocoder_dtype=None)
    assert {t.dtype for t in jax.tree.leaves(eng.params)} == {torch.bfloat16}
    assert {t.dtype for t in jax.tree.leaves(eng.core)} == {torch.float32}
    assert eng.cache_dtype == torch.bfloat16
    np.testing.assert_array_equal(
        eng.params["wte"].float().numpy(),
        torch.from_numpy(ck.gpt_np["wte"]).to(torch.bfloat16).float().numpy())


def test_from_pretrained_tokenizer_search(ck, tmp_path):
    """The tokenizer comes from gpt_model, else from the root; with neither
    holding one, FileNotFoundError."""
    root = tmp_path / "root"
    shutil.copytree(ck.port_dirs["core"], root)
    gpt = tmp_path / "gpt"
    gpt.mkdir()
    (gpt / "gpt2_model.safetensors").symlink_to(
        Path(ck.port_dirs["gpt"]) / "gpt2_model.safetensors")
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        XTTSv2Engine.from_pretrained(str(root), gpt_model=str(gpt), device="cpu")
    shutil.copy(Path(ck.port_dirs["gpt"]) / "tokenizer.json", root / "tokenizer.json")
    eng = XTTSv2Engine.from_pretrained(str(root), gpt_model=str(gpt), device="cpu",
                                       max_concurrency=1)
    assert eng.tokenizer.vocab_size == build_tiny_tokenizer().vocab_size


def test_from_pretrained_defaults_to_the_card(ck):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError), match=r"(?i)cuda|nvidia"):
        XTTSv2Engine.from_pretrained(ck.port_dirs["core"], gpt_model=ck.port_dirs["gpt"])


# ----------------------------------------------------- the slice, end to end
def _greedy(cls, wav):
    return cls(text="Hello world. This is a test.", speaker_files=[wav], language="en",
               do_sample=False)


async def _tokens(engine, req):
    handles, *_ = await engine.get_generation_context(req)
    out = []
    for h in handles:
        tokens, _row, n = await (h[0] if isinstance(h, tuple) else h)
        out.append((np.asarray(tokens), n))
    return out


@pytest.fixture(scope="module")
def jax_answer(ck, tmp_path_factory):
    """The JAX engine's greedy tokens and waveform from the JAX converter's
    artifacts (its dense CPU path, f32 weights, KV cache and vocoder)."""
    wav = sine_wav(tmp_path_factory.mktemp("voice") / "speaker.wav")
    tts = JaxTTS(scheduler_max_concurrency=2).from_pretrained(
        ck.jax_dirs["core"], gpt_model=ck.jax_dirs["gpt"], dtype=jnp.float32,
        cache_dtype=jnp.float32, vocoder_dtype=None)
    try:
        tokens = tts.loop.run_until_complete(_tokens(tts.tts_engine, _greedy(JaxRequest, wav)))
        out = tts.generate_speech(_greedy(JaxRequest, wav))
    finally:
        tts.loop.run_until_complete(tts.shutdown())
    return wav, tokens, out


@pytest.mark.parametrize("flags", [{}, KERNEL_FLAGS], ids=["dense", "kernel_flags"])
def test_greedy_request_matches_jax(ck, jax_answer, flags, tmp_path):
    """The port's TTS.from_pretrained on the port converter's artifacts,
    once as converted and once with the kernel flags in gpt_config (the
    wrappers' plain versions on the CPU), against the JAX engine."""
    wav, want_tokens, want = jax_answer
    root = with_gpt_flags(ck.port_dirs["core"], tmp_path / "root", flags)
    tts = TTS(scheduler_max_concurrency=2).from_pretrained(
        root, gpt_model=ck.port_dirs["gpt"], dtype=torch.float32, device="cpu",
        cache_dtype=torch.float32, vocoder_dtype=torch.float32)
    try:
        assert all(getattr(tts.tts_engine.gpt_config, k) == v for k, v in flags.items())
        tokens = tts.loop.run_until_complete(_tokens(tts.tts_engine, _greedy(TTSRequest, wav)))
        got = tts.generate_speech(_greedy(TTSRequest, wav))
    finally:
        tts.loop.run_until_complete(tts.shutdown())
    assert len(tokens) == len(want_tokens)
    for (tb, nb), (ta, na) in zip(tokens, want_tokens):
        assert nb == na
        np.testing.assert_array_equal(tb, ta)
    assert got.sample_rate == want.sample_rate == 24000
    assert got.array.shape == want.array.shape and got.array.size > 0
    assert np.isfinite(got.array).all()
    np.testing.assert_allclose(got.array, want.array, rtol=0, atol=PCM_TOL)


# --------------------------------------------------------------- chip_smoke
def test_chip_smoke_exporter_is_the_test_helper():
    """chip_smoke cannot import tests/helpers.py (it imports the JAX
    package): its exporter is a copy, and gives the same state."""
    src = (Path(__file__).resolve().parent / "helpers.py").read_text()
    want_src = next(ast.get_source_segment(src, n) for n in ast.parse(src).body
                    if isinstance(n, ast.FunctionDef) and n.name == "export_coqui_state")
    smoke = Path(chip_smoke.__file__).read_text()
    got_src = next(ast.get_source_segment(smoke, n) for n in ast.parse(smoke).body
                   if isinstance(n, ast.FunctionDef) and n.name == "export_coqui_state")
    assert got_src == want_src
    gpt_np, core_np = tw.random_init(tiny_test_config(), seed=3)
    want = export_coqui_state(gpt_np, core_np)
    got = chip_smoke.export_coqui_state(gpt_np, core_np)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_chip_smoke_round_trip_check(ck):
    """chip_smoke phase 6's bit-equality check accepts the converted trees
    and refuses a tree with one entry changed."""
    states, core_cfg, gpt_cfg = _loaded(ck.port_dirs)
    gpt = tw.load_gpt_params(states["gpt"], gpt_cfg)
    core = tw.load_core_params(states["core"], core_cfg)
    n = chip_smoke.check_round_trip(gpt, core, ck.gpt_np, ck.core_np)
    assert n == len(jax.tree.leaves(gpt)) + len(jax.tree.leaves(ck.core_np)) + 4
    gpt["blocks"]["fc_w"] = gpt["blocks"]["fc_w"].copy()
    gpt["blocks"]["fc_w"][1, 2, 3] += 1e-7
    with pytest.raises(AssertionError, match="fc_w"):
        chip_smoke.check_round_trip(gpt, core, ck.gpt_np, ck.core_np)
