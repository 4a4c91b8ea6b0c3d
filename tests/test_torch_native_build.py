"""The native host-audio library (native/libauralis_native.so) through the
port's copy of `common/native_audio.py`, against the JAX package's.

The library is gitignored, so a fresh checkout builds it with `make -C
native` on first use. Under pytest-xdist every worker imports every test
module while collecting, and tests/unit/test_native_audio.py asks for the
library at import: workers that race one another's `make` can find a
half-written file, latch "unavailable" and skip that whole module. This
module sorts before tests/unit/ in collection, so each worker imports it
first: it builds (or loads) the library here, under an exclusive lock on
native/Makefile, and every later import finds a whole file."""
import fcntl

import numpy as np
import pytest

from auralis_tpu_torch.common import native_audio


def _build_under_lock():
    makefile = native_audio._NATIVE_DIR / "Makefile"
    if not makefile.exists():
        return
    with open(makefile, "rb") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            native_audio.get_lib()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_build_under_lock()


def test_library_is_built_and_loads():
    assert native_audio._LIB_PATH.exists()
    assert native_audio.available()


def _tone(n=24000, sr=24000, f=440.0):
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32)


@pytest.mark.parametrize("bits", [16, 24])
def test_flac_matches_the_jax_package(bits):
    """The port's copy and the JAX package's binding give the same stream,
    and the stream decodes back to the samples within one step."""
    from auralis_tpu.common import native_audio as jax_native

    x = _tone()
    got = native_audio.flac_encode(x, 24000, bits_per_sample=bits)
    assert got[:4] == b"fLaC"
    assert got == jax_native.flac_encode(x, 24000, bits_per_sample=bits)
    y, sr = native_audio.flac_decode(got)
    assert sr == 24000 and y.shape == x.shape
    np.testing.assert_allclose(y, x, rtol=0, atol=1.0 / (2 ** (bits - 1) - 1))
