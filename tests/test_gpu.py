"""Tests that need the card: float32 contractions must stay float32 there.

A GPU runs float32 matmuls as TF32 (~3 decimal digits) unless a precision
is pinned; the CPU never does, so these checks only mean something on the
card.  They skip elsewhere; run them with
`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`, or through
`python chip_smoke.py`, which calls each test with the GPU device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrogram_tpu.config import BENCH_CONFIG
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu.ops import colormap

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU "
                    "(JAX_PLATFORMS=cuda python -m pytest tests -m gpu)")
    return devs[0]


def test_factored_lut_equals_bilinear_on_gpu(gpu):
    """The per-stream LUT contractions reproduce the bilinear sample to f32
    rounding; under TF32 they would be off by ~1e-3."""
    rng = np.random.default_rng(0)
    u = rng.random((3, 32, 4)).astype(np.float32)
    v = rng.random((3, 32, 4)).astype(np.float32)
    lut = u[:, :, None, :] * v[:, None, :, :]
    pan = rng.random((3, 64, 256)).astype(np.float32)
    mag = rng.random((3, 64, 256)).astype(np.float32)
    with jax.default_device(gpu):
        got = np.asarray(colormap.sample_lut_factored(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(pan), jnp.asarray(mag)))
        want = np.stack([
            np.asarray(colormap.sample_lut_bilinear(
                jnp.asarray(lut[s]), jnp.asarray(pan[s]), jnp.asarray(mag[s])))
            for s in range(3)
        ])
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("backend", ["mxu", "xla"])
def test_stft_matches_float64_reference_on_gpu(gpu, backend):
    """STFT magnitudes at the 4096-point geometry against numpy float64: the
    four-step matmul FFT pins HIGHEST, cuFFT runs in f32."""
    from reference import chirp_and_tone, stft_rows

    cfg = BENCH_CONFIG
    pcm = chirp_and_tone(cfg, 8 * cfg.hop_size + cfg.window_size, 2)
    with jax.default_device(gpu):
        p = SpectrogramPipeline(cfg, stft_backend=backend)
        got = np.asarray(p._stft(jnp.asarray(pcm)))
    want = stft_rows(pcm, cfg)
    assert np.abs(got - want).max() < 2e-5 * np.abs(want).max()
