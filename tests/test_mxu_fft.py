"""Four-step matmul FFT (`stft_backend="mxu"`) parity vs the XLA-FFT golden model."""

import numpy as np
import jax.numpy as jnp
import pytest

from spectrogram_tpu.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu.ops import mxu_fft, stft


def test_choose_factors_bench_geometry():
    plan = mxu_fft.make_plan(BENCH_CONFIG)
    assert plan is not None
    assert plan.n == 4096 and plan.n1 * plan.n2 == 4096
    assert BENCH_CONFIG.window_size % plan.n1 == 0
    assert plan.m == BENCH_CONFIG.window_size // plan.n1


def test_choose_factors_reference_geometry():
    cfg = SpectrogramConfig()  # N=4800, W=2400
    plan = mxu_fft.make_plan(cfg)
    assert plan is not None
    assert plan.n1 * plan.n2 == 4800
    assert 2400 % plan.n1 == 0


@pytest.mark.parametrize(
    "cfg",
    [
        SpectrogramConfig(sample_rate=8000.0, window_period=0.032),   # W=256
        SpectrogramConfig(sample_rate=48000.0, window_period=2048 / 48000.0),
        SpectrogramConfig(sample_rate=48000.0, window_period=0.05),   # W=2400
    ],
    ids=["w256", "w2048", "w2400"],
)
def test_fft_packed_matches_numpy(cfg, rng):
    plan = mxu_fft.make_plan(cfg)
    w, n = cfg.window_size, cfg.padded_size
    z = (rng.standard_normal((3, w)) + 1j * rng.standard_normal((3, w))).astype(
        np.complex64
    )
    xr, xi = mxu_fft.fft_packed(
        jnp.asarray(z.real), jnp.asarray(z.imag), plan
    )
    ref = np.fft.fft(np.pad(z, ((0, 0), (0, n - w))), axis=-1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(xr), ref.real, atol=2e-5 * scale)
    np.testing.assert_allclose(np.asarray(xi), ref.imag, atol=2e-5 * scale)


def test_stft_rows_mxu_matches_golden(rng):
    cfg = SpectrogramConfig(
        sample_rate=8000.0, window_period=0.032, hop_period=0.008
    )
    pcm = (rng.standard_normal((2, 600, 2)) * 0.3).astype(np.float32)
    golden = np.asarray(stft.stft_rows(jnp.asarray(pcm), cfg))
    ours = np.asarray(mxu_fft.stft_rows_mxu(jnp.asarray(pcm), cfg))
    assert ours.shape == golden.shape
    np.testing.assert_allclose(ours, golden, atol=3e-5, rtol=1e-4)


def test_fallback_when_no_factorization():
    # window 97 (prime-ish): no N1 | W factorization of N=194 beyond trivial
    cfg = SpectrogramConfig(sample_rate=970.0, window_period=0.1)
    assert cfg.window_size == 97
    pcm = np.zeros((cfg.window_size, 2), np.float32)
    out = mxu_fft.stft_rows_mxu(jnp.asarray(pcm), cfg)
    assert out.shape == (1, cfg.num_bins, 2)


def test_split_real_matches_golden_planar(rng):
    cfg = SpectrogramConfig(
        sample_rate=8000.0, window_period=0.032, hop_period=0.008
    )
    pcm = (rng.standard_normal((2, 600, 2)) * 0.3).astype(np.float32)
    golden = np.asarray(stft.stft_rows_planar(jnp.asarray(pcm), cfg))
    split = np.asarray(mxu_fft.stft_rows_split_planar(jnp.asarray(pcm), cfg))
    assert split.shape == golden.shape
    np.testing.assert_allclose(split, golden, atol=3e-5, rtol=1e-4)


def test_split_real_bench_geometry(rng):
    pcm = (rng.standard_normal((1, BENCH_CONFIG.window_size, 2)) * 0.2).astype(
        np.float32
    )
    golden = np.asarray(stft.stft_rows_planar(jnp.asarray(pcm), BENCH_CONFIG))
    split = np.asarray(mxu_fft.stft_rows_split_planar(jnp.asarray(pcm), BENCH_CONFIG))
    np.testing.assert_allclose(split, golden, atol=3e-5, rtol=1e-4)
