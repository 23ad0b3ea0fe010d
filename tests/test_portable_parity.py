"""The device pipeline against the float64 golden model (tests/reference.py)
at the geometries users run: the 4096-point served geometry, the reference's
2400/4800, a 1024-point FFT at 44.1 kHz, 96 kHz (9600-point), and a geometry
with no even-n1 four-step plan — each through both STFT backends."""

import jax.numpy as jnp
import numpy as np
import pytest

import reference
from spectrogram_tpu.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline

GEOMETRIES = {
    "4096": BENCH_CONFIG,
    "4800": DEFAULT_CONFIG,
    "1024": SpectrogramConfig(sample_rate=44_100.0, window_period=512 / 44_100.0,
                              hop_period=256 / 44_100.0),
    "9600": SpectrogramConfig(sample_rate=96_000.0),
    "no-plan": SpectrogramConfig(sample_rate=9000.0, window_period=0.025,
                                 hop_period=0.0125, max_frequency=4000.0),
}
# the repo's tonal gate: 1 u8 per channel (float slack for the premultiply)
TOLERANCE_U8 = 1.0 + 1e-6


@pytest.mark.parametrize("backend", ["mxu", "xla"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_process_matches_golden(geometry, backend):
    cfg = GEOMETRIES[geometry]
    if geometry == "no-plan" and backend == "mxu":
        with pytest.raises(ValueError, match="even-n1"):
            SpectrogramPipeline(cfg, stft_backend="mxu")
        assert SpectrogramPipeline(cfg).fft_plan is None  # auto takes jnp.fft
        return
    p = SpectrogramPipeline(cfg, stft_backend=backend)
    assert (p.fft_plan is not None) == (backend == "mxu")
    pcm = reference.chirp_and_tone(cfg, cfg.window_size + 5 * cfg.hop_size, 2)
    ids = np.asarray([0, 1])  # a stereo and a mono palette
    got = np.concatenate([
        np.asarray(p.process(jnp.asarray(pcm[s:s + 1]), palette_id=int(ids[s])))
        for s in range(2)
    ])
    want = reference.rgba_u8(pcm, cfg, p.schemes, ids)
    assert got.shape == want.shape
    mx, mean = reference.visible_diff(got, want)
    assert mx <= TOLERANCE_U8, (mx, mean)
    # magnitudes themselves, before any quantization
    mags = np.asarray(p._stft(jnp.asarray(pcm)))
    ref_mags = reference.stft_rows(pcm, cfg)
    assert np.abs(mags - ref_mags).max() < 2e-5 * np.abs(ref_mags).max()
