"""Band-mean resampling as precomputed matrices (golden-path law on device).

The reference's CPU path answers "average magnitude over frequency band
[f0, f1)" by meaning cubic-interpolated point samples on a lin_space
(src/fourier/interpolated_frequency_sample.rs:60-75, cubic :89-105).  All
sample positions depend only on (sample_rate, bins, band edges) — static per
config — so the whole query collapses into one [bands, bins] matrix and the
device-side cost is a single matmul, shared by:

* the spectrum-analyzer bar meters (models/spectrum_analyzer.py);
* an on-device variant of the golden band-mean law (models/golden.py is the
  scalar authority it is tested against).
"""

from __future__ import annotations

import math

import numpy as np

from spectrogram_tpu.config import SpectrogramConfig


def _cubic_stencil_weights(mu: np.ndarray):
    """Per-sample weights of bins x0..x3 for the reference cubic
    (interpolated_frequency_sample.rs:89-105): derived by expanding
    a0*mu^3 + a1*mu^2 + a2*mu + a3 in y0..y3."""
    mu2, mu3 = mu * mu, mu * mu * mu
    w0 = -mu3 + 2 * mu2 - mu
    w1 = mu3 - 2 * mu2 + 1.0
    w2 = -mu3 + mu2 + mu
    w3 = mu3 - mu2
    return w0, w1, w2, w3


def cubic_band_matrix(
    band_edges: np.ndarray, num_bins: int, sample_rate: float
) -> np.ndarray:
    """[bands, bins] matrix M with (M @ magnitudes) == the reference's
    `magnitude_in(f_i..f_{i+1})` for every band, per channel.

    band_edges: [bands+1] ascending frequencies.
    """
    period = 2.0 * num_bins / sample_rate  # interpolated_frequency_sample.rs:52-54
    bands = len(band_edges) - 1
    m = np.zeros((bands, num_bins), dtype=np.float64)
    for band in range(bands):
        f0, f1 = float(band_edges[band]), float(band_edges[band + 1])
        i0 = np.clip(f0 * period, 0.0, num_bins - 1.0)
        i1 = np.clip(f1 * period, 0.0, num_bins - 1.0)
        num = max(int(math.floor(i1 - i0)), 1)
        freqs = f0 + np.arange(num) * (f1 - f0) / num  # lin_space, end-exclusive
        idx = np.clip(freqs * period, 0.0, num_bins - 1.0)
        x1 = np.floor(idx).astype(np.int64)
        mu = idx - x1
        x0 = np.maximum(x1 - 1, 0)
        x2 = np.minimum(x1 + 1, num_bins - 1)
        x3 = np.minimum(x1 + 2, num_bins - 1)
        w0, w1, w2, w3 = _cubic_stencil_weights(mu)
        inv = 1.0 / num
        np.add.at(m[band], x0, w0 * inv)
        np.add.at(m[band], x1, w1 * inv)
        np.add.at(m[band], x2, w2 * inv)
        np.add.at(m[band], x3, w3 * inv)
    return m.astype(np.float32)


def log_space_edges(
    start: float, end: float, n_bands: int, base: float = 10.0
) -> np.ndarray:
    """[n_bands+1] log-spaced band edges replicating the analyzer's hand-
    rolled `log_space(start, end, n+1, 10)` + pairwise zip
    (spectrum_analyzer.rs:20-36, :53-59): step = (log end - log start)/(n+1),
    edge_i = base^(log start + step*i)."""
    ls = math.log(start, base)
    le = math.log(end, base)
    step = (le - ls) / (n_bands + 1)
    i = np.arange(n_bands + 1, dtype=np.float64)
    return np.power(base, ls + step * i)


def analyzer_band_matrix(cfg: SpectrogramConfig, n_bands: int = 128) -> np.ndarray:
    """The spectrum analyzer's [bands, bins] matrix: 128 log bands from 32 Hz
    to max(fs/2, 22050) (spectrum_analyzer.rs:53-59)."""
    end = max(cfg.sample_rate / 2.0, 22_050.0)
    edges = log_space_edges(32.0, end, n_bands)
    return cubic_band_matrix(edges, cfg.num_bins, cfg.sample_rate)


def golden_pixel_matrix(cfg: SpectrogramConfig, height: int | None = None) -> np.ndarray:
    """[H, bins] matrix for the golden display law: band-mean over the
    per-pixel log bands of the CPU path (simple_spectrogram.rs:142-147) —
    the band-edge variant of ops.colormap.resample_matrix's shader law."""
    h = height or cfg.viewport_height
    lo, hi = math.log(cfg.min_frequency), math.log(cfg.max_frequency)
    py = np.arange(h + 1, dtype=np.float64)
    edges = np.exp(lo + (py / h) * (hi - lo))
    return cubic_band_matrix(edges, cfg.num_bins, cfg.sample_rate)
