"""Spectrum analyzer: per-band level meters with peak decay, batched.

JAX redesign of the reference `SpectrumAnalyzer` widget
(src/widgets/spectrum_analyzer.rs): 128 log-spaced bands from 32 Hz to
max(fs/2, 22050) (:53-59), each bar showing
`10*log10(|m| + 1e-7)` normalized to [-70, -10] (:61-66 — note the
reference's law uses the complex NORM here, not power, unlike the
spectrogram's dB law) with peak decay `max(new, prev * 0.99)` (:67).

Device-side the whole band query (cubic band-mean over the spectrum,
C7's `magnitude_in`) is one precomputed [bands, bins] matmul
(ops/resample.analyzer_band_matrix); the decay is a running state array.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.ops.resample import analyzer_band_matrix

MIN_DB = -70.0  # spectrum_analyzer.rs:49
MAX_DB = -10.0  # spectrum_analyzer.rs:50
DECAY = 0.99    # spectrum_analyzer.rs:67


class SpectrumAnalyzer:
    """Batched bar meters: push spectrogram rows, read bar levels in [0, 1]."""

    def __init__(self, cfg: SpectrogramConfig, n_bands: int = 128):
        self.cfg = cfg
        self.n_bands = int(n_bands)
        self.band_matrix = jnp.asarray(analyzer_band_matrix(cfg, n_bands))

    def init_levels(self, n_streams: int) -> jax.Array:
        # LevelBar initial value 0.3 (spectrum_analyzer.rs:95)
        return jnp.full((n_streams, self.n_bands), 0.3, jnp.float32)

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def push_rows(self, levels: jax.Array, rows: jax.Array) -> jax.Array:
        """Update levels with a batch of spectrogram rows.

        levels: [S, bands]; rows: [S, k, bins, 2].  Each row applies one
        band-magnitude measurement followed by one decay step, in order
        (lax.scan over k) — identical to pushing rows one at a time.
        """
        bands_lr = jnp.einsum(
            "gb,skbc->kgsc",  # k leading so scan can walk rows in time order
            self.band_matrix,
            rows,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        norm = jnp.sqrt(
            bands_lr[..., 0] ** 2 + bands_lr[..., 1] ** 2
        )  # |c| — the analyzer's law uses norm, not power (:63)
        db = 10.0 * jnp.log10(norm + 1e-7)
        new_vals = jnp.clip((db - MIN_DB) / (MAX_DB - MIN_DB), 0.0, 1.0)

        def step(lv, v):  # v: [bands, S]
            return jnp.maximum(v.T, lv * DECAY), None

        levels, _ = jax.lax.scan(step, levels, new_vals)
        return levels

    @staticmethod
    def rasterize_levels(levels, height: int, scheme) -> "np.ndarray":
        """Host-side raster of one stream's levels [bands] -> [height, bands,
        3] u8 bar image — the live-view analog of the reference's LevelBar
        column (spectrum_analyzer.rs:48-69, 88-99): one vertical bar per band
        rising from the bottom, colored by the scheme's foreground (GTK
        LevelBar chrome has no analog here; the bar geometry is the parity
        surface).  Vectorized (one mask over the [height, bands] grid)."""
        import numpy as np

        lv = np.clip(np.asarray(levels, np.float32), 0.0, 1.0)
        bands = lv.shape[0]
        bg = np.asarray(scheme.background_color(), np.uint8)
        fg = np.asarray(scheme.foreground_color(), np.uint8)
        img = np.broadcast_to(bg, (height, bands, 3)).copy()
        ys = np.arange(height)[:, None]  # row 0 = top
        img[ys >= ((1.0 - lv[None, :]) * height)] = fg
        return img
