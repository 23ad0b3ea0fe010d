"""Float64 numpy reference for the whole push: STFT -> colormap -> u8 RGBA.

Written from the reference sources, independently of the package's device
code: the STFT law of src/fourier/fft.rs:43-99 (stereo packing, periodic
Hann, zero padding, conjugate-symmetric unpack, 2/W scale) and the fragment
shader of gpu_spectrogram.rs:150-190 (log-frequency bilinear fetch, dB
window, pan law, clamped bilinear LUT sample).  The one package helper used
is `ops.colormap.resample_matrix`, the static two-tap fetch matrix that
tests/test_colormap.py checks against the shader transcription.
Not a test module (no test_ prefix).
"""

import numpy as np

from spectrogram_tpu.io.sources import ChirpSource, SineSource
from spectrogram_tpu.ops import colormap


def chirp_and_tone(cfg, n_samples: int, n_streams: int = 1) -> np.ndarray:
    """[S, T, 2] f32 tonal test signal: an exponential chirp on the left
    channel and a 440 Hz tone on the right.  Noise would hide FFT precision
    bugs (its spectrum has no deep leakage floor to lose)."""
    left = ChirpSource(cfg.sample_rate, f0=100.0, f1=0.4 * cfg.sample_rate,
                       duration=n_samples / cfg.sample_rate)
    right = SineSource(cfg.sample_rate, freq_right=440.0, amplitude=0.3)
    x = np.stack(
        [left.next_block(n_samples)[:, 0], right.next_block(n_samples)[:, 1]],
        axis=-1,
    )
    return np.broadcast_to(x, (n_streams,) + x.shape).astype(np.float32).copy()


def stft_rows(pcm: np.ndarray, cfg) -> np.ndarray:
    """[S, T, 2] PCM -> [S, rows, 2, bins] float64 magnitudes (fft.rs)."""
    w, h, n = cfg.window_size, cfg.hop_size, cfg.padded_size
    rows = (pcm.shape[1] - w) // h + 1
    idx = np.arange(rows)[:, None] * h + np.arange(w)[None, :]
    frames = pcm.astype(np.float64)[:, idx]                   # [S, r, W, 2]
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(w) / w))
    z = (frames[..., 0] + 1j * frames[..., 1]) * hann
    x = np.fft.fft(z, n=n, axis=-1)
    a = x[..., 1:w]
    b = x[..., ::-1][..., : w - 1]                   # X_{N-1}, X_{N-2}, ...
    left = np.abs(a + np.conj(b)) / 2.0 * (2.0 / w)
    right = np.abs(a - np.conj(b)) / 2.0 * (2.0 / w)
    return np.stack([left, right], axis=-2)


def colormap_u8(rows: np.ndarray, cfg, luts: np.ndarray) -> np.ndarray:
    """[S, r, 2, bins] magnitudes + per-stream [S, R, R, 4] LUTs -> [S, r, H, 4]
    u8 RGBA, in float64."""
    m = colormap.resample_matrix(cfg).astype(np.float64)      # [H, B]
    px = np.einsum("hb,srcb->srch", m, rows)
    left, right = px[:, :, 0], px[:, :, 1]
    db = 10.0 * np.log10(left * left + right * right + cfg.db_epsilon)
    mag = (db - cfg.min_db) / (cfg.max_db - cfg.min_db)
    denom = left + right
    pan = np.where(denom != 0.0, right / np.where(denom != 0.0, denom, 1.0), 0.5)
    res = luts.shape[1]

    def texpos(c):
        return np.clip(np.clip(c, 0.0, 1.0) * res - 0.5, 0.0, res - 1.0)

    py, pxl = texpos(mag), texpos(pan)
    y0, x0 = np.floor(py).astype(int), np.floor(pxl).astype(int)
    y1, x1 = np.minimum(y0 + 1, res - 1), np.minimum(x0 + 1, res - 1)
    wy, wx = (py - y0)[..., None], (pxl - x0)[..., None]
    s = np.arange(luts.shape[0])[:, None, None]
    lut = luts.astype(np.float64)
    top = lut[s, y0, x0] * (1 - wx) + lut[s, y0, x1] * wx
    bot = lut[s, y1, x0] * (1 - wx) + lut[s, y1, x1] * wx
    rgba = top * (1 - wy) + bot * wy
    return np.clip(np.round(rgba * 255.0), 0, 255).astype(np.uint8)


def rgba_u8(pcm: np.ndarray, cfg, schemes, palette_ids) -> np.ndarray:
    """The reference output for `pipeline.process(pcm, ...)`: [S, rows, H, 4]."""
    luts = np.stack([
        schemes[int(p)].lookup_table(cfg.lut_resolution)
        for p in np.broadcast_to(palette_ids, (pcm.shape[0],))
    ])
    return colormap_u8(stft_rows(pcm, cfg), cfg, luts)


def visible_diff(a, b) -> tuple[float, float]:
    """Max and mean |difference| per RGBA channel of two u8 [..., 4] images,
    with RGB premultiplied by alpha: what a viewer sees over any background.
    The RGB of a fully transparent pixel is invisible, and for stereo
    palettes it is set by the pan of two magnitudes at the numerical noise
    floor, which no two FFT implementations agree on."""
    pa, pb = (np.asarray(x).astype(np.float64) for x in (a, b))
    for p in (pa, pb):
        p[..., :3] *= p[..., 3:] / 255.0
    d = np.abs(pa - pb)
    return float(d.max()), float(d.mean())
