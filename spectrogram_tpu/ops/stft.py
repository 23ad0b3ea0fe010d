"""Golden-model STFT: the exact numerical contract of the reference DSP core.

Reproduces `FastFourierTransform::process` (reference src/fourier/fft.rs:43-99)
in pure jnp:

  1. take one window of `window_size` stereo samples
  2. pack stereo as complex: z[i] = l[i] + i * r[i]           (fft.rs:57)
  3. periodic Hann window, denominator = window_size          (fft.rs:60-63)
  4. zero-pad to `pad_factor * window_size`                   (fft.rs:65)
  5. complex FFT                                              (fft.rs:77)
  6. stereo unpack via conjugate symmetry, bins k=1..W-1:
       L_k = |X_k + conj(X_{N-k})| / 2
       R_k = |X_k - conj(X_{N-k})| / 2                        (fft.rs:81-89)
  7. scale by 2 / window_size                                 (fft.rs:92)

and the strided framing driver `AudioStreamTransform::process`
(src/fourier/audio_transform.rs:34-42): peek a full window, emit one row,
advance by `hop` samples.

Note on a deliberate deviation: the reference's per-tick drain ends with one
failed `process()` attempt that still consumes `hop` samples from the ring
(audio_transform.rs:38-39 skips unconditionally), silently dropping up to one
hop of audio per UI tick.  Our chunked framing does not reproduce that bug:
the carry after a push is exactly `T - n_rows * hop` samples.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spectrogram_tpu.config import SpectrogramConfig


def hann_window(window_size: int, dtype=jnp.float32) -> jax.Array:
    """Periodic Hann window: 0.5 * (1 - cos(2*pi*i / window_size)).

    Matches fft.rs:60-63 exactly — the denominator is the window size itself
    (periodic / "DFT-even" Hann), not `window_size - 1` (symmetric Hann).
    """
    i = jnp.arange(window_size, dtype=dtype)
    return 0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * i / window_size))


def num_rows(num_samples: int, cfg: SpectrogramConfig) -> int:
    """Rows produced from `num_samples` buffered samples (static shape math)."""
    w, h = cfg.window_size, cfg.hop_size
    return max((num_samples - w) // h + 1, 0) if num_samples >= w else 0


def frame_starts(n_rows: int, cfg: SpectrogramConfig) -> jax.Array:
    return jnp.arange(n_rows) * cfg.hop_size


def frame_signal(pcm: jax.Array, cfg: SpectrogramConfig) -> jax.Array:
    """[..., T, 2] PCM -> [..., n_rows, window_size, 2] overlapped frames.

    Window i covers samples [i*hop, i*hop + window) — the peek-then-skip
    semantics of audio_transform.rs:34-42.

    For small static row counts (the streaming push case) the frames are
    built from n static slices, which XLA lowers to plain copies.  Large
    offline row counts use a fancy-index gather instead.
    """
    t = pcm.shape[-2]
    n = num_rows(t, cfg)
    w, h = cfg.window_size, cfg.hop_size
    if 0 < n <= 64:
        frames = [pcm[..., r * h : r * h + w, :] for r in range(n)]
        return jnp.stack(frames, axis=-3)
    idx = frame_starts(n, cfg)[:, None] + jnp.arange(w)[None, :]
    return pcm[..., idx, :]


def _stft_frame_lr(frame: jax.Array, cfg: SpectrogramConfig):
    """Core transform: [..., window_size, 2] -> (left, right) magnitudes,
    each [..., num_bins]."""
    w = cfg.window_size
    n = cfg.padded_size
    frame = frame.astype(jnp.float32)
    # Stereo packing (fft.rs:57) + periodic Hann (fft.rs:60-63).
    z = jax.lax.complex(frame[..., 0], frame[..., 1]) * hann_window(w)
    # Zero-pad (fft.rs:65) and transform (fft.rs:77).
    pad = [(0, 0)] * (z.ndim - 1) + [(0, n - w)]
    x = jnp.fft.fft(jnp.pad(z, pad))
    # Conjugate-symmetric stereo unpack over bins k = 1..W-1 (fft.rs:81-89):
    # partner of X_k is X_{N-k}.
    a = x[..., 1:w]
    b = x[..., -1 : -(w) : -1]  # X_{N-1}, X_{N-2}, ..., X_{N-W+1}
    # Post-scale 2 / window_size (fft.rs:92).
    scale = 2.0 / w
    left = jnp.abs(a + jnp.conj(b)) * (0.5 * scale)
    right = jnp.abs(a - jnp.conj(b)) * (0.5 * scale)
    return left, right


def stft_frame(frame: jax.Array, cfg: SpectrogramConfig) -> jax.Array:
    """One window [..., window_size, 2] -> magnitudes [..., num_bins, 2].

    The last axis of the output is (left, right) magnitude; bin j corresponds
    to padded-FFT bin k = j + 1 (fft.rs:81 skips the DC bin).
    """
    left, right = _stft_frame_lr(frame, cfg)
    return jnp.stack([left, right], axis=-1)


def stft_frame_planar(frame: jax.Array, cfg: SpectrogramConfig) -> jax.Array:
    """As stft_frame but channels-planar: [..., 2, num_bins].

    The bin axis stays minor, so downstream matmuls see contiguous
    [*, bins] planes instead of stride-2 interleaved channels.
    """
    left, right = _stft_frame_lr(frame, cfg)
    return jnp.stack([left, right], axis=-2)


def stft_rows(pcm: jax.Array, cfg: SpectrogramConfig) -> jax.Array:
    """[..., T, 2] PCM -> [..., n_rows, num_bins, 2] spectrogram rows.

    The golden reference for every production STFT path in this
    framework.  Pure jnp + XLA FFT; works batched over arbitrary leading axes.
    """
    return stft_frame(frame_signal(pcm, cfg), cfg)


def stft_rows_planar(pcm: jax.Array, cfg: SpectrogramConfig) -> jax.Array:
    """[..., T, 2] PCM -> [..., n_rows, 2, num_bins] (channels-planar)."""
    return stft_frame_planar(frame_signal(pcm, cfg), cfg)


def carry_size(cfg: SpectrogramConfig) -> int:
    """Samples of history a streaming STFT must retain between pushes."""
    return cfg.window_size - cfg.hop_size if cfg.window_size > cfg.hop_size else 0
