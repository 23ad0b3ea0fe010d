"""Matmul STFT: four-step Cooley-Tukey FFT as batched matmuls.

The reference's compute kernel is FFTW's C2C transform planned with MEASURE
(reference src/fourier/fft.rs:20-24,77).  Here the "plan" is a factorization
N = N1 * N2 that turns one length-N FFT into two batched small dense DFTs
with a twiddle multiply in between, so the transform runs as batched GEMMs
(the alternative is `jnp.fft`, ops/stft.py):

    X[N2*k1 + k2] = sum_{n1} W_N^{n1 k2} W_{N1}^{n1 k1}
                    * (sum_{n2} x[n1 + N1*n2] W_{N2}^{n2 k2})

Cost N*(N1+N2) complex MACs instead of N^2 — at the bench geometry
(N=4096=64x64) that's 393K MACs/row of matmul work vs 16.8M for the
naive DFT.  Two extra structural wins baked in:

* the Hann window is fused into the reshape (no separate pass over HBM);
* the reference's 2x zero-padding (fft.rs:65) means the upper half of the
  input is structurally zero: with N1 | W the last N2/2 rows of the
  stage-1 operand vanish, halving stage-1 FLOPs.

Stereo packing (l + i*r, fft.rs:57) is kept: one complex FFT serves both
channels, and the conjugate-symmetry unpack (fft.rs:81-89) runs as fused
elementwise ops on the result.

Parity: `stft_rows_mxu` must match `ops.stft.stft_rows` (XLA FFT golden
model) to f32 tolerance; see tests/test_mxu_fft.py.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.ops import stft as stft_ops

# Every contraction here runs in true f32: the GPU default for f32 matmuls
# (TF32 inputs) costs ~3 decimal digits, outside the parity contract.
_KW = dict(preferred_element_type=jnp.float32,
           precision=jax.lax.Precision.HIGHEST)

@dataclasses.dataclass(frozen=True)
class FftPlan:
    """Factorization + operand shapes for one (window, pad) geometry.

    The analog of an FFTW plan: built once per config, baked into the
    jitted computation as constants.
    """

    n: int          # padded FFT length
    n1: int         # inner factor (stage-2 DFT size); must divide window
    n2: int         # outer factor (stage-1 DFT size)
    m: int          # nonzero stage-1 rows = ceil(window / n1)


def choose_factors(n: int, window: int) -> tuple[int, int] | None:
    """Pick N1*N2 = n with N1 | window (so zero rows drop out cleanly),
    both factors <= 256, minimizing stage cost.  MAC ties (e.g. 32x128 vs
    64x64 at N=4096) keep the SMALLER n1."""
    best = None
    for n1 in range(2, 257):
        if n % n1:
            continue
        n2 = n // n1
        if n2 > 256 or window % n1:
            continue
        m = window // n1
        cost = n1 * n2 * m + n1 * n1 * n2
        if best is None or cost < best[0]:
            best = (cost, n1, n2)
    if best is None:
        return None
    return best[1], best[2]


def make_plan(cfg: SpectrogramConfig) -> FftPlan | None:
    factors = choose_factors(cfg.padded_size, cfg.window_size)
    if factors is None:
        return None
    n1, n2 = factors
    return FftPlan(n=cfg.padded_size, n1=n1, n2=n2, m=cfg.window_size // n1)


@functools.lru_cache(maxsize=32)
def _plan_constants(plan: FftPlan):
    """DFT/twiddle matrices for a plan, in f64 then cast to f32."""
    n, n1, n2, m = plan.n, plan.n1, plan.n2, plan.m
    # Stage 1: F2m[n2_, k2] over the m nonzero rows.
    i2 = np.arange(m)[:, None] * np.arange(n2)[None, :]
    f2 = np.exp(-2j * np.pi * i2 / n2)
    # Twiddle T[k2, n1_] = W_N^{n1_ * k2}.
    it = np.arange(n2)[:, None] * np.arange(n1)[None, :]
    tw = np.exp(-2j * np.pi * it / n)
    # Stage 2: F1[n1_, k1].
    i1 = np.arange(n1)[:, None] * np.arange(n1)[None, :]
    f1 = np.exp(-2j * np.pi * i1 / n1)
    # numpy, not jnp: jnp arrays built under an active trace would be cached
    # as leaked tracers.  These fold to on-device constants under jit anyway.
    to = lambda a: (a.real.astype(np.float32), a.imag.astype(np.float32))
    return to(f2), to(tw), to(f1)


def _cmatmul(eq: str, a_re, a_im, b_re, b_im):
    """Complex einsum via four real einsums."""
    re = jnp.einsum(eq, a_re, b_re, **_KW) - jnp.einsum(eq, a_im, b_im, **_KW)
    im = jnp.einsum(eq, a_re, b_im, **_KW) + jnp.einsum(eq, a_im, b_re, **_KW)
    return re, im


def fft_packed(z_re: jax.Array, z_im: jax.Array, plan: FftPlan):
    """Length-W complex input (implicitly zero-padded to plan.n) -> full
    length-n FFT, via two batched matmul stages.

    z_re, z_im: [..., W] with W = plan.m * plan.n1.
    Returns (X_re, X_im): [..., n].
    """
    n1, n2, m = plan.n1, plan.n2, plan.m
    (f2r, f2i), (twr, twi), (f1r, f1i) = _plan_constants(plan)
    batch = z_re.shape[:-1]
    # A[..., n2_, n1_] = x[n1_ + n1*n2_]; rows n2_ >= m are zero and dropped.
    ar = z_re.reshape(*batch, m, n1)
    ai = z_im.reshape(*batch, m, n1)
    # Stage 1: B[..., k2, n1_] = sum_{n2_<m} A[..., n2_, n1_] F2[n2_, k2]
    br, bi = _cmatmul("...mi,mk->...ki", ar, ai, f2r, f2i)
    # Twiddle: C = B * W_N^{n1_ k2}
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    # Stage 2: D[..., k1, k2] = sum_{n1_} C[..., k2, n1_] F1[n1_, k1]
    dr, di = _cmatmul("...ki,il->...lk", cr, ci, f1r, f1i)
    # k = n2*k1 + k2: row-major reshape of [k1, k2].
    return dr.reshape(*batch, n1 * n2), di.reshape(*batch, n1 * n2)


def stft_frame_mxu(
    frame: jax.Array, cfg: SpectrogramConfig, plan: FftPlan
) -> jax.Array:
    """Drop-in matmul replacement for ops.stft.stft_frame: [..., W, 2] ->
    [..., W-1, 2] magnitudes, same numerical contract."""
    w = cfg.window_size
    n = cfg.padded_size
    assert plan.n == n and plan.m * plan.n1 == w, (plan, cfg)
    frame = frame.astype(jnp.float32)
    hann = stft_ops.hann_window(w)
    z_re = frame[..., 0] * hann   # window fused into the pack
    z_im = frame[..., 1] * hann
    x_re, x_im = fft_packed(z_re, z_im, plan)
    # Conjugate-symmetric stereo unpack, bins k = 1..W-1 (fft.rs:81-89):
    a_re, a_im = x_re[..., 1:w], x_im[..., 1:w]
    b_re = x_re[..., -1:-w:-1]
    b_im = x_im[..., -1:-w:-1]
    scale = 2.0 / w
    left = jnp.sqrt((a_re + b_re) ** 2 + (a_im - b_im) ** 2) * (0.5 * scale)
    right = jnp.sqrt((a_re - b_re) ** 2 + (a_im + b_im) ** 2) * (0.5 * scale)
    return jnp.stack([left, right], axis=-1)


def stft_rows_mxu(
    pcm: jax.Array, cfg: SpectrogramConfig, plan: FftPlan | None = None
) -> jax.Array:
    """[..., T, 2] PCM -> [..., rows, W-1, 2]: framing + four-step matmul STFT.

    Falls back to the XLA-FFT golden path when no matmul factorization
    exists for the geometry.
    """
    plan = plan or make_plan(cfg)
    if plan is None:
        return stft_ops.stft_rows(pcm, cfg)
    frames = stft_ops.frame_signal(pcm, cfg)
    return stft_frame_mxu(frames, cfg, plan)


@functools.lru_cache(maxsize=32)
def _block_plan_constants(plan: FftPlan):
    """Block-matrix constants for the two-matmul split-real four-step.

    Complex arithmetic as real block matrices: six separate real matmuls
    (2 stage-1 + 4 stage-2) become two, quartering the number of passes
    over the [batch, n1, n2]-sized intermediates in device memory.

      stage 1: A real [.., m] x F2cat [m, 2*n2]          -> (Br | Bi)
      stage 2: (Cr | Ci) [.., 2*n1] x F1blk [2*n1, 2*k1h] -> (Dr | Di)
               F1blk = [[f1r, f1i], [-f1i, f1r]]
    """
    n, n1, n2, m = plan.n, plan.n1, plan.n2, plan.m
    assert n1 % 2 == 0, plan
    i2 = np.arange(m)[:, None] * np.arange(n2)[None, :]
    f2 = np.exp(-2j * np.pi * i2 / n2)
    f2cat = np.concatenate([f2.real, f2.imag], axis=1).astype(np.float32)
    it = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    tw = np.exp(-2j * np.pi * it / n)                     # [n1, n2]
    twr = tw.real.astype(np.float32)
    twi = tw.imag.astype(np.float32)
    i1 = np.arange(n1)[:, None] * np.arange(n1 // 2)[None, :]
    f1 = np.exp(-2j * np.pi * i1 / n1)
    f1blk = np.block(
        [[f1.real, f1.imag], [-f1.imag, f1.real]]
    ).astype(np.float32)  # [2*n1, 2*k1h]
    return f2cat, twr, twi, f1blk


def stft_rows_split_planar(
    pcm: jax.Array, cfg: SpectrogramConfig, plan: FftPlan | None = None
) -> jax.Array:
    """[..., T, 2] PCM -> [..., rows, 2, num_bins]: split-real matmul STFT.

    Equal in exact arithmetic to the packed-complex path (the reference's
    stereo packing, fft.rs:57,81-89, is a CPU trick to get two real DFTs from
    one complex FFT — here each channel gets its own real-input four-step
    with a HALF-spectrum stage 2, so the FLOPs match the packed version while
    eliminating its reverse/conjugate-unpack passes entirely).
    """
    plan = plan or make_plan(cfg)
    # Half-spectrum stage 2 yields bins k < N/2; that covers the contract's
    # k = 1..W-1 only when W <= N/2, i.e. pad_factor >= 2.  pad_factor=1
    # would silently return half the bins — fall back to the XLA path.
    if plan is None or plan.n1 % 2 or cfg.pad_factor < 2:
        return stft_ops.stft_rows_planar(pcm, cfg)
    w = cfg.window_size
    frames = stft_ops.frame_signal(pcm, cfg)  # [..., rows, W, 2]
    # channels to a leading batch position: [..., rows, 2, W]
    x = jnp.moveaxis(frames.astype(jnp.float32), -1, -2)
    return stft_planar_windows(x, cfg, plan)


def stft_planar_windows(
    windows: jax.Array,  # [..., 2, W] planar full windows, NOT yet Hann'd
    cfg: SpectrogramConfig,
    plan: FftPlan,
) -> jax.Array:
    """Planar windows -> [..., 2, num_bins] magnitudes via the block-matrix
    split-real four-step (see _block_plan_constants): ONE stage-1 matmul and
    ONE stage-2 matmul total."""
    w = cfg.window_size
    n1, n2, m = plan.n1, plan.n2, plan.m
    f2cat, twr, twi, f1blk = _block_plan_constants(plan)
    x = windows.astype(jnp.float32) * stft_ops.hann_window(w)
    batch = x.shape[:-1]
    a = x.reshape(*batch, m, n1)
    # Stage 1: B_cat[.., n1_, 2*n2] = (Br | Bi) — one matmul.
    a_t = jnp.swapaxes(a, -1, -2)                       # [.., n1, m]
    b_cat = jnp.einsum("...im,mk->...ik", a_t, jnp.asarray(f2cat), **_KW)
    br = b_cat[..., :n2]                                # [.., n1, n2]
    bi = b_cat[..., n2:]
    # Twiddle ([n1, n2] layout).
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    # Stage 2: contract over n1.  (Cr | Ci) along the contracted axis with
    # the block DFT — one matmul.  Output [.., n2(k2), 2*k1h] = (Dr | Di).
    c_cat = jnp.concatenate(
        [jnp.swapaxes(cr, -1, -2), jnp.swapaxes(ci, -1, -2)], axis=-1
    )                                                   # [.., k2, 2*n1]
    d_cat = jnp.einsum("...ki,il->...kl", c_cat, jnp.asarray(f1blk), **_KW)
    k1h = n1 // 2
    dr = jnp.swapaxes(d_cat[..., :k1h], -1, -2)         # [.., k1h, k2]
    di = jnp.swapaxes(d_cat[..., k1h:], -1, -2)
    half = k1h * n2
    dr = dr.reshape(*batch, half)
    di = di.reshape(*batch, half)
    # |X[k]| * 2/W over bins k = 1..W-1 (fft.rs:81-92).
    mag = jnp.sqrt(dr * dr + di * di) * (2.0 / w)
    return mag[..., 1:w]
