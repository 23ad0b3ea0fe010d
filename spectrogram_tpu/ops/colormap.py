"""Log-frequency warp + dB + pan + palette LUT: the colormap stage.

This is the JAX equivalent of the reference's fragment shader
(src/widgets/gpu_spectrogram.rs:150-190), which per output pixel:

  1. warps the pixel row to a frequency: exp(lerp(ln 32, ln 22030, uv.y))
     (gpu_spectrogram.rs:158-162; the hardcoded 32/22030 shadow the uniforms)
  2. bilinearly samples the magnitude texture at that frequency  (:174)
  3. converts to dB: 10*log10(l^2 + r^2 + 1e-7), normalized to [-70,-10] (:177-179)
  4. computes pan = r / (l + r)                                   (:182)
  5. samples the 32x32 palette LUT at (pan, dB), clamped bilinear (:185)

Design: step 1+2 collapse into a precomputed `[H, B]` sparse-as-dense
resample matrix (2 nonzeros per row), so the per-row hot path is ONE matmul
followed by elementwise math and a small LUT lookup.

Output pixel index 0 = lowest frequency (GL uv.y = 0, bottom of screen).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from spectrogram_tpu.config import SpectrogramConfig


def log_bin_positions(
    cfg: SpectrogramConfig,
    height: int | None = None,
    shader_compat: bool = False,
) -> np.ndarray:
    """Fractional bin-axis sample position per output pixel.

    Default (correct) mapping: pixel y shows frequency
    f = exp(lerp(ln min_f, ln max_f, (y+0.5)/H)); output bin j holds
    frequency (j+1) * fs/N (fft.rs:81 skips DC), so the sample position is
    f/(fs/N) - 1.

    shader_compat=True reproduces the reference fragment shader instead
    (gpu_spectrogram.rs:158-174): texture coord f/max_frequency times the bin
    count, texel centers at (j+0.5)/B.  That conflates the bin axis's true
    top (fs/2, e.g. 23.99 kHz at 48 kHz) with the hardcoded 22030 Hz — the
    displayed axis is stretched ~9% at 48 kHz and arbitrarily wrong at other
    rates (the golden CPU path does NOT have this bug, which is how our
    cross-path test caught it).  See DESIGN.md D9.
    """
    h = height or cfg.viewport_height
    b = cfg.num_bins
    if shader_compat:
        mapped = np.asarray(cfg.log_frequency_fracs(h, centers=True))
        return mapped * b - 0.5
    freqs = np.asarray(cfg.log_frequency_fracs(h, centers=True)) * cfg.max_frequency
    return freqs / cfg.bin_hz - 1.0


def resample_matrix(
    cfg: SpectrogramConfig,
    height: int | None = None,
    shader_compat: bool = False,
) -> np.ndarray:
    """[H, B] f32 matrix: rgba_rows = M @ bins implements the bilinear
    log-frequency fetch.  Two nonzeros per output row."""
    h = height or cfg.viewport_height
    b = cfg.num_bins
    pos = log_bin_positions(cfg, h, shader_compat=shader_compat)
    base = np.floor(pos)
    w = pos - base
    # Clamp-to-edge at the boundaries.  Deviation from the reference: the GL
    # sampler uses Repeat wrap (gpu_spectrogram.rs:284), so the lowest pixels
    # (sample position < 0) would blend in the HIGHEST bin — an artifact of
    # the wrap mode, not intent.  We clamp instead.
    j0 = np.clip(base, 0, b - 1).astype(np.int64)
    j1 = np.clip(base + 1, 0, b - 1).astype(np.int64)
    m = np.zeros((h, b), dtype=np.float32)
    rows = np.arange(h)
    m[rows, j0] += (1.0 - w).astype(np.float32)
    m[rows, j1] += w.astype(np.float32)
    return m


def resample_rows(rows: jax.Array, matrix: jax.Array) -> jax.Array:
    """[..., B, 2] magnitude rows -> [..., H, 2] log-frequency pixels.

    HIGHEST precision keeps the contraction in true f32: the GPU default
    for f32 matmuls (TF32 inputs) costs ~3 decimal digits, well outside the
    parity tolerance vs the reference's f32 pipeline.
    """
    return jnp.einsum(
        "hb,...bc->...hc",
        matrix,
        rows,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def db_normalize(left: jax.Array, right: jax.Array, cfg: SpectrogramConfig) -> jax.Array:
    """10*log10(l^2+r^2+eps) normalized to the [min_db, max_db] window
    (gpu_spectrogram.rs:177-179; same law as colorscheme.rs:59-61)."""
    power = left * left + right * right
    db = 10.0 * jnp.log10(power + cfg.db_epsilon)
    return (db - cfg.min_db) / (cfg.max_db - cfg.min_db)


def pan_fraction(left: jax.Array, right: jax.Array) -> jax.Array:
    """Shader pan law r/(l+r) (gpu_spectrogram.rs:182), guarded at l+r=0.

    The guard (-> 0.5, center pan) is a documented deviation: the GLSL path
    divides unguarded and produces NaN that the clamped sampler hides.
    """
    denom = left + right
    return jnp.where(denom != 0.0, right / jnp.where(denom != 0.0, denom, 1.0), 0.5)


def sample_lut_bilinear(lut: jax.Array, pan: jax.Array, mag: jax.Array) -> jax.Array:
    """Clamped bilinear sample of a [R, R, 4] LUT at (x=pan, y=mag).

    Mirrors the GL sampler setup (Clamp + Linear, gpu_spectrogram.rs:284-287):
    texel space position = clamp(coord, 0, 1) * R - 0.5, clamped to [0, R-1].
    LUT axis 0 is magnitude, axis 1 is pan (see ColorScheme.lookup_table).
    """
    r = lut.shape[-3]

    def texpos(c):
        return jnp.clip(jnp.clip(c, 0.0, 1.0) * r - 0.5, 0.0, r - 1.0)

    py, px = texpos(mag), texpos(pan)
    y0 = jnp.floor(py).astype(jnp.int32)
    x0 = jnp.floor(px).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, r - 1)
    x1 = jnp.minimum(x0 + 1, r - 1)
    wy = (py - y0)[..., None]
    wx = (px - x0)[..., None]
    c00 = lut[y0, x0]
    c01 = lut[y0, x1]
    c10 = lut[y1, x0]
    c11 = lut[y1, x1]
    top = c00 * (1 - wx) + c01 * wx
    bot = c10 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy


def tent_weights(coord: jax.Array, resolution: int) -> jax.Array:
    """[...] texture coordinate in [0,1] -> [..., res] tent-basis weights.

    Row-wise this is the clamped-bilinear weight vector of the GL sampler
    (texel space x = clamp(clamp(c,0,1)*R - 0.5, 0, R-1); two adjacent
    nonzeros summing to 1), expressed densely so palette lookup becomes a
    small contraction instead of a per-pixel 2-D gather.
    """
    x = jnp.clip(jnp.clip(coord, 0.0, 1.0) * resolution - 0.5, 0.0, resolution - 1.0)
    t = jnp.arange(resolution, dtype=x.dtype)
    return jnp.clip(1.0 - jnp.abs(x[..., None] - t), 0.0, 1.0)


def sample_lut_factored(
    u_table: jax.Array, v_table: jax.Array, pan: jax.Array, mag: jax.Array
) -> jax.Array:
    """Sample a rank-1-factored LUT (see ColorScheme.factored_tables).

    Exactly equals `sample_lut_bilinear(LUT, pan, mag)` when
    LUT[i,j,c] = U[i,c] * V[j,c], because bilinear interpolation is
    separable.  u_table/v_table: [R, 4] (or with leading batch dims matching
    pan/mag's leading axes for per-stream palettes).  The contractions pin
    HIGHEST so the equality also holds where f32 matmuls default to TF32.
    """
    r = u_table.shape[-2]
    wu = tent_weights(mag, r)
    wv = tent_weights(pan, r)
    kw = dict(preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    if u_table.ndim == 2:
        cu = jnp.einsum("...t,tc->...c", wu, u_table, **kw)
        cv = jnp.einsum("...t,tc->...c", wv, v_table, **kw)
    else:
        # leading stream axis: per-stream tables [S, R, 4], coords [S, ..., R]
        cu = jnp.einsum("s...t,stc->s...c", wu, u_table, **kw)
        cv = jnp.einsum("s...t,stc->s...c", wv, v_table, **kw)
    return cu * cv


def colormap_resampled(
    pixels: jax.Array, lut: jax.Array, cfg: SpectrogramConfig
) -> jax.Array:
    """[..., H, 2] log-frequency magnitudes -> [..., H, 4] f32 RGBA."""
    left, right = pixels[..., 0], pixels[..., 1]
    mag = db_normalize(left, right, cfg)
    pan = pan_fraction(left, right)
    return sample_lut_bilinear(lut, pan, mag)


def colormap_rows(
    rows: jax.Array, matrix: jax.Array, lut: jax.Array, cfg: SpectrogramConfig
) -> jax.Array:
    """Full colormap stage: [..., B, 2] magnitude rows -> [..., H, 4] RGBA f32.

    Everything here fuses under jit into (matmul -> elementwise -> gather).
    """
    return colormap_resampled(resample_rows(rows, matrix), lut, cfg)


def composite_over_background(rgba: jax.Array, background_rgb: jax.Array) -> jax.Array:
    """Alpha-blend RGBA (f32, premultiplied-nothing) over an opaque background.

    Equivalent to the reference's frame clear to the palette background +
    GL alpha blending (gpu_spectrogram.rs:278-293).  background_rgb is u8 [3]
    or [..., 3]; returns u8 RGB.
    """
    a = rgba[..., 3:4]
    bg = background_rgb.astype(jnp.float32) / 255.0
    rgb = rgba[..., :3] * a + bg * (1.0 - a)
    return jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.uint8)


def rgba_f32_to_u8(rgba: jax.Array) -> jax.Array:
    return jnp.clip(jnp.round(rgba * 255.0), 0, 255).astype(jnp.uint8)


def unpack_rgba(packed) -> np.ndarray:
    """Host-side: [..., H] int32 RGBA8888 -> [..., H, 4] u8 (zero-copy view)."""
    arr = np.asarray(packed)
    return arr.view(np.uint8).reshape(*arr.shape, 4)
