"""User-defined palettes through the device pipeline.

The reference accepts any scheme built with the public constructors
(colorscheme.rs:24-39) and uploads any scheme's lookup_table to the GPU
(gpu_spectrogram.rs:232-239).  Parity here: `SpectrogramPipeline(schemes=…)`
accepts ColorScheme (custom gradients included) and FactoredScheme
(arbitrary separable LUTs); both must produce the rows of the float64
golden model (tests/reference.py), which samples each scheme's full LUT."""

import numpy as np
import pytest
import jax.numpy as jnp

from spectrogram_tpu.color.colorscheme import (
    DEFAULT_COLOR_SCHEMES,
    ColorScheme,
    FactoredScheme,
)
from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
import reference

CFG = SpectrogramConfig(
    sample_rate=8000.0, window_period=0.032, hop_period=0.008,
    viewport_height=128,
)


def _amber(t):
    """A custom vectorized gradient: black -> amber -> white."""
    t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
    r = np.minimum(1.0, 1.6 * t)
    g = np.clip(1.4 * t - 0.2, 0.0, 1.0)
    b = np.clip(2.5 * t - 1.5, 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


CUSTOM_MONO = ColorScheme("Amber (custom)", "", gradient_fn=_amber)
CUSTOM_STEREO = ColorScheme(
    "Amber (custom stereo)", "", background=(10, 0, 30), gradient_fn=_amber
)


def _nonseparable_builtin_scheme():
    """A FactoredScheme OUTSIDE the built-in structure: rgb varies along the
    magnitude axis AND alpha varies along the pan axis."""
    res = 32
    i = np.arange(res) / (res - 1)
    u = np.ones((res, 4), np.float32)
    v = np.ones((res, 4), np.float32)
    u[:, :3] = _amber(i).astype(np.float32)     # rgb = f(mag)
    v[:, 3] = (0.25 + 0.75 * i).astype(np.float32)  # alpha = g(pan): not builtin
    return FactoredScheme("MagColor-PanAlpha", u, v, background=(0, 0, 0))


def _compare(schemes, pid, n=2):
    """process() vs the golden model, palette `pid`.  Broadband input: a
    pan-dependent color is only defined where both channels carry signal
    (at the noise floor the pan is a ratio of rounding errors)."""
    p = SpectrogramPipeline(CFG, chunk_hops=1, viewport_rows=8, schemes=schemes)
    rng = np.random.default_rng(5)
    pcm = (rng.standard_normal((n, CFG.window_size + 6 * CFG.hop_size, 2))
           * 0.3).astype(np.float32)
    got = np.asarray(p.process(jnp.asarray(pcm), palette_id=pid))
    want = reference.rgba_u8(pcm, CFG, schemes, pid)
    assert reference.visible_diff(got, want)[0] <= 1.0 + 1e-6
    return p, got


def test_custom_gradient_scheme_matches_golden():
    """A 20th scheme from a user gradient_fn renders like its own LUT."""
    schemes = DEFAULT_COLOR_SCHEMES + (CUSTOM_MONO,)
    _, out = _compare(schemes, len(schemes) - 1)
    assert out[..., 3].min() == 255                   # mono: alpha = 1


def test_custom_stereo_scheme():
    schemes = DEFAULT_COLOR_SCHEMES + (CUSTOM_STEREO,)
    p, _ = _compare(schemes, len(schemes) - 1)
    # background flows into composite
    np.testing.assert_array_equal(np.asarray(p.backgrounds[-1]), [10, 0, 30])


@pytest.mark.parametrize("pid", [2, 19])
def test_factored_scheme_matches_golden(pid):
    """A scheme outside the built-in mono/stereo structure (rgb from
    magnitude, alpha from pan) beside the built-ins in one registry."""
    _compare(DEFAULT_COLOR_SCHEMES + (_nonseparable_builtin_scheme(),), pid)


def test_factored_scheme_streaming(rng):
    """Pushes with chunk_hops > 1 match the one-shot path for every scheme
    of a user registry."""
    schemes = (CUSTOM_MONO, _nonseparable_builtin_scheme())
    p = SpectrogramPipeline(CFG, chunk_hops=2, viewport_rows=8,
                            schemes=schemes, store_ring=False)
    pcm = rng.standard_normal((2, 3 * p.chunk_size, 2)).astype(np.float32) * 0.3
    padded = np.concatenate([np.zeros((2, p.carry_size, 2), np.float32), pcm], 1)
    for pid in range(len(schemes)):
        st = p.set_palette(p.init_state(2), np.asarray([pid, pid]))
        outs = []
        for i in range(3):
            st, o = p.push(st, jnp.asarray(
                pcm[:, i * p.chunk_size:(i + 1) * p.chunk_size]))
            outs.append(np.asarray(o))
        # <= 1 u8: the one-shot call batches 6 rows per matmul, the pushes
        # 2, and XLA may tile the two contractions differently (f32
        # association; see test_fuzz_geometries)
        mx, _ = reference.visible_diff(
            np.concatenate(outs, axis=1),
            np.asarray(p.process(jnp.asarray(padded), palette_id=pid)),
        )
        assert mx <= 1.0 + 1e-6


def test_factored_scheme_validation():
    with pytest.raises(ValueError, match="res"):
        # table resolution must match the pipeline's LUT resolution
        bad = FactoredScheme(
            "tiny", np.ones((8, 4), np.float32), np.ones((8, 4), np.float32)
        )
        bad.factored_tables(32)
    with pytest.raises(ValueError, match="4"):
        FactoredScheme(
            "misshapen", np.ones((32, 3), np.float32),
            np.ones((32, 3), np.float32),
        )
    s = _nonseparable_builtin_scheme()
    assert s.is_stereo                      # v varies along pan
    lut = s.lookup_table(32)
    u, v = s.factored_tables(32)
    np.testing.assert_allclose(lut, u[:, None, :] * v[None, :, :])


def test_uniform_generic_palette_matches_per_stream(rng):
    """Scalar set_palette on a registry led by a user FactoredScheme equals
    the per-stream array with that palette everywhere."""
    schemes = (_nonseparable_builtin_scheme(),) + tuple(DEFAULT_COLOR_SCHEMES[:2])
    p = SpectrogramPipeline(CFG, chunk_hops=2, packed_output=True,
                            schemes=schemes)
    s_uni = p.set_palette(p.init_state(2), 0)
    s_per = p.set_palette(p.init_state(2), jnp.asarray([0, 0]))
    chunk = jnp.asarray(
        rng.standard_normal((2, p.chunk_size, 2)).astype(np.float32) * 0.2
    )
    s_uni, out_u = p.push(s_uni, chunk)
    s_per, out_p = p.push(s_per, chunk)
    np.testing.assert_array_equal(np.asarray(out_u), np.asarray(out_p))
