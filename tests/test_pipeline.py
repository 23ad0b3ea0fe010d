"""Streaming pipeline tests: push/ring/cursor semantics and parity between
the streaming path and the one-shot golden path."""

import numpy as np
import jax.numpy as jnp
import pytest

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu.ops import stft as stft_ops

CFG = SpectrogramConfig(
    sample_rate=8000.0,
    window_period=0.032,   # W = 256
    hop_period=0.008,      # hop = 64
    viewport_height=64,
    viewport_rows=32,
)


def make_pipeline(**kw):
    return SpectrogramPipeline(CFG, chunk_hops=4, **kw)


def test_push_emits_chunk_hops_rows(rng):
    p = make_pipeline()
    s = p.init_state(3)
    chunk = jnp.asarray(rng.standard_normal((3, p.chunk_size, 2)).astype(np.float32))
    s, rgba = p.push(s, chunk)
    assert rgba.shape == (3, 4, CFG.viewport_height, 4)
    assert rgba.dtype == jnp.uint8
    assert int(s.cursor) == 4
    assert int(s.row_count) == 4


def test_streaming_matches_one_shot(rng):
    """Pushing T samples in hop-multiple chunks produces the same rows as
    framing the whole signal at once (up to ring bf16 rounding for the ring,
    exact f32 for the emitted rows)."""
    p = make_pipeline()
    n_pushes = 5
    total = p.chunk_size * n_pushes
    pcm = rng.standard_normal((2, total, 2)).astype(np.float32) * 0.3
    s = p.init_state(2)
    emitted = []
    for i in range(n_pushes):
        chunk = jnp.asarray(pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size])
        s, rgba = p.push(s, chunk)
        emitted.append(np.asarray(rgba))
    streamed = np.concatenate(emitted, axis=1)  # [S, n_rows, H, 4]

    # One-shot reference: leading zeros stand in for the initial carry state.
    padded = np.concatenate(
        [np.zeros((2, p.carry_size, 2), np.float32), pcm], axis=1
    )
    oneshot = np.asarray(p.process(jnp.asarray(padded)))
    assert oneshot.shape == streamed.shape
    np.testing.assert_array_equal(streamed, oneshot)


def test_ring_wraps_and_render_orders_chronologically(rng):
    p = make_pipeline()
    s = p.init_state(1)
    n_pushes = p.viewport_rows // p.chunk_hops + 2  # wrap past the ring end
    rows_seen = []
    for i in range(n_pushes):
        chunk = jnp.asarray(
            rng.standard_normal((1, p.chunk_size, 2)).astype(np.float32) * 0.1
        )
        s, rgba = p.push(s, chunk)
        rows_seen.append(np.asarray(rgba))
    assert int(s.cursor) == (n_pushes * p.chunk_hops) % p.viewport_rows
    assert int(s.row_count) == n_pushes * p.chunk_hops

    # The viewport holds the LAST viewport_rows rows in chronological order.
    viewport = np.asarray(p.render_viewport(s))[0]  # [R, H, 4]
    all_rows = np.concatenate(rows_seen, axis=1)[0]  # [n_rows, H, 4]
    expected_last = all_rows[-p.viewport_rows :]
    # Ring stores bf16 rows; emitted rgba came from f32 rows. Compare loosely:
    # the two paths must agree within bf16 quantization of the magnitudes.
    diff = np.abs(
        viewport.astype(np.int32) - expected_last.astype(np.int32)
    )
    assert np.mean(diff) < 2.0
    assert np.percentile(diff, 99) <= 16


def test_per_stream_palettes(rng):
    p = make_pipeline()
    s = p.init_state(2)
    s = p.set_palette(s, jnp.asarray([1, 2]))  # Magma vs Viridis
    chunk = jnp.asarray(
        np.tile(rng.standard_normal((1, p.chunk_size, 2)), (2, 1, 1)).astype(np.float32)
    )
    s, rgba = p.push(s, chunk)
    rgba = np.asarray(rgba)
    # identical audio, different palettes -> different colors, same alpha=255
    assert not np.array_equal(rgba[0, ..., :3], rgba[1, ..., :3])
    np.testing.assert_array_equal(rgba[..., 3], 255)  # both mono palettes


def test_silence_renders_palette_floor():
    p = make_pipeline()
    s = p.init_state(1)
    s, rgba = p.push(s, jnp.zeros((1, p.chunk_size, 2), jnp.float32))
    rgba = np.asarray(rgba)
    # silence -> -70 dB -> LUT row 0 -> magma(0) = (0,0,4)/256 scaled by 255
    expected = np.round(np.array([0, 0, 4]) / 256.0 * 255.0)
    np.testing.assert_array_equal(rgba[0, 0, 0, :3], expected)


def test_viewport_rows_rounds_to_chunk_multiple():
    p = SpectrogramPipeline(CFG, chunk_hops=5, viewport_rows=32)
    assert p.viewport_rows == 35
    assert p.viewport_rows % p.chunk_hops == 0


def test_carry_matches_stft_helper():
    p = make_pipeline()
    assert p.carry_size == stft_ops.carry_size(CFG) == CFG.window_size - CFG.hop_size


def test_push_rejects_wrong_chunk_shape(rng):
    import pytest

    p = make_pipeline()
    s = p.init_state(1)
    with pytest.raises(ValueError, match="chunk must be"):
        p.push(s, jnp.zeros((1, p.chunk_size + 1, 2), jnp.float32))
    with pytest.raises(ValueError, match="chunk must be"):
        p.push(p.init_state(1), jnp.zeros((1, p.chunk_size), jnp.float32))


def test_push_planar_matches_push(rng):
    p = make_pipeline(packed_output=True)
    chunk = rng.standard_normal((3, p.chunk_size, 2)).astype(np.float32) * 0.2
    s1 = p.init_state(3)
    s1, out1 = p.push(s1, jnp.asarray(chunk))
    s2 = p.init_state(3)
    s2, out2 = p.push_planar(s2, jnp.asarray(chunk.transpose(0, 2, 1).copy()))
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
    np.testing.assert_array_equal(np.asarray(s1.carry), np.asarray(s2.carry))
    import pytest
    with pytest.raises(ValueError, match="planar chunk"):
        p.push_planar(p.init_state(1), jnp.zeros((1, p.chunk_size, 2), jnp.float32))


def test_awkward_geometries_fall_back_cleanly(rng):
    """Advisor finding (r1): odd-n1 plans (window 225 @ 9 kHz -> n1=15) and
    pad_factor=1 configs must fall back to the XLA path in push(), matching
    process(), instead of crashing or silently mis-slicing."""
    import pytest

    odd = SpectrogramConfig(sample_rate=9000.0, window_period=0.025,
                            hop_period=0.0125, viewport_height=64,
                            viewport_rows=16, max_frequency=4000.0)
    pf1 = SpectrogramConfig(sample_rate=8000.0, window_period=0.032,
                            hop_period=0.008, pad_factor=1, viewport_height=64,
                            viewport_rows=16, max_frequency=3600.0)
    for cfg in (odd, pf1):
        p = SpectrogramPipeline(cfg, chunk_hops=2)
        assert p.fft_plan is None  # clean XLA fallback
        pcm = rng.standard_normal((2, p.chunk_size * 2, 2)).astype(np.float32) * 0.3
        s = p.init_state(2)
        emitted = []
        for i in range(2):
            s, rgba = p.push(s, jnp.asarray(pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size]))
            emitted.append(np.asarray(rgba))
        streamed = np.concatenate(emitted, axis=1)
        padded = np.concatenate([np.zeros((2, p.carry_size, 2), np.float32), pcm], axis=1)
        np.testing.assert_array_equal(streamed, np.asarray(p.process(jnp.asarray(padded))))
        # explicitly requesting the unusable backend is a loud error
        with pytest.raises(ValueError, match="stft_backend"):
            SpectrogramPipeline(cfg, stft_backend="mxu")
    with pytest.raises(ValueError, match="unknown stft_backend"):
        SpectrogramPipeline(CFG, stft_backend="pallas")


def test_sanitize_input_contains_nan(rng):
    """sanitize_input=True: one producer's NaN/Inf must not poison the
    stream's carry (and thus every later row) — non-finite samples are
    zeroed at the ingestion edge."""
    clean = make_pipeline()
    dirty = SpectrogramPipeline(CFG, chunk_hops=4, sanitize_input=True)
    pcm = rng.standard_normal((2, dirty.chunk_size, 2)).astype(np.float32) * 0.3
    bad = pcm.copy()
    bad[0, 5, 0] = np.nan
    bad[0, -1, 1] = np.inf  # lands in the carry -> poisons future pushes too
    zeroed = bad.copy()
    zeroed[~np.isfinite(zeroed)] = 0.0

    s, out = dirty.push(dirty.init_state(2), jnp.asarray(bad))
    s_ref, out_ref = clean.push(clean.init_state(2), jnp.asarray(zeroed))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out_ref))
    assert np.isfinite(np.asarray(s.carry)).all()
    # without sanitization the NaN propagates (documenting the default)
    s2, out2 = clean.push(clean.init_state(2), jnp.asarray(bad))
    assert not np.isfinite(np.asarray(s2.carry)).all()


def test_process_matches_push_with_sanitize(rng):
    """process() must honor sanitize_input exactly like push() (review
    finding: the option only guarded the streaming edge)."""
    p = SpectrogramPipeline(CFG, chunk_hops=4, sanitize_input=True)
    pcm = rng.standard_normal((1, p.chunk_size, 2)).astype(np.float32) * 0.3
    pcm[0, -1, 0] = np.nan
    s, pushed = p.push(p.init_state(1), jnp.asarray(pcm))
    padded = np.concatenate([np.zeros((1, p.carry_size, 2), np.float32), pcm], axis=1)
    oneshot = np.asarray(p.process(jnp.asarray(padded)))
    np.testing.assert_array_equal(np.asarray(pushed), oneshot)


def test_render_viewport_width_matches_gl_sampling_law(rng):
    """render_viewport(width=) must equal the GL sampler law computed
    directly: bilinear texel sampling along continuous uv.x with
    clamp-to-edge (gpu_spectrogram.rs:166-174,285; DESIGN D2), applied in
    magnitude space before the colormap."""
    p = make_pipeline()
    s = p.init_state(2)
    for _ in range(8):  # fill the ring (32 rows / k=4)
        chunk = jnp.asarray(
            rng.standard_normal((2, p.chunk_size, 2)).astype(np.float32) * 0.3
        )
        s, _ = p.push(s, chunk)
    for width in (7, 16, 32, 100):
        out = np.asarray(p.render_viewport(s, width=width))
        assert out.shape == (2, width, CFG.viewport_height, 4)
        # direct law on the ordered ring
        ring = np.asarray(s.ring).astype(np.float32)
        cur = int(s.cursor)
        ordered = np.roll(ring, -cur, axis=1)
        r = p.viewport_rows
        x = (np.arange(width) + 0.5) / width * r - 0.5
        i0 = np.floor(x).astype(int)
        w = x - i0
        lo = np.clip(i0, 0, r - 1)
        hi = np.clip(i0 + 1, 0, r - 1)
        interp = (
            ordered[:, lo] * (1.0 - w)[None, :, None, None]
            + ordered[:, hi] * w[None, :, None, None]
        ).astype(np.float32)
        want = np.asarray(p._colormap_u8(jnp.asarray(interp), s.palette_id))
        diff = np.abs(out.astype(int) - want.astype(int))
        assert diff.max() <= 1, (width, diff.max())
    # width == viewport_rows short-circuits to the identity path
    np.testing.assert_array_equal(
        np.asarray(p.render_viewport(s, width=p.viewport_rows)),
        np.asarray(p.render_viewport(s)),
    )


def test_uniform_palette_mode_matches_per_stream(rng):
    """A scalar set_palette (every stream on one palette, the reference's
    own mode) must equal the per-stream array with that palette everywhere,
    for pushes and the viewport; switching between the two stays a pure
    state update."""
    import jax

    p = SpectrogramPipeline(CFG, chunk_hops=4, packed_output=True)
    s_uni = p.set_palette(p.init_state(3), 2)
    s_per = p.set_palette(p.init_state(3), jnp.asarray([2, 2, 2]))
    np.testing.assert_array_equal(np.asarray(s_uni.palette_id), [2, 2, 2])
    for _ in range(2):
        chunk = jnp.asarray(
            rng.standard_normal((3, p.chunk_size, 2)).astype(np.float32) * 0.2
        )
        s_uni, out_u = p.push(s_uni, chunk)
        s_per, out_p = p.push(s_per, chunk)
        np.testing.assert_array_equal(np.asarray(out_u), np.asarray(out_p))
    np.testing.assert_array_equal(
        np.asarray(p.render_viewport(s_uni)),
        np.asarray(p.render_viewport(s_per)),
    )
    s_mix = p.set_palette(s_uni, jnp.asarray([0, 1, 2]))
    np.testing.assert_array_equal(np.asarray(s_mix.palette_id), [0, 1, 2])
    # a traced switch is a pure state update too
    s_back = jax.jit(p.set_palette)(s_mix, jnp.asarray(1))
    np.testing.assert_array_equal(np.asarray(s_back.palette_id), [1, 1, 1])


def test_palette_ids_validate_on_host_and_clamp_on_device(rng):
    """Host ids outside the registry raise; device ids clamp to it (the
    reference's GL sampler clamps), so an id past the end renders like the
    last palette instead of garbage."""
    import pytest

    p = make_pipeline(packed_output=True)
    lim = len(p.schemes) - 1
    with pytest.raises(ValueError, match="out of range"):
        p.set_palette(p.init_state(2), np.asarray([0, lim + 1]))
    with pytest.raises(ValueError, match="out of range"):
        p.set_palette(p.init_state(2), -1)
    chunk = rng.standard_normal((2, p.chunk_size, 2)).astype(np.float32) * 0.2
    s_dev = p.set_palette(p.init_state(2), jnp.asarray([lim + 7, -3]))
    s_ref = p.set_palette(p.init_state(2), np.asarray([lim, 0]))
    _, out_dev = p.push(s_dev, jnp.asarray(chunk))
    _, out_ref = p.push(s_ref, jnp.asarray(chunk))
    np.testing.assert_array_equal(np.asarray(out_dev), np.asarray(out_ref))


@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_push_int16_wire_matches_f32(rng, layout):
    """int16 chunks (the half-bandwidth wire format) push EXACTLY like the
    pre-scaled f32 chunks: x/32768 is exact in f32 for every int16, and
    the scale happens on device inside the jitted push."""
    p = make_pipeline(packed_output=True)
    words = rng.integers(-32768, 32768,
                         size=(3, p.chunk_size, 2)).astype(np.int16)
    f32 = words.astype(np.float32) / 32768.0
    if layout == "planar":
        push = p.push_planar
        words = words.transpose(0, 2, 1).copy()
        f32 = f32.transpose(0, 2, 1).copy()
    else:
        push = p.push
    s1, out1 = push(p.init_state(3), jnp.asarray(f32))
    s2, out2 = push(p.init_state(3), jnp.asarray(words))
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
    np.testing.assert_array_equal(np.asarray(s1.carry), np.asarray(s2.carry))
    assert s2.carry.dtype == jnp.float32
