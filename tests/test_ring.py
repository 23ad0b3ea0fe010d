"""Host ingest ring tests: SPSC semantics, peek/skip, counted drops,
bank batch pop, and cross-thread producer/consumer."""

import threading

import numpy as np
import pytest

from spectrogram_tpu.io import ring as ring_mod


@pytest.fixture(params=["native", "fallback"])
def ring_impl(request, monkeypatch):
    if request.param == "native":
        if not ring_mod.native_available():
            pytest.skip("native ring library unavailable")
    else:
        monkeypatch.setattr(ring_mod, "_load_library", lambda: None)
    return request.param


def frames(n, start=0):
    base = np.arange(start, start + n, dtype=np.float32)
    return np.stack([base, -base], axis=-1)


def test_push_pop_fifo(ring_impl):
    r = ring_mod.StereoRing(64)
    assert r.push(frames(10)) == 10
    assert len(r) == 10
    out = r.pop(4)
    np.testing.assert_array_equal(out, frames(4))
    out = r.pop(100)  # pops only what's there
    np.testing.assert_array_equal(out, frames(6, start=4))
    assert len(r) == 0


def test_peek_then_skip_window_semantics(ring_impl):
    """The reference's peek-window / skip-hop pattern (audio_transform.rs:34-42)."""
    r = ring_mod.StereoRing(64)
    r.push(frames(20))
    w1 = r.peek(8)
    np.testing.assert_array_equal(w1, frames(8))
    assert len(r) == 20  # peek is non-destructive
    assert r.skip(3) == 3
    w2 = r.peek(8)
    np.testing.assert_array_equal(w2, frames(8, start=3))


def test_overrun_counted_not_silent(ring_impl):
    r = ring_mod.StereoRing(8)  # rounds to 8
    assert r.capacity == 8
    accepted = r.push(frames(20))
    assert accepted == 8
    assert r.dropped == 12  # the reference drops these wordlessly; we count
    np.testing.assert_array_equal(r.pop(8), frames(8))


def test_wraparound(ring_impl):
    r = ring_mod.StereoRing(8)
    r.push(frames(6))
    r.pop(5)
    r.push(frames(6, start=100))  # wraps storage
    out = r.pop(7)
    np.testing.assert_array_equal(out[:1], frames(1, start=5))
    np.testing.assert_array_equal(out[1:], frames(6, start=100))


def test_bank_pop_matrix(ring_impl):
    b = ring_mod.RingBank(3, 64)
    b.push(0, frames(10))
    b.push(1, frames(5, start=50))
    # stream 2 left empty
    out, counts = b.pop_matrix(8)
    assert out.shape == (3, 8, 2)
    np.testing.assert_array_equal(counts, [8, 5, 0])
    np.testing.assert_array_equal(out[0], frames(8))
    np.testing.assert_array_equal(out[1, :5], frames(5, start=50))
    np.testing.assert_array_equal(out[1, 5:], 0)
    np.testing.assert_array_equal(out[2], 0)
    assert b.size(0) == 2
    assert b.min_size() == 0


def test_bank_push_matrix_and_drops(ring_impl):
    b = ring_mod.RingBank(2, 8)
    block = np.stack([frames(12), frames(12, start=100)])
    b.push_matrix(block)
    assert b.dropped_total == 2 * 4
    assert b.dropped(0) == 4
    out, counts = b.pop_matrix(8)
    np.testing.assert_array_equal(counts, [8, 8])
    np.testing.assert_array_equal(out[1], frames(8, start=100))


def test_cross_thread_producer_consumer():
    """Native path only: hammer the SPSC ring from two threads and verify no
    frame is lost or reordered (the audio-callback/UI-thread boundary)."""
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    r = ring_mod.StereoRing(1 << 12)
    total = 200_000
    received = []

    def producer():
        sent = 0
        while sent < total:
            n = min(np.random.randint(1, 512), total - sent)
            chunk = frames(n, start=sent)
            got = r.push(chunk)
            sent += got  # retry unaccepted frames

    def consumer():
        count = 0
        while count < total:
            out = r.pop(1024)
            if len(out):
                received.append(out.copy())
                count += len(out)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start(), tc.start()
    tp.join(timeout=30), tc.join(timeout=30)
    assert not tp.is_alive() and not tc.is_alive()
    all_frames = np.concatenate(received)
    assert all_frames.shape == (total, 2)
    # No frame lost, duplicated, or reordered across the thread boundary.
    np.testing.assert_array_equal(all_frames[:, 0], np.arange(total, dtype=np.float32))
    # Note: r.dropped counts offered-but-unaccepted frames; the producer
    # re-offers them, so dropped > 0 here does NOT mean data loss.


def test_validation(ring_impl):
    r = ring_mod.StereoRing(16)
    with pytest.raises(ValueError):
        r.push(np.zeros((4, 3), np.float32))
    b = ring_mod.RingBank(2, 16)
    with pytest.raises(ValueError):
        b.push_matrix(np.zeros((3, 4, 2), np.float32))


def test_bank16_roundtrip_and_conversion():
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    b = ring_mod.RingBank16(2, 64)
    pcm = (np.arange(20, dtype=np.int16).reshape(10, 2) * 1000).astype(np.int16)
    assert b.push(0, pcm) == 10
    out, counts = b.pop_matrix_f32(12)
    np.testing.assert_array_equal(counts, [10, 0])
    np.testing.assert_allclose(out[0, :10], pcm.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(out[0, 10:], 0.0)
    np.testing.assert_array_equal(out[1], 0.0)
    # overrun counted
    big = np.zeros((200, 2), np.int16)
    b.push(1, big)
    assert b.dropped_total > 0


def test_bank_pop_matrix_planar(ring_impl):
    b = ring_mod.RingBank(2, 64)
    b.push(0, frames(10))
    out, counts = b.pop_matrix_planar(8)
    assert out.shape == (2, 2, 8)
    np.testing.assert_array_equal(counts, [8, 0])
    np.testing.assert_array_equal(out[0, 0], np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(out[0, 1], -np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(out[1], 0.0)


def test_bank16_pop_planar():
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    b = ring_mod.RingBank16(1, 32)
    pcm = (np.arange(12, dtype=np.int16).reshape(6, 2) * 1000).astype(np.int16)
    b.push(0, pcm)
    out, counts = b.pop_matrix_f32_planar(6)
    assert out.shape == (1, 2, 6)
    np.testing.assert_allclose(out[0].T, pcm.astype(np.float32) / 32768.0)


def test_bank16_push_matrix_batched():
    """VERDICT r1 item 8: the int16 bank (the production ingest path) gets
    a batched producer push — per-stream ctypes calls don't scale to 10k."""
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    b = ring_mod.RingBank16(3, 64, n_threads=2)
    rng = np.random.default_rng(7)
    block = rng.integers(-30000, 30000, (3, 16, 2)).astype(np.int16)
    counts = b.push_matrix(block)
    np.testing.assert_array_equal(counts, [16, 16, 16])
    out, got = b.pop_matrix_f32(16)
    np.testing.assert_array_equal(got, [16, 16, 16])
    np.testing.assert_allclose(out, block.astype(np.float32) / 32768.0)
    # overrun on the batched path is counted and reported per stream
    big = np.zeros((3, 100, 2), np.int16)
    counts = b.push_matrix(big)
    assert (counts == 64).all() and b.dropped_total == 3 * 36
    with pytest.raises(ValueError):
        b.push_matrix(np.zeros((2, 4, 2), np.int16))


def test_bank16_push_matrix_planar():
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    b = ring_mod.RingBank16(2, 32)
    rng = np.random.default_rng(8)
    planar = rng.integers(-30000, 30000, (2, 2, 10)).astype(np.int16)
    counts = b.push_matrix_planar(planar)
    np.testing.assert_array_equal(counts, [10, 10])
    out, _ = b.pop_matrix_f32_planar(10)
    np.testing.assert_allclose(out, planar.astype(np.float32) / 32768.0)
    with pytest.raises(ValueError):
        b.push_matrix_planar(np.zeros((2, 3, 10), np.int16))


def test_bank16_push_matrix_range():
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    b = ring_mod.RingBank16(4, 32)
    blk = (np.arange(2 * 5 * 2, dtype=np.int16).reshape(2, 5, 2) * 100).astype(np.int16)
    counts = b.push_matrix_range(1, blk)      # streams 1..2
    np.testing.assert_array_equal(counts, [5, 5])
    out, got = b.pop_matrix_f32(5)
    np.testing.assert_array_equal(got, [0, 5, 5, 0])
    np.testing.assert_allclose(out[1:3], blk.astype(np.float32) / 32768.0)
    with pytest.raises(ValueError):
        b.push_matrix_range(3, blk)           # would run past the bank


def test_bank16_pop_planar_i16_raw():
    """Raw int16 planar drain (the half-bandwidth wire path): words come
    out untouched, underruns zero-pad, and the on-device 1/32768 scale
    (SpectrogramPipeline._chunk_f32) reproduces the f32 drain exactly."""
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    b = ring_mod.RingBank16(2, 32)
    pcm = (np.arange(12, dtype=np.int16).reshape(6, 2) * 1000).astype(np.int16)
    b.push(0, pcm)
    raw, counts = b.pop_matrix_i16_planar(8)
    assert raw.shape == (2, 2, 8) and raw.dtype == np.int16
    np.testing.assert_array_equal(counts, [6, 0])
    np.testing.assert_array_equal(raw[0, :, :6].T, pcm)
    np.testing.assert_array_equal(raw[0, :, 6:], 0)
    np.testing.assert_array_equal(raw[1], 0)
    # the device-side scale matches the native f32 conversion bit-for-bit
    b.push(0, pcm)
    f32, _ = b.pop_matrix_f32_planar(6)
    np.testing.assert_array_equal(
        raw[0, :, :6].astype(np.float32) * np.float32(1.0 / 32768.0),
        f32[0],
    )
    # out= rejects wrong dtype/shape
    with pytest.raises(ValueError, match="int16"):
        b.pop_matrix_i16_planar(4, out=np.zeros((2, 2, 4), np.float32))


def test_pop_planar_matches_interleaved(ring_impl):
    """The planar drain is the interleaved drain transposed per stream: an
    underrunning stream zero-pads its own row and counts by stream."""
    S, n = 5, 4

    def fill(b):
        for s in range(4):
            b.push(s, frames(n, start=100 * s))
        b.push(4, frames(1, start=400))

    b = ring_mod.RingBank(S, 32)
    fill(b)
    inter, counts_i = b.pop_matrix(n)
    fill(b)
    planar, counts_p = b.pop_matrix_planar(n)
    np.testing.assert_array_equal(counts_i, [n, n, n, n, 1])
    np.testing.assert_array_equal(counts_p, counts_i)
    np.testing.assert_array_equal(planar, inter.transpose(0, 2, 1))
    np.testing.assert_array_equal(inter[4, 1:], 0)
    np.testing.assert_array_equal(inter[2], frames(n, start=200))


def test_bank16_pop_formats_agree():
    """int16 bank drains: the f32 planar drain is the raw int16 planar drain
    scaled by 1/32768, and the f32 interleaved drain is its transpose."""
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    S, n = 4, 3
    pcm = [(np.arange(2 * n, dtype=np.int16).reshape(n, 2) + 10 * s)
           for s in range(S)]

    def fill(b):
        for s in range(S):
            b.push(s, pcm[s])

    b = ring_mod.RingBank16(S, 16)
    fill(b)
    raw, counts = b.pop_matrix_i16_planar(n)
    np.testing.assert_array_equal(counts, [n] * S)
    for s in range(S):
        np.testing.assert_array_equal(raw[s].T, pcm[s])
    fill(b)
    f32p, _ = b.pop_matrix_f32_planar(n)
    np.testing.assert_array_equal(
        f32p, raw.astype(np.float32) * np.float32(1.0 / 32768.0)
    )
    fill(b)
    f32i, _ = b.pop_matrix_f32(n)
    np.testing.assert_array_equal(f32i, f32p.transpose(0, 2, 1))
