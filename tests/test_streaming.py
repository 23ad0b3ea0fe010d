"""Streaming equals one-shot: pushing a signal in chunks must give exactly
the rows `process()` gives for the whole signal, and the ring must retain
them, at every user geometry x chunk_hops x ring mode."""

import jax.numpy as jnp
import numpy as np
import pytest

import reference
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from test_portable_parity import GEOMETRIES


@pytest.mark.parametrize("store_ring", [False, True])
@pytest.mark.parametrize("chunk_hops", [1, 4, 16])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_streaming_equals_one_shot(geometry, chunk_hops, store_ring):
    cfg = GEOMETRIES[geometry]
    pushes = max(2, 16 // chunk_hops)
    p = SpectrogramPipeline(cfg, chunk_hops=chunk_hops, store_ring=store_ring,
                            viewport_rows=pushes * chunk_hops)
    n_streams = 2
    pcm = reference.chirp_and_tone(cfg, pushes * p.chunk_size, n_streams)
    st = p.init_state(n_streams)  # Magma, a mono palette
    outs = []
    for i in range(pushes):
        st, out = p.push(st, jnp.asarray(
            pcm[:, i * p.chunk_size:(i + 1) * p.chunk_size]))
        outs.append(np.asarray(out))
    streamed = np.concatenate(outs, axis=1)
    padded = np.concatenate(
        [np.zeros((n_streams, p.carry_size, 2), np.float32), pcm], axis=1)
    oneshot = np.asarray(p.process(jnp.asarray(padded)))
    # The one-shot call transforms all rows in one batch, the pushes k at a
    # time; XLA may order the f32 sums differently for the two shapes, so
    # a rare byte may round the other way (jnp.fft at k=16 on the CPU).
    assert reference.visible_diff(streamed, oneshot)[0] <= 1.0 + 1e-6
    assert np.mean(streamed != oneshot) < 1e-4
    assert int(st.row_count) == pushes * chunk_hops
    if store_ring:
        # the ring holds every row (it is exactly as long), cursor wrapped,
        # to bf16 rounding of the same rows (the atol covers the rounding
        # noise floor, ~1e-8 of full scale)
        assert int(st.cursor) == 0
        rows = np.asarray(p._stft(jnp.asarray(padded)))
        np.testing.assert_allclose(np.asarray(st.ring, np.float32), rows,
                                   rtol=2.0 ** -7, atol=1e-6 * np.abs(rows).max())
    else:
        assert st.ring.shape[1] == 0
