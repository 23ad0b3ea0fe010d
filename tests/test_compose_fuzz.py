"""Feature-composition fuzz: random combinations of the pipeline's options
and inputs — STFT backend, chunk_hops, ring storage, packed output, input
sanitizing, wire format (f32 / planar / int16), palette layouts (scalar /
clustered / alternating / wild) and mid-stream set_palette transitions —
must push BITWISE the bytes of the plain pipeline (same backend and
geometry, f32 interleaved chunks, per-stream palette arrays, u8 rows).

The targeted tests pin each feature; this sweep is the backstop for the
compositions nobody wrote down."""

import numpy as np
import jax.numpy as jnp
import pytest

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu.ops.colormap import unpack_rgba

CFG = SpectrogramConfig(
    sample_rate=8000.0,
    window_period=0.032,   # W = 256, padded 512
    hop_period=0.008,      # hop = 64
    viewport_height=64,
    viewport_rows=16,
)

def _layout(rng, s, n_schemes):
    kind = rng.choice(["scalar", "clustered", "alternating", "wild"])
    if kind == "scalar":
        return int(rng.integers(0, n_schemes))
    if kind == "clustered":
        return (np.arange(s) // max(s // 4, 1) % n_schemes).astype(np.int32)
    if kind == "alternating":
        return (np.arange(s) % int(rng.integers(2, 4))).astype(np.int32)
    return rng.integers(0, n_schemes, size=s).astype(np.int32)


def _as_ref_ids(ids, s):
    # the reference pipeline always takes a per-stream array
    return np.full(s, ids, np.int32) if np.ndim(ids) == 0 else ids


@pytest.mark.parametrize("seed", range(10))
def test_random_feature_composition_bitwise(seed):
    rng = np.random.default_rng(7000 + seed)
    s = int(rng.choice([3, 8, 16]))
    k = int(rng.choice([1, 2, 4]))
    store_ring = bool(rng.choice([False, True]))
    backend = str(rng.choice(["mxu", "xla"]))
    packed = bool(rng.choice([False, True]))
    sanitize = bool(rng.choice([False, True]))
    wire = rng.choice(["f32", "planar", "int16"])

    common = dict(chunk_hops=k, store_ring=store_ring, stft_backend=backend)
    p = SpectrogramPipeline(CFG, packed_output=packed,
                            sanitize_input=sanitize, **common)
    p_ref = SpectrogramPipeline(CFG, **common)
    n_schemes = len(p.schemes)

    ids = _layout(rng, s, n_schemes)
    st = p.set_palette(p.init_state(s), ids)
    st_ref = p_ref.set_palette(p_ref.init_state(s), _as_ref_ids(ids, s))

    def one_push(st, st_ref):
        pcm16 = rng.integers(-20000, 20000,
                             size=(s, p.chunk_size, 2)).astype(np.int16)
        pcm = pcm16.astype(np.float32) / 32768.0  # exact in f32
        if wire == "planar":
            st, o = p.push_planar(st, jnp.swapaxes(jnp.asarray(pcm), 1, 2))
        elif wire == "int16":
            st, o = p.push(st, jnp.asarray(pcm16))
        else:
            st, o = p.push(st, jnp.asarray(pcm))
        st_ref, o_ref = p_ref.push(st_ref, jnp.asarray(pcm))
        o = np.asarray(o)
        if packed:
            o = unpack_rgba(o)
        np.testing.assert_array_equal(o, np.asarray(o_ref))
        return st, st_ref

    for _ in range(2):
        st, st_ref = one_push(st, st_ref)

    # mid-stream palette transition to an unrelated random layout class
    ids2 = _layout(rng, s, n_schemes)
    st = p.set_palette(st, ids2)
    st_ref = p_ref.set_palette(st_ref, _as_ref_ids(ids2, s))
    st, st_ref = one_push(st, st_ref)

    np.testing.assert_array_equal(np.asarray(st.carry), np.asarray(st_ref.carry))
    if store_ring:
        vp = np.asarray(p.render_viewport(st))
        np.testing.assert_array_equal(
            unpack_rgba(vp) if packed else vp,
            np.asarray(p_ref.render_viewport(st_ref)),
        )
