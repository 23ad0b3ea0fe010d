"""Multi-device tests on the 8-device virtual CPU mesh: sharded push parity
with the single-device path, shard placement, and the shard_map metrics path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu.parallel import mesh as pmesh

CFG = SpectrogramConfig(
    sample_rate=8000.0,
    window_period=0.032,
    hop_period=0.008,
    viewport_height=64,
    viewport_rows=16,
)


@pytest.fixture(scope="module")
def pipeline():
    return SpectrogramPipeline(CFG, chunk_hops=4)


def test_mesh_has_eight_devices():
    m = pmesh.make_mesh()
    assert m.devices.shape == (8,)


def test_sharded_push_matches_single_device(pipeline, rng):
    m = pmesh.make_mesh()
    n_streams = 16  # 2 per device
    pcm = rng.standard_normal((n_streams, pipeline.chunk_size, 2)).astype(np.float32)

    # single-device reference
    s0 = pipeline.init_state(n_streams)
    s0, rgba_ref = pipeline.push(s0, jnp.asarray(pcm))

    # sharded
    step = pmesh.sharded_push(pipeline, m)
    s1 = pmesh.shard_state(pipeline.init_state(n_streams), m)
    chunk = jax.device_put(jnp.asarray(pcm), pmesh.chunk_sharding(m))
    s1, rgba = step(s1, chunk)

    np.testing.assert_array_equal(np.asarray(rgba), np.asarray(rgba_ref))
    assert int(s1.cursor) == int(s0.cursor)
    # ring stays sharded over streams
    shard_shapes = {tuple(sh.data.shape) for sh in s1.ring.addressable_shards}
    assert shard_shapes == {(2, pipeline.viewport_rows, 2, CFG.num_bins)}


def test_shard_map_step_psum_metrics(pipeline, rng):
    m = pmesh.make_mesh()
    n_streams = 8
    step = pmesh.shard_map_step(pipeline, m)
    s = pmesh.shard_state(pipeline.init_state(n_streams), m)
    chunk = jax.device_put(
        jnp.asarray(rng.standard_normal((n_streams, pipeline.chunk_size, 2)).astype(np.float32)),
        pmesh.chunk_sharding(m),
    )
    s, rgba, global_rows = step(s, chunk)
    # each of 8 chips contributes its local shard's rows: 1 stream x 4 hops
    assert int(global_rows) == 8 * 1 * pipeline.chunk_hops
    assert rgba.shape == (n_streams, pipeline.chunk_hops, CFG.viewport_height, 4)
    metrics = pmesh.global_metrics(s)
    assert metrics["rows_produced"] == pipeline.chunk_hops


def test_multi_push_sharded_ring_render(pipeline, rng):
    m = pmesh.make_mesh()
    step = pmesh.sharded_push(pipeline, m)
    s = pmesh.shard_state(pipeline.init_state(8), m)
    for _ in range(3):
        chunk = jax.device_put(
            jnp.asarray(rng.standard_normal((8, pipeline.chunk_size, 2)).astype(np.float32)),
            pmesh.chunk_sharding(m),
        )
        s, _ = step(s, chunk)
    viewport = pipeline.render_viewport(s)
    assert viewport.shape == (8, pipeline.viewport_rows, CFG.viewport_height, 4)


def test_sharded_push_packed_output(pipeline, rng):
    """Self-review finding: sharding specs must match the rank-3 packed
    output (the production wire format)."""
    m = pmesh.make_mesh()
    p = SpectrogramPipeline(CFG, chunk_hops=4, store_ring=False, packed_output=True)
    step = pmesh.sharded_push(p, m)
    s = pmesh.shard_state(p.init_state(8), m)
    chunk = jax.device_put(
        jnp.asarray(rng.standard_normal((8, p.chunk_size, 2)).astype(np.float32)),
        pmesh.chunk_sharding(m),
    )
    s, packed = step(s, chunk)
    assert packed.shape == (8, p.chunk_hops, CFG.viewport_height)
    assert packed.dtype == jnp.int32
    # shard_map variant too
    step2 = pmesh.shard_map_step(p, m)
    s2 = pmesh.shard_state(p.init_state(8), m)
    s2, packed2, rows = step2(s2, chunk)
    assert packed2.shape == packed.shape and int(rows) == 8 * p.chunk_hops


def test_shard_map_matches_unsharded_with_per_stream_palettes(rng):
    """shard_map over the 8-device mesh must match the unsharded push
    exactly, rows and ring, with a different palette on every stream (the
    palette ids shard with the streams)."""
    p = SpectrogramPipeline(CFG, chunk_hops=4, packed_output=True)
    m = pmesh.make_mesh()
    n_streams = 16
    ids = (np.arange(n_streams) * 5) % len(p.schemes)
    pcm = rng.standard_normal(
        (n_streams, p.chunk_size, 2)
    ).astype(np.float32) * 0.3

    s0 = p.set_palette(p.init_state(n_streams), ids)
    s0, ref = jax.jit(p.push_impl)(s0, jnp.asarray(pcm))

    step = pmesh.shard_map_step(p, m)
    st = pmesh.shard_state(p.set_palette(p.init_state(n_streams), ids), m)
    chunk = jax.device_put(jnp.asarray(pcm), pmesh.chunk_sharding(m))
    st, packed, global_rows = step(st, chunk)
    assert int(global_rows) == n_streams * 4
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(ref))
    np.testing.assert_array_equal(
        np.asarray(st.ring.astype(jnp.float32)),
        np.asarray(s0.ring.astype(jnp.float32)),
    )


def test_sharded_state_checkpoint_roundtrip(rng, tmp_path):
    """A sharded state saves through npz (gathered to host) and restores
    onto the mesh; pushes after the restore match pushes on the original."""
    from spectrogram_tpu.utils.checkpoint import load_state, save_state

    p = SpectrogramPipeline(CFG, chunk_hops=4, packed_output=True)
    m = pmesh.make_mesh()
    step = pmesh.sharded_push(p, m)
    s = pmesh.shard_state(
        p.set_palette(p.init_state(8), np.arange(8) % 3), m
    )

    def chunk():
        return jax.device_put(
            jnp.asarray(
                rng.standard_normal((8, p.chunk_size, 2)).astype(np.float32)
            ),
            pmesh.chunk_sharding(m),
        )

    s, _ = step(s, chunk())
    save_state(tmp_path / "ck", s, CFG, pipeline=p)
    r = pmesh.shard_state(load_state(tmp_path / "ck", p), m)
    c = chunk()
    _, out_s = step(s, c)
    _, out_r = step(r, c)
    np.testing.assert_array_equal(np.asarray(out_s), np.asarray(out_r))
