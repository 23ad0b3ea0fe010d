"""LiveSession + checkpoint tests (CPU backend)."""

import time

import numpy as np
import pytest

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu.session import LiveSession, SessionConfig
from spectrogram_tpu.utils import checkpoint


def small_session():
    return LiveSession(
        SessionConfig(
            window_period=0.016,
            hop_period=0.004,
            viewport_height=64,
            viewport_rows=32,
            chunk_hops=4,
            enable_scope=True,
            enable_analyzer=True,
        )
    )


def test_session_select_process_switch():
    sess = small_session()
    idx_synth = len(sess.registry) - 3  # sine source
    sess.select_input(idx_synth)
    assert sess.pipeline is not None
    assert sess.pipeline.cfg.sample_rate == 48000.0
    deadline = time.time() + 5.0
    rows = []
    while not rows and time.time() < deadline:
        rows = sess.process_available()
        time.sleep(0.02)
    assert rows, "no rows produced from live synthetic input"
    assert rows[0].shape == (4, 64, 4)
    vp = sess.viewport()
    assert vp.shape == (sess.pipeline.viewport_rows, 64, 4)
    # runtime palette switch requires no rebuild
    pipeline_before = sess.pipeline
    sess.set_palette("Viridis")
    assert sess.pipeline is pipeline_before
    assert int(sess.state.palette_id[0]) == 2
    # analyzer and scope advanced
    assert sess.levels is not None and float(np.max(np.asarray(sess.levels))) > 0
    assert int(sess.scope_state.cursor) >= 0
    sess.stop()


def test_checkpoint_roundtrip(tmp_path, rng):
    cfg = SpectrogramConfig(
        sample_rate=8000.0, window_period=0.032, hop_period=0.008,
        viewport_height=64, viewport_rows=16,
    )
    p = SpectrogramPipeline(cfg, chunk_hops=4)
    s = p.init_state(3, palette_id=5)
    import jax.numpy as jnp

    for _ in range(3):
        s, _ = p.push(
            s, jnp.asarray(rng.standard_normal((3, p.chunk_size, 2)).astype(np.float32))
        )
    path = tmp_path / "ckpt"
    checkpoint.save_state(path, s, cfg)
    restored = checkpoint.load_state(path, p)
    assert int(restored.cursor) == int(s.cursor)
    assert int(restored.row_count) == int(s.row_count)
    np.testing.assert_array_equal(np.asarray(restored.palette_id), [5, 5, 5])
    np.testing.assert_allclose(
        np.asarray(restored.carry), np.asarray(s.carry), atol=0
    )
    np.testing.assert_array_equal(
        np.asarray(restored.ring.astype(jnp.float32)),
        np.asarray(s.ring.astype(jnp.float32)),
    )
    # resuming works
    s2, rgba = p.push(
        restored,
        jnp.asarray(rng.standard_normal((3, p.chunk_size, 2)).astype(np.float32)),
    )
    assert int(s2.row_count) == int(s.row_count) + 4


def test_checkpoint_geometry_mismatch(tmp_path):
    cfg = SpectrogramConfig(sample_rate=8000.0, window_period=0.032)
    p = SpectrogramPipeline(cfg, chunk_hops=4, viewport_rows=16)
    s = p.init_state(1)
    checkpoint.save_state(tmp_path / "c", s, cfg)
    other = SpectrogramPipeline(
        SpectrogramConfig(sample_rate=16000.0, window_period=0.032),
        chunk_hops=4, viewport_rows=16,
    )
    with pytest.raises(ValueError):
        checkpoint.load_state(tmp_path / "c", other)


def test_checkpoint_roundtrip_sharded(tmp_path, rng):
    """Save from a sharded 8-device state, restore, re-shard, continue."""
    import jax
    import jax.numpy as jnp
    from spectrogram_tpu.parallel import mesh as pmesh

    cfg = SpectrogramConfig(
        sample_rate=8000.0, window_period=0.032, hop_period=0.008,
        viewport_height=64, viewport_rows=16,
    )
    p = SpectrogramPipeline(cfg, chunk_hops=4)
    m = pmesh.make_mesh()
    step = pmesh.sharded_push(p, m)
    s = pmesh.shard_state(p.init_state(8, palette_id=3), m)
    chunk = jax.device_put(
        jnp.asarray(rng.standard_normal((8, p.chunk_size, 2)).astype(np.float32)),
        pmesh.chunk_sharding(m),
    )
    s, _ = step(s, chunk)
    checkpoint.save_state(tmp_path / "sharded", s, cfg)

    restored = checkpoint.load_state(tmp_path / "sharded", p)
    restored = pmesh.shard_state(restored, m)
    assert len(restored.ring.addressable_shards) == 8
    restored, rgba = step(restored, chunk)
    assert int(restored.row_count) == 8
    assert rgba.shape[0] == 8


def test_session_metrics():
    sess = small_session()
    sess.select_input(len(sess.registry) - 3)
    time.sleep(0.15)
    sess.process_available(max_chunks=2)
    m = sess.metrics()
    assert "ring_dropped" in m and "latency" in m
    assert m["rows_produced"] >= 0
    sess.stop()


def test_orbax_sharded_checkpoint_roundtrip(tmp_path, rng):
    """Distributed-native checkpointing: save a mesh-sharded state with
    orbax (per-process shards, no host gather), restore onto the mesh AND
    unsharded, geometry guard raises on mismatch."""
    import jax
    import jax.numpy as jnp
    import pytest

    from spectrogram_tpu.parallel import mesh as pmesh
    from spectrogram_tpu.utils import checkpoint as ck

    cfg = SpectrogramConfig(sample_rate=8000.0, window_period=0.032,
                            hop_period=0.008, viewport_height=64,
                            viewport_rows=16)
    p = SpectrogramPipeline(cfg, chunk_hops=2)
    m = pmesh.make_mesh()
    st = pmesh.sharded_init(p, 16, m)
    chunk = jax.device_put(
        jnp.asarray(rng.standard_normal((16, p.chunk_size, 2)).astype(np.float32)),
        pmesh.chunk_sharding(m),
    )
    st, _ = pmesh.sharded_push(p, m)(st, chunk)

    ck.save_sharded(tmp_path / "ckpt", st, cfg)
    st2 = ck.load_sharded(tmp_path / "ckpt", p, mesh=m)
    flat_a = jax.tree.leaves_with_path(st._asdict())
    flat_b = jax.tree.leaves(st2._asdict())
    for (path, a), b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(
            np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32))
        )
        assert str(b.sharding.spec) == str(a.sharding.spec), path
    st3 = ck.load_sharded(tmp_path / "ckpt", p)  # unsharded restore
    np.testing.assert_array_equal(
        np.asarray(st3.carry), np.asarray(st.carry)
    )
    other = SpectrogramPipeline(
        SpectrogramConfig(sample_rate=16000.0, window_period=0.016,
                          hop_period=0.004, viewport_height=64,
                          viewport_rows=16), chunk_hops=2)
    with pytest.raises(ValueError, match="geometry"):
        ck.load_sharded(tmp_path / "ckpt", other)


def test_checkpoint_rejects_chunk_hops_mismatch(tmp_path, rng):
    """Review finding: array shapes cannot catch a chunk_hops change, but a
    misaligned restored cursor silently corrupts the ring — both loaders
    must reject it."""
    import jax.numpy as jnp
    import pytest

    from spectrogram_tpu.utils import checkpoint as ck

    cfg = SpectrogramConfig(sample_rate=8000.0, window_period=0.032,
                            hop_period=0.008, viewport_height=64,
                            viewport_rows=16)
    p2 = SpectrogramPipeline(cfg, chunk_hops=2)
    s = p2.init_state(1)
    chunk = jnp.asarray(rng.standard_normal((1, p2.chunk_size, 2)).astype(np.float32))
    s, _ = p2.push(s, chunk)            # cursor = 2
    ck.save_state(tmp_path / "c", s, cfg)
    ck.save_sharded(tmp_path / "d", s, cfg)

    p4 = SpectrogramPipeline(cfg, chunk_hops=4)  # same shapes, wrong grid
    with pytest.raises(ValueError, match="chunk_hops"):
        ck.load_state(tmp_path / "c", p4)
    with pytest.raises(ValueError, match="chunk_hops"):
        ck.load_sharded(tmp_path / "d", p4)
    # aligned restore still works
    assert int(ck.load_state(tmp_path / "c", p2).cursor) == 2


def test_checkpoint_sidecar_defeats_lucky_cursor(tmp_path, rng):
    """ADVICE r2: the modular cursor check is heuristic — a k=8 checkpoint
    whose cursor lands on a multiple of the restoring k=4 passes it.  The
    sidecar now records the saving pipeline's chunk_hops, caught directly."""
    import jax.numpy as jnp
    import pytest

    from spectrogram_tpu.utils import checkpoint as ck

    cfg = SpectrogramConfig(sample_rate=8000.0, window_period=0.032,
                            hop_period=0.008, viewport_height=64,
                            viewport_rows=16)
    p8 = SpectrogramPipeline(cfg, chunk_hops=8)
    s = p8.init_state(1)
    chunk = jnp.asarray(
        rng.standard_normal((1, p8.chunk_size, 2)).astype(np.float32))
    s, _ = p8.push(s, chunk)            # cursor = 8: multiple of 4 too
    ck.save_state(tmp_path / "c", s, cfg, pipeline=p8)

    p4 = SpectrogramPipeline(cfg, chunk_hops=4)
    assert int(s.cursor) % p4.chunk_hops == 0  # the heuristic WOULD pass
    with pytest.raises(ValueError, match="chunk_hops=8"):
        ck.load_state(tmp_path / "c", p4)
    # same-pipeline restore still works
    assert int(ck.load_state(tmp_path / "c", p8).cursor) == 8


@pytest.mark.parametrize("layout", ["transposed", "int16"])
def test_checkpoint_refuses_removed_carry_formats(tmp_path, layout):
    """Checkpoints whose carry used a sample-plane format that no longer
    exists (the [S, 2, n1, C/n1] transposed carry, int16 planes) fail with
    a clear message instead of loading garbage."""
    cfg = SpectrogramConfig(sample_rate=8000.0, window_period=0.032)
    p = SpectrogramPipeline(cfg, chunk_hops=4, viewport_rows=16)
    s = p.init_state(2)
    checkpoint.save_state(tmp_path / "c", s, cfg, pipeline=p)
    z = dict(np.load(tmp_path / "c.npz"))
    c = z["carry"]
    if layout == "transposed":
        z["carry"] = c[..., None]  # a 4-D [S, 2, n1, C/n1] carry
    else:
        z["carry"] = c.astype(np.int16)
    np.savez_compressed(tmp_path / "c.npz", **z)
    with pytest.raises(ValueError, match="no longer reads"):
        checkpoint.load_state(tmp_path / "c", p)
