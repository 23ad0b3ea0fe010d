"""Worker for the multi-process distributed test (launched by
tests/test_distributed.py, one subprocess per simulated host).

Builds a process-spanning mesh over 2 processes x 4 virtual CPU devices,
runs one sharded streaming step with host-local ingest, and prints DIST_OK
with the global row count.  Not a pytest file (no test_ prefix).
"""

import sys

import numpy as np


def main() -> None:
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")

    # Initialize through the library wrapper AS THE FIRST JAX CALL — this is
    # exactly the contract production deployments rely on (regression: an
    # early guard that probed jax.process_count() initialized the backends
    # and made distributed init permanently impossible).
    from spectrogram_tpu.parallel import distributed as dist

    dist.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    dist.initialize()  # idempotent second call must be a no-op
    assert jax.process_count() == nprocs, jax.process_count()
    n_local = len(jax.local_devices())

    from spectrogram_tpu.config import SpectrogramConfig
    from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
    from spectrogram_tpu.parallel import mesh as pmesh

    cfg = SpectrogramConfig(
        sample_rate=8000.0,
        window_period=0.032,
        hop_period=0.008,
        viewport_height=128,
        viewport_rows=16,
        max_frequency=3600.0,
    )
    pipeline = SpectrogramPipeline(cfg, chunk_hops=2, packed_output=True)
    mesh = dist.global_mesh()
    n_dev = len(list(mesh.devices.flat))
    assert n_dev == nprocs * n_local, (n_dev, nprocs, n_local)
    n_streams = 2 * n_dev

    lo, hi = dist.local_stream_range(mesh, n_streams)
    assert hi - lo == n_streams // nprocs, (lo, hi)
    assert lo == pid * (n_streams // nprocs), (pid, lo)

    ingest = dist.HostShardIngest(mesh, n_streams, pipeline.chunk_size,
                                  capacity=4096)
    # Each host feeds ONLY its own shard: stream s gets a tone at a
    # stream-dependent frequency so shards are distinguishable.
    t = np.arange(pipeline.chunk_size) / cfg.sample_rate
    for local_s in range(ingest.local_streams):
        f = 200.0 * (1 + (lo + local_s) % 8)
        x = (np.sin(2 * np.pi * f * t) * 20000).astype(np.int16)
        ingest.bank.push(local_s, np.stack([x, x], axis=-1))

    step = pmesh.shard_map_step(pipeline, mesh)
    state = pmesh.sharded_init(pipeline, n_streams, mesh)
    chunk = ingest.drain()
    state, rgba, global_rows = step(state, chunk)
    jax.block_until_ready(rgba)
    assert int(global_rows) == n_streams * pipeline.chunk_hops, int(global_rows)

    # Each process sees exactly its own shard's rows.
    local_rows = [np.asarray(s.data) for s in rgba.addressable_shards]
    assert sum(r.shape[0] for r in local_rows) == hi - lo
    # Rows are non-trivial (tones above the dB floor produce varied pixels).
    assert any(len(np.unique(r)) > 4 for r in local_rows)

    m = ingest.metrics()
    assert m["dropped"] == 0, m

    # The GSPMD entry point (sharded_push) under the same process-spanning
    # mesh: a sharding bug specific to jit-with-shardings would pass the
    # shard_map step above.
    gstep = pmesh.sharded_push(pipeline, mesh)
    gstate = pmesh.sharded_init(pipeline, n_streams, mesh)
    gstate, gpacked = gstep(gstate, ingest.drain())
    jax.block_until_ready(gpacked)
    assert int(gstate.row_count) == pipeline.chunk_hops
    assert gpacked.shape == (n_streams, 2, cfg.viewport_height)

    print(f"DIST_OK pid={pid} rows={int(global_rows)} range=({lo},{hi})",
          flush=True)


if __name__ == "__main__":
    main()
