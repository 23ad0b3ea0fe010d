"""Benchmark: spectrogram rows/s on one GPU at the 4096-point FFT geometry.

Prints the device on an earlier line and ONE JSON line last:
  {"metric": ..., "value": N, "unit": ..., ...extras}

Geometry follows BASELINE.json's metric: window 2048 @ 48 kHz, zero-padded x2
-> 4096-point FFT, hop 800 -> 60 rows/s/stream.  Chunks are int16
channels-planar, the served path's wire format, with the 19 built-in
palettes spread over the streams.

Each push is timed on the host clock up to `block_until_ready` of its state
and rows, after a warm-up that compiles; the value is the median over
BENCH_PUSHES pushes (default 50).  Refuses to run anywhere but on a GPU.

Env: BENCH_STREAMS (default 4096), BENCH_CHUNK_HOPS (1), BENCH_PUSHES (50),
     BENCH_STFT ("auto" | "mxu" | "xla").
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from spectrogram_tpu.config import BENCH_CONFIG
    from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
    from spectrogram_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"device platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}; nvidia-smi {card}", flush=True)

    n_streams = int(os.environ.get("BENCH_STREAMS", "4096"))
    chunk_hops = int(os.environ.get("BENCH_CHUNK_HOPS", "1"))
    pushes = int(os.environ.get("BENCH_PUSHES", "50"))
    cfg = BENCH_CONFIG
    pipeline = SpectrogramPipeline(
        cfg, chunk_hops=chunk_hops, store_ring=False, packed_output=True,
        stft_backend=os.environ.get("BENCH_STFT", "auto"),
    )
    rng = np.random.default_rng(0)
    chunk = jnp.asarray(rng.integers(
        -3300, 3300, (n_streams, 2, pipeline.chunk_size)).astype(np.int16))
    state = pipeline.set_palette(
        pipeline.init_state(n_streams),
        np.arange(n_streams) % len(pipeline.schemes),
    )
    for _ in range(2):  # compile + warm
        state, rows = pipeline.push_planar(state, chunk)
    jax.block_until_ready((state, rows))
    times = []
    for _ in range(pushes):
        t0 = time.perf_counter()
        state, rows = pipeline.push_planar(state, chunk)
        jax.block_until_ready((state, rows))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    rows_per_sec = n_streams * chunk_hops / dt
    print(json.dumps({
        "metric": "spectrogram_rows_per_sec",
        "value": rows_per_sec,
        "unit": f"rows/s (4096-pt FFT, STFT+colormap->RGBA, {n_streams} "
                f"streams, stft={'mxu' if pipeline.fft_plan else 'xla'})",
        "p50_ms_per_push": dt * 1e3,
        "streams": n_streams,
        "chunk_hops": chunk_hops,
        "realtime_stream_capacity": rows_per_sec / cfg.rows_per_second,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs), "nvidia_smi": card},
    }), flush=True)


if __name__ == "__main__":
    main()
