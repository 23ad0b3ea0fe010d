"""Production-shaped serving loop: int16 ingest -> async device feed -> packed rows.

The 10k-stream architecture end-to-end, scaled by --streams (default 512 so
it runs quickly anywhere):

  producer threads -> RingBank16 (int16 SPSC rings, counted drops)
      -> pop_matrix_f32_planar (one multithreaded drain per hop tick;
         i16->f32 conversion AND channel deinterleave fused into the copy),
         or pop_matrix_i16_planar with --wire-int16 (half the H2D bytes)
      -> push_planar via DeviceFeeder (depth-2 async dispatch)
      -> packed RGBA8888 rows out (zero-copy u8 view on host)

Run: python examples/serve.py [--streams 512] [--seconds 5] [--wire-int16]

chip_smoke.py drives the same loop at 10,240 streams and reports its
per-push time against the hop budget.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.io.feeder import ChunkPool, DeviceFeeder
from spectrogram_tpu.io.ring import RingBank16
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu.ops.colormap import unpack_rgba
from spectrogram_tpu.utils.compile_cache import enable_compile_cache
from spectrogram_tpu.utils.profiling import LatencyTracker


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument(
        "--wire-int16", action="store_true", dest="wire_int16",
        help="drain the ingest bank as RAW int16 and scale 1/32768 on "
        "device (bit-identical to the f32 drain): half the host->device "
        "bytes per push",
    )
    args = ap.parse_args()
    enable_compile_cache()

    cfg = SpectrogramConfig(
        sample_rate=48_000.0,
        window_period=2048 / 48_000.0,
        hop_period=800 / 48_000.0,  # 60 rows/s/stream
    )
    pipeline = SpectrogramPipeline(
        cfg, chunk_hops=1, store_ring=False, packed_output=True,
    )
    s = args.streams
    bank = RingBank16(s, capacity=8192)

    # Producer: one batched bank16 push per hop tick — a single native call
    # fans [S, n, 2] across all rings with counted drops (per-stream ctypes
    # pushes cost ~5 us each, ruinous at 10k streams).  Stands in for the
    # network/capture edge; tones are synthesized once per stream block.
    stop = threading.Event()

    def producer(lo: int, hi: int):
        t0 = 0
        n = cfg.hop_size
        freqs = 110.0 * (1 + np.arange(lo, hi) % 32)          # [Sblk]
        sub = np.empty((hi - lo, n, 2), np.int16)
        while not stop.is_set():
            t = (t0 + np.arange(n)) / cfg.sample_rate
            x = (np.sin(2 * np.pi * freqs[:, None] * t) * 12000).astype(np.int16)
            sub[:, :, 0] = x
            sub[:, :, 1] = x
            bank.push_matrix_range(lo, sub)
            t0 += n
            time.sleep(n / cfg.sample_rate * 0.9)

    # Copy-free drain: the bank pops straight into a rotating depth+1
    # buffer pool instead of one pinned buffer + a defensive per-push copy
    # (65 MB/push at 10k streams; ChunkPool safety contract in io/feeder.py).
    # multi-tenant: the 19 built-in palettes spread over the streams
    state0 = pipeline.set_palette(
        pipeline.init_state(s), (np.arange(s) % 19).astype(np.int32)
    )
    feeder = DeviceFeeder(
        pipeline, state0, depth=2, planar=True, copy_chunks=False,
    )
    wire = np.int16 if args.wire_int16 else np.float32
    pool = ChunkPool.for_feeder(feeder, s, dtype=wire)

    # Warm up (compile) BEFORE opening the ingest: first-compile latency
    # would otherwise overflow every ring (drops counted, but pointless).
    warm = np.zeros((s, 2, pipeline.chunk_size), wire)
    t0 = time.perf_counter()
    feeder.push(warm)
    feeder.flush()
    print(f"warmup/compile: {time.perf_counter()-t0:.1f}s", flush=True)

    threads = [
        threading.Thread(target=producer, args=(lo, min(lo + 256, s)), daemon=True)
        for lo in range(0, s, 256)
    ]
    for t in threads:
        t.start()
    tracker = LatencyTracker()
    rows_out = 0
    drains = 0
    deadline = time.time() + args.seconds
    hop_s = cfg.hop_size / cfg.sample_rate

    while time.time() < deadline:
        if bank.min_size() < pipeline.chunk_size:
            time.sleep(0.001)
            continue
        t0 = time.perf_counter()
        chunk, _ = (
            bank.pop_matrix_i16_planar(pipeline.chunk_size, pool.next())
            if args.wire_int16
            else bank.pop_matrix_f32_planar(pipeline.chunk_size, pool.next())
        )
        done = feeder.push(chunk)
        if done is not None:
            rows_out += done.shape[0] * done.shape[1]
        tracker.record(time.perf_counter() - t0)
        drains += 1

    stop.set()
    blocks = feeder.flush()
    for blk in blocks:
        rows_out += blk.shape[0] * blk.shape[1]
    print(
        f"served {rows_out} rows across {s} streams in {args.seconds:.0f}s "
        f"({rows_out / args.seconds:,.0f} rows/s incl. warmup/compile)"
    )
    print(f"hop budget {hop_s*1e3:.2f} ms; drain+dispatch {tracker.summary()}")
    print(f"dropped frames (counted, not silent): {bank.dropped_total}")
    if blocks:
        # a packed row block is [S, k, H] int32; show the wire->pixels view
        last = unpack_rgba(blocks[-1])
        print(
            f"last block unpacked: {last.shape} u8, "
            f"sample px {last[0,0,200].tolist()}"
        )


if __name__ == "__main__":
    main()
