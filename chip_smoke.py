"""On-card gate: drive the served spectrogram path on NVIDIA GPUs and check it.

    python chip_smoke.py               # one GPU: phases (a)-(e) below
    python chip_smoke.py --devices 4   # four GPUs: the stream-sharded mesh only

Phases (one GPU):
  (a) device: the default device must be a GPU; prints its kind and the
      nvidia-smi name and power limit.  Anywhere else the script exits
      non-zero before any work.
  (b) the main path at the sizes users run, each with the p50 wall time per
      push, `peak_bytes_in_use` and the compiled push's `memory_analysis()`:
      - served: 10,240 streams of the 4096-point geometry (BASELINE.json
        config 4), k=1, int16 PCM from synthetic producers through
        RingBank16 -> pop_matrix_i16_planar -> DeviceFeeder/push_planar ->
        packed rows drained to the host (the loop of examples/serve.py);
      - mixed rates: StreamGroupManager with 44.1, 48 and 96 kHz groups;
      - ring: the reference's desktop cadence (window 2400, 4800-point FFT,
        hop 58, k=16) with a retained 2048-row viewport over 1,024 streams
        (a ~20 GB bf16 ring), then `render_viewport` on a separate 16-stream
        state.
      `peak_bytes_in_use` never falls within a process, so the runs go in
      order of size and each peak reads as that run's own.
  (c) parity at real widths (4096, 4800 and 9600-point FFTs) on a chirp +
      440 Hz tone: the GPU pipeline (`mxu` and `xla`/cuFFT) against the
      plain reference (`stft_backend="xla"` on the CPU backend, every f32
      dot at HIGHEST), and GPU `mxu` against GPU `xla`; at most 1 u8.
  (d) streaming equals one-shot on the GPU (pushes vs `process()`).
  (e) the tests marked `gpu` (tests/test_gpu.py).

Any failed check raises, so the script exits non-zero; the last line of
standard output is the JSON result only when every phase passed.  The line
before it counts the persistent compile cache's hits and writes.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
if not (ROOT / "spectrogram_tpu").is_dir():
    sys.exit("chip_smoke: run from a checkout of the repository "
             "(spectrogram_tpu/ not found beside this script)")
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectrogram_tpu.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig  # noqa: E402
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline  # noqa: E402

N_PALETTES = 19
# The repo's tonal gate: 1 u8 per channel (float slack for the premultiply).
TOLERANCE_U8 = 1.0 + 1e-6
GEOMETRIES = {
    "4096": BENCH_CONFIG,
    "4800": DEFAULT_CONFIG,
    "9600": SpectrogramConfig(sample_rate=96_000.0),
}


def log(*parts) -> None:
    print("chip_smoke:", *parts, flush=True)


# ------------------------------------------------------------------ (a) device

def check_device(count: int) -> list:
    """The first `count` devices, which must be GPUs; prints the card."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found {devs[0].platform!r} "
            f"({devs[0].device_kind})"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs; JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    for line in smi.splitlines():
        log(f"nvidia-smi {line}")
    return devs[:count]


# ------------------------------------------------------------ (b) main path

def _memory_report(name: str, device, lowered) -> None:
    """Print the compiled push's memory analysis and the device's memory
    high-water mark (cumulative over the process: phases run in order)."""
    ma = lowered.compile().memory_analysis()
    if ma is not None:
        log(f"{name} memory_analysis argument={ma.argument_size_in_bytes} "
            f"output={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
            f"alias={ma.alias_size_in_bytes} "
            f"code={ma.generated_code_size_in_bytes}")
    stats = device.memory_stats() or {}
    log(f"{name} peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
        f"bytes_in_use={stats.get('bytes_in_use')}")


def _p50_ms(samples) -> float:
    return statistics.median(samples) * 1e3


def phase_served(device, n_streams: int = 10240, pushes: int = 16,
                 cfg: SpectrogramConfig = BENCH_CONFIG, trace_dir=None) -> dict:
    """The served loop of examples/serve.py: producers -> RingBank16 ->
    pop_matrix_i16_planar -> DeviceFeeder(push_planar) -> packed rows.
    `trace_dir` records a profiler trace of the timed pushes."""
    from spectrogram_tpu.io.feeder import ChunkPool, DeviceFeeder
    from spectrogram_tpu.io.ring import RingBank16

    with jax.default_device(device):
        pipeline = SpectrogramPipeline(
            cfg, chunk_hops=1, store_ring=False, packed_output=True
        )
        n = pipeline.chunk_size
        state = pipeline.set_palette(
            pipeline.init_state(n_streams), np.arange(n_streams) % N_PALETTES
        )
        bank = RingBank16(n_streams, capacity=4 * n)
        # synthetic producers: one tone per stream, one hop per tick
        t = np.arange(n) / cfg.sample_rate
        freqs = 110.0 * (1 + np.arange(n_streams) % 32)
        tone = (np.sin(2 * np.pi * freqs[:, None] * t) * 12000).astype(np.int16)
        frames = np.ascontiguousarray(np.stack([tone, tone], axis=-1))
        chunk_spec = jax.ShapeDtypeStruct((n_streams, 2, n), jnp.int16)
        feeder = DeviceFeeder(pipeline, state, depth=2, planar=True,
                              copy_chunks=False)
        pool = ChunkPool.for_feeder(feeder, n_streams, dtype=np.int16)
        times, pops, blocks = [], [], []
        for i in range(pushes + 2):  # the first two compile and prime
            if i == 2 and trace_dir is not None:
                jax.profiler.start_trace(str(trace_dir),
                                         create_perfetto_trace=True)
            bank.push_matrix(frames)
            t0 = time.perf_counter()
            chunk, _ = bank.pop_matrix_i16_planar(n, pool.next())
            t1 = time.perf_counter()
            done = feeder.push(chunk)
            if i >= 2:
                times.append(time.perf_counter() - t0)
                pops.append(t1 - t0)
            if done is not None:
                blocks.append(done)
        blocks += feeder.flush()
        if trace_dir is not None:
            jax.profiler.stop_trace()
        rows = sum(b.shape[0] * b.shape[1] for b in blocks)
        last = blocks[-1]
        if last.shape != (n_streams, 1, cfg.viewport_height):
            raise AssertionError(f"served rows shape {last.shape}")
        if len(np.unique(last[: min(n_streams, 64)])) < 8:
            raise AssertionError("served rows are flat: no spectrum reached them")
        if bank.dropped_total:
            raise AssertionError(f"served: {bank.dropped_total} frames dropped")
        out = {"streams": n_streams, "pushes": pushes, "rows": rows,
               "p50_ms": _p50_ms(times), "p50_pop_ms": _p50_ms(pops),
               "rows_per_s": n_streams / statistics.median(times),
               "budget_ms": 1e3 * n / cfg.sample_rate}
        log(f"served {out}")
        _memory_report("served", device, type(pipeline).push_planar.lower(
            pipeline, feeder.state, chunk_spec))
        return out


def phase_ring(device, n_streams: int = 1024, pushes: int = 4,
               render_streams: int = 16, viewport_rows: int = 2048,
               cfg: SpectrogramConfig = DEFAULT_CONFIG) -> dict:
    """Reference desktop cadence: k=16 pushes into a retained viewport
    ring, then render_viewport on a small separate state (the render
    copies the ring to f32, four times its bytes)."""
    with jax.default_device(device):
        pipeline = SpectrogramPipeline(
            cfg, chunk_hops=16, viewport_rows=viewport_rows, store_ring=True,
            packed_output=True,
        )
        n = pipeline.chunk_size
        words = (np.sin(np.arange(n) * 0.05)[None, None, :] * 9000
                 * (1 + np.arange(n_streams) % 3)[:, None, None])
        chunk = jnp.asarray(np.repeat(words, 2, axis=1).astype(np.int16))
        state = pipeline.set_palette(
            pipeline.init_state(n_streams), np.arange(n_streams) % N_PALETTES
        )
        ring_bytes = state.ring.size * state.ring.dtype.itemsize
        times = []
        for i in range(pushes + 1):
            t0 = time.perf_counter()
            state, out = pipeline.push_planar(state, chunk)
            jax.block_until_ready((state, out))
            if i:
                times.append(time.perf_counter() - t0)
        if int(state.row_count) != 16 * (pushes + 1):
            raise AssertionError(f"ring row_count {int(state.row_count)}")
        _memory_report("ring", device, type(pipeline).push_planar.lower(
            pipeline, state, chunk))
        del state, out
        small = pipeline.init_state(render_streams)
        for _ in range(2):
            small, _ = pipeline.push_planar(small, chunk[:render_streams])
        t0 = time.perf_counter()
        view = jax.block_until_ready(pipeline.render_viewport(small))
        render_s = time.perf_counter() - t0
        if view.shape != (render_streams, pipeline.viewport_rows,
                          cfg.viewport_height):
            raise AssertionError(f"viewport shape {view.shape}")
        out = {"streams": n_streams, "pushes": pushes,
               "p50_ms": _p50_ms(times), "ring_bytes": ring_bytes,
               "render_streams": render_streams,
               "render_s_incl_compile": render_s}
        log(f"ring {out}")
        return out


def phase_multirate(device, capacity: int = 1024, ticks: int = 6,
                    rates=(44_100.0, 48_000.0, 96_000.0)) -> dict:
    """Mixed sample rates: one geometry group per rate, each ticking at its
    own cadence through the ingest path."""
    from spectrogram_tpu.models.multirate import StreamGroupManager

    with jax.default_device(device):
        mgr = StreamGroupManager(
            group_capacity=capacity, ingest=True, wire_int16=True,
            chunk_hops=16, store_ring=False, packed_output=True,
        )
        cfgs = [SpectrogramConfig(sample_rate=r) for r in rates]
        for cfg in cfgs:
            for s in range(capacity):
                mgr.add_stream(cfg, palette_id=s % N_PALETTES)
        groups = list(mgr.groups())
        period = max(g.chunk_period for g in groups)
        done_rows = {g.cfg.sample_rate: 0 for g in groups}
        times = []
        now = 1.0
        for i in range(ticks + 2):
            for g in groups:
                t = np.arange(g.pipeline.chunk_size) / g.cfg.sample_rate
                x = (np.sin(2 * np.pi * 440.0 * t) * 8000).astype(np.int16)
                g.bank.push_matrix(np.ascontiguousarray(np.broadcast_to(
                    np.stack([x, x], -1), (capacity, x.size, 2))))
            t0 = time.perf_counter()
            out = mgr.tick(now)
            if i >= 2:
                times.append(time.perf_counter() - t0)
            for cfg, block in out.items():
                done_rows[cfg.sample_rate] += block.shape[0] * block.shape[1]
            now += period
        mgr.flush()
        for g in groups:
            lowered = type(g.pipeline).push_planar.lower(
                g.pipeline, g.state,
                jax.ShapeDtypeStruct((capacity, 2, g.pipeline.chunk_size),
                                     jnp.int16))
            _memory_report(f"multirate {g.cfg.sample_rate:.0f} Hz", device,
                           lowered)
        fft = {g.cfg.sample_rate: g.cfg.padded_size for g in groups}
        backends = {g.cfg.sample_rate: "mxu" if g.pipeline.fft_plan else "xla"
                    for g in groups}
        if min(done_rows.values()) == 0:
            raise AssertionError(f"a rate group produced no rows: {done_rows}")
        result = {"groups": len(groups), "streams_per_group": capacity,
                  "p50_tick_ms": _p50_ms(times), "rows": done_rows,
                  "fft": fft, "stft": backends}
        log(f"multirate {result}")
        return result


# ----------------------------------------------------------- (c) parity

def chirp_and_tone(cfg: SpectrogramConfig, n_samples: int, n_streams: int):
    """[S, T, 2] f32: an exponential chirp on the left channel, a 440 Hz
    tone on the right (tonal content exposes FFT precision loss that noise
    hides)."""
    fs = cfg.sample_rate
    t = np.arange(n_samples) / fs
    f0, f1, dur = 100.0, 0.4 * fs, n_samples / fs
    k = np.log(f1 / f0) / dur
    left = 0.5 * np.sin(2 * np.pi * f0 * (np.exp(k * t) - 1.0) / k)
    right = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    x = np.stack([left, right], axis=-1).astype(np.float32)
    return np.broadcast_to(x, (n_streams,) + x.shape).copy()


def _stream_rows(pipeline, pcm, ids):
    """Push `pcm` [S, T, 2] through `pipeline` in chunks; packed rows as u8."""
    st = pipeline.set_palette(pipeline.init_state(pcm.shape[0]), ids)
    outs = []
    for i in range(pcm.shape[1] // pipeline.chunk_size):
        c = pcm[:, i * pipeline.chunk_size:(i + 1) * pipeline.chunk_size]
        st, o = pipeline.push(st, jnp.asarray(c))
        outs.append(np.asarray(o))
    rows = np.concatenate(outs, axis=1)
    return rows.view(np.uint8).reshape(*rows.shape, 4)


def _visible_diff():
    sys.path.insert(0, str(ROOT / "tests"))
    from reference import visible_diff

    return visible_diff


def phase_parity(device, cpu, n_streams: int = 4, pushes: int = 3,
                 chunk_hops: int = 16, geometries=None) -> dict:
    """GPU mxu and GPU xla against the CPU reference, and against each
    other, at real widths: at most 1 u8 per RGBA channel, RGB premultiplied
    by alpha (tests/reference.py `visible_diff`)."""
    diff = _visible_diff()
    results = {}
    for name, cfg in (geometries or GEOMETRIES).items():
        ids = np.arange(n_streams) * 7 % N_PALETTES
        kw = dict(chunk_hops=chunk_hops, store_ring=False, packed_output=True)
        pcm = chirp_and_tone(cfg, pushes * chunk_hops * cfg.hop_size, n_streams)
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            ref = _stream_rows(SpectrogramPipeline(cfg, stft_backend="xla", **kw),
                               pcm, ids)
        with jax.default_device(device):
            mxu = _stream_rows(SpectrogramPipeline(cfg, stft_backend="mxu", **kw),
                               pcm, ids)
            xla = _stream_rows(SpectrogramPipeline(cfg, stft_backend="xla", **kw),
                               pcm, ids)
        r = {"mxu_vs_ref": diff(mxu, ref), "xla_vs_ref": diff(xla, ref),
             "mxu_vs_xla": diff(mxu, xla)}
        log(f"parity {name}-point: " + ", ".join(
            f"{k} max={v[0]:.3f} mean={v[1]:.6f}" for k, v in r.items()))
        worst = max(v[0] for v in r.values())
        if worst > TOLERANCE_U8:
            raise AssertionError(f"parity {name}: max |diff| {worst} u8 > 1")
        results[name] = r
    return results


# ------------------------------------------------- (d) streaming = one-shot

def phase_streaming(device, n_streams: int = 4, pushes: int = 3,
                    chunk_hops: int = 16, geometries=None) -> dict:
    """Rows from chunked pushes vs `process()` of the whole signal."""
    diff = _visible_diff()
    results = {}
    with jax.default_device(device):
        for name, cfg in (geometries or GEOMETRIES).items():
            p = SpectrogramPipeline(cfg, chunk_hops=chunk_hops, store_ring=False)
            pcm = chirp_and_tone(cfg, pushes * p.chunk_size, n_streams)
            st = p.init_state(n_streams)
            outs = []
            for i in range(pushes):
                st, o = p.push(st, jnp.asarray(
                    pcm[:, i * p.chunk_size:(i + 1) * p.chunk_size]))
                outs.append(np.asarray(o))
            streamed = np.concatenate(outs, axis=1)
            padded = np.concatenate(
                [np.zeros((n_streams, p.carry_size, 2), np.float32), pcm], 1)
            oneshot = np.asarray(jax.jit(p.process)(jnp.asarray(padded)))
            if oneshot.shape != streamed.shape:
                raise AssertionError(f"{name}: {oneshot.shape} vs {streamed.shape}")
            exact = bool(np.array_equal(streamed, oneshot))
            mx, mean = diff(streamed, oneshot)
            log(f"streaming {name}-point: exact={exact} max={mx:.3f} "
                f"mean={mean:.6f}")
            if mx > TOLERANCE_U8:
                raise AssertionError(f"streaming {name}: max |diff| {mx} u8 > 1")
            results[name] = (exact, mx, mean)
    return results


# ------------------------------------------------------ (e) tests on card

def phase_gpu_tests(device) -> int:
    """Run the `gpu`-marked tests of tests/test_gpu.py in this process."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_gpu

    n_run = 0
    for name in (n for n in dir(test_gpu) if n.startswith("test_")):
        fn = getattr(test_gpu, name)
        cases = [{}]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name == "parametrize":
                arg, values = mark.args[0], mark.args[1]
                cases = [dict(c, **{arg: v}) for c in cases for v in values]
        for kw in cases:
            fn(device, **kw)
            n_run += 1
            log(f"gpu test {name}{kw or ''} passed")
    return n_run


# ------------------------------------------------------- four-device mesh

def phase_mesh(devices, per_device: int = 10240, pushes: int = 3,
               cfg: SpectrogramConfig = BENCH_CONFIG) -> dict:
    """`sharded_push` over a 1-D mesh of `devices`: shards must sit on
    distinct devices, and rows must equal pushing each device's slice
    alone on that device, bit for bit."""
    from spectrogram_tpu.parallel import mesh as pmesh

    n_dev = len(devices)
    s = per_device * n_dev
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True)
    pipeline = SpectrogramPipeline(cfg, **kw)
    n = pipeline.chunk_size
    ids = np.arange(s) % N_PALETTES
    rng = np.random.default_rng(0)
    chunks = [rng.integers(-12000, 12000, (s, n, 2)).astype(np.int16)
              for _ in range(pushes)]
    mesh = pmesh.make_mesh(devices=devices)
    step = pmesh.sharded_push(pipeline, mesh)
    state = pmesh.shard_state(pipeline.set_palette(pipeline.init_state(s), ids),
                              mesh)
    rows, times = [], []
    for c in chunks:
        chunk = jax.device_put(c, pmesh.chunk_sharding(mesh))
        t0 = time.perf_counter()
        state, out = step(state, chunk)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
        for arr, what in ((state.carry, "state"), (chunk, "chunk"), (out, "rows")):
            placed = {sh.device.id for sh in arr.addressable_shards}
            if len(placed) != n_dev:
                raise AssertionError(f"{what} shards on devices {placed}")
        rows.append(np.asarray(out))
    log(f"mesh shards on devices {sorted(sh.device.id for sh in out.addressable_shards)}")
    for d, dev in enumerate(devices):
        sl = slice(d * per_device, (d + 1) * per_device)
        with jax.default_device(dev):
            alone = SpectrogramPipeline(cfg, **kw)
            st = alone.set_palette(alone.init_state(per_device), ids[sl])
            for i, c in enumerate(chunks):
                st, o = alone.push(st, jnp.asarray(c[sl]))
                if not np.array_equal(np.asarray(o), rows[i][sl]):
                    raise AssertionError(
                        f"device {d} push {i}: sharded rows differ from the "
                        f"slice pushed alone")
    result = {"devices": n_dev, "streams": s, "pushes": pushes,
              "p50_ms_incl_first": _p50_ms(times), "bitwise": True}
    log(f"mesh {result}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 = run only the four-GPU stream-sharded mesh phase")
    args = ap.parse_args(argv)

    from spectrogram_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache {enable_compile_cache()}")
    cache_events = collections.Counter()

    def count_cache_event(event: str, **_) -> None:
        if event in ("/jax/compilation_cache/cache_hits",
                     "/jax/compilation_cache/cache_misses"):
            cache_events[event.rsplit("_", 1)[1]] += 1

    jax.monitoring.register_event_listener(count_cache_event)
    devs = check_device(args.devices)
    t_start = time.perf_counter()
    if args.devices == 4:
        phase_mesh(devs)
    else:
        dev = devs[0]
        cpu = jax.devices("cpu")[0]
        phase_served(dev)
        phase_multirate(dev)
        phase_ring(dev)
        phase_parity(dev, cpu)
        phase_streaming(dev)
        phase_gpu_tests(dev)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"compile cache hits={cache_events['hits']} "
        f"writes={cache_events['misses']}")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
