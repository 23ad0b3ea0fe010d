"""CLI app shell: render, live-stream, inspect.

The host-side equivalent of the reference's app layer (src/main.rs): where
the Rust builds a GTK window with device/palette dropdowns and a GL
visualizer, this framework's surface is a CLI + Python API — inputs are
selected from the same kind of registry, palettes from the same 19-scheme
list, and output goes to PNG files (or a terminal live view) instead of a
GLArea.

    python -m spectrogram_tpu.app render input.wav out.png --palette Viridis
    python -m spectrogram_tpu.app render --source chirp out.png
    python -m spectrogram_tpu.app live --seconds 3 out.png   # streaming loop
    python -m spectrogram_tpu.app palettes                   # list schemes
    python -m spectrogram_tpu.app inputs                     # list devices
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _build_source(args, sample_rate):
    from spectrogram_tpu.io import sources

    if args.source == "file":
        src = sources.WavSource(args.input)
        return src, src.sample_rate
    if args.source == "chirp":
        return sources.ChirpSource(sample_rate), sample_rate
    if args.source == "sine":
        return sources.SineSource(sample_rate, args.freq, args.freq * 1.5), sample_rate
    if args.source == "noise":
        return sources.NoiseSource(), sample_rate
    raise SystemExit(f"unknown source {args.source}")


def cmd_render(args) -> int:
    import jax.numpy as jnp

    from spectrogram_tpu.color.colorscheme import scheme_index
    from spectrogram_tpu.config import SpectrogramConfig
    from spectrogram_tpu.models.golden import GoldenSpectrogram
    from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
    from spectrogram_tpu.utils.image import save_png

    source, rate = _build_source(args, args.sample_rate)
    cfg = SpectrogramConfig(
        sample_rate=rate,
        window_period=args.window,
        hop_period=args.hop,
        viewport_height=args.height,
    )
    if args.source == "file":
        pcm = source.read_all()
    else:
        pcm = source.next_block(int(args.seconds * rate))
    pid = scheme_index(args.palette)

    if args.golden:
        from spectrogram_tpu.color.colorscheme import DEFAULT_COLOR_SCHEMES

        g = GoldenSpectrogram(cfg, scheme=DEFAULT_COLOR_SCHEMES[pid])
        rgba = g.render(pcm)
        rgb = g.composite(rgba)
    else:
        pipeline = SpectrogramPipeline(cfg, store_ring=False)
        rgba = pipeline.process(jnp.asarray(pcm), palette_id=pid)
        rgb = np.asarray(
            pipeline.composite(rgba[None], jnp.asarray([pid]))
        )[0]
    save_png(args.output, rgb)
    print(f"wrote {args.output}: {rgb.shape[0]} rows x {rgb.shape[1]} px "
          f"({cfg.rows_per_second:.1f} rows/s geometry, palette {args.palette})")
    return 0


def cmd_live(args) -> int:
    """Streaming loop: source -> host ring -> batched pipeline -> PNG.

    The CLI face of the full production path (ring ingest, chunked pushes,
    latency tracking); writes the final viewport as an image.

    With --view, the terminal viewer shows the BATCH live: a tiled grid of
    per-stream scrolling spectrograms (t toggles single/tiled, [ ] move
    focus), per-stream palette hotkeys (p/P cycle the focused stream only),
    and the secondary visualizers live (o oscilloscope, a analyzer — the
    reference renders these per vsync, oscilloscope.rs:169-257,
    spectrum_analyzer.rs:48-69).  --multirate runs two geometry groups at
    their own hop cadences through StreamGroupManager.tick.
    """
    import jax
    import jax.numpy as jnp

    from spectrogram_tpu.color.colorscheme import scheme_index
    from spectrogram_tpu.config import SpectrogramConfig
    from spectrogram_tpu.io.registry import StreamBatch
    from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
    from spectrogram_tpu.utils.image import save_png
    from spectrogram_tpu.utils.profiling import LatencyTracker

    if args.view and args.multirate:
        return _live_view_multirate(args)

    rate = args.sample_rate
    cfg = SpectrogramConfig(
        sample_rate=rate,
        window_period=args.window,
        hop_period=args.hop,
        viewport_height=args.height,
    )
    pipeline = SpectrogramPipeline(cfg, chunk_hops=args.chunk_hops)
    pid = scheme_index(args.palette)
    batch = StreamBatch(args.streams, ring_capacity=1 << 16)

    from spectrogram_tpu.io import sources

    def attach(kind: str) -> None:
        batch.attach_all(
            lambda s: sources.ChirpSource(rate, f0=100.0 * (1 + s % 4))
            if kind == "chirp"
            else sources.SineSource(rate, 220.0 * (1 + s % 8), 330.0)
            if kind == "sine"
            else sources.NoiseSource()
        )

    attach(args.source)

    state = pipeline.init_state(args.streams, palette_id=pid)
    tracker = LatencyTracker()
    total_rows = 0
    t_end = time.time() + args.seconds

    if args.view:
        from spectrogram_tpu.color.colorscheme import DEFAULT_COLOR_SCHEMES
        from spectrogram_tpu.models.oscilloscope import Oscilloscope
        from spectrogram_tpu.models.spectrum_analyzer import SpectrumAnalyzer
        from spectrogram_tpu.utils.liveview import StreamScroller, tile_grid
        from spectrogram_tpu.utils.terminal import TerminalViewer

        source_kinds = ["chirp", "sine", "noise"]
        src_i = source_kinds.index(args.source) if args.source in source_kinds else 0
        frame_period = 1.0 / args.fps
        scheme_of = lambda s: pipeline.schemes[int(state.palette_id[s])]
        scope = Oscilloscope(pipeline.chunk_size)
        scope_state = scope.init_state(args.streams)
        analyzer = SpectrumAnalyzer(cfg)
        levels = analyzer.init_levels(args.streams)
        k = pipeline.chunk_hops
        mode, tiled, focus = "spect", args.streams > 1, 0
        with TerminalViewer() as tv:
            frame_h, frame_w = tv.rows * 2, tv.cols
            scroller = StreamScroller(args.streams, frame_h, frame_w)
            next_frame = time.time()
            while time.time() < t_end:
                batch.tick(pipeline.chunk_size)
                while batch.ready_chunks(pipeline.chunk_size) > 0:
                    chunk, _ = batch.pop_chunk(pipeline.chunk_size)
                    chunk = jnp.asarray(chunk)
                    with tracker.measure():
                        state, rgba = pipeline.push(state, chunk)
                        rgb_rows = np.asarray(
                            pipeline.composite(rgba, state.palette_id)
                        )                                      # [S, k, H, 3]
                    scroller.push(rgb_rows)
                    scope_state = scope.push(scope_state, chunk)
                    total_rows += args.streams * k
                for key in tv.keys():
                    if key in ("q", "\x03"):
                        t_end = 0.0
                    elif key in ("p", "P"):  # palette cycle, FOCUSED stream
                        step = 1 if key == "p" else -1
                        new = (int(state.palette_id[focus]) + step) % len(
                            pipeline.schemes
                        )
                        state = pipeline.set_palette(
                            state, state.palette_id.at[focus].set(new)
                        )
                    elif key == "s":  # source cycle mid-run
                        src_i = (src_i + 1) % len(source_kinds)
                        attach(source_kinds[src_i])
                    elif key == "t":
                        tiled = not tiled
                    elif key in ("[", "]"):
                        focus = (focus + (1 if key == "]" else -1)) % args.streams
                    elif key in ("o", "a", "g"):
                        mode = {"o": "scope", "a": "bars", "g": "spect"}[key]
                if time.time() >= next_frame:
                    if mode == "scope":
                        env = np.asarray(scope.envelope(scope_state, 1024))
                        img = scope.rasterize(env[focus], frame_h, scheme_of(focus))
                    elif mode == "bars":
                        # feed the analyzer the freshest k rows from the ring
                        # at frame cadence (its decay law is per-row; the
                        # frame-cadence feed is the live-demo approximation)
                        start = (int(state.cursor) - k) % pipeline.viewport_rows
                        latest = jax.lax.dynamic_slice(
                            state.ring,
                            (0, start, 0, 0),
                            (args.streams, k, 2, cfg.num_bins),
                        ).astype(jnp.float32)
                        levels = analyzer.push_rows(
                            levels, jnp.swapaxes(latest, 2, 3)
                        )
                        img = analyzer.rasterize_levels(
                            np.asarray(levels[focus]), frame_h, scheme_of(focus)
                        )
                    elif tiled:
                        img = tile_grid(
                            [scroller.image(s) for s in range(args.streams)],
                            frame_h, frame_w, highlight=focus,
                        )
                    else:
                        img = scroller.image(focus)
                    tv.draw(
                        img,
                        status=(
                            f"[{focus}] {scheme_of(focus).name}  "
                            f"src {source_kinds[src_i]}  {total_rows} rows  "
                            f"p/P palette  [ ] focus  t tile  g/o/a view  q quit"
                        ),
                    )
                    next_frame = time.time() + frame_period
                time.sleep(0.001)
    else:
        while time.time() < t_end:
            batch.tick(pipeline.chunk_size)
            while batch.ready_chunks(pipeline.chunk_size) > 0:
                chunk, _ = batch.pop_chunk(pipeline.chunk_size)
                with tracker.measure():
                    state, rgba = pipeline.push(state, jnp.asarray(chunk))
                    np.asarray(rgba[0, 0, 0])
                total_rows += args.streams * pipeline.chunk_hops
    viewport = np.asarray(
        pipeline.render_viewport(state, width=args.render_width)
    )[0]
    rgb = np.asarray(pipeline.composite(viewport[None][None], state.palette_id[:1]))
    save_png(args.output, np.asarray(rgb)[0, 0])
    print(
        f"streamed {total_rows} rows across {args.streams} streams; "
        f"latency {tracker.summary()}; dropped {batch.dropped_total} frames; "
        f"wrote {args.output}"
    )
    return 0


def _live_view_multirate(args) -> int:
    """Live view over TWO geometry groups advancing at their own cadences
    (VERDICT r2 item 6): streams split between the CLI geometry and a second
    rate, each group a lockstep batch behind its own RingBank16 + feeder,
    `StreamGroupManager.tick(now)` firing pushes per group clock.  The tiled
    frame mixes streams of both geometries; p/P recolors the focused stream
    via the manager (per-stream palette, cross-group)."""
    import numpy as np

    from spectrogram_tpu.color.colorscheme import scheme_index
    from spectrogram_tpu.config import SpectrogramConfig
    from spectrogram_tpu.io import sources
    from spectrogram_tpu.models.multirate import StreamGroupManager
    from spectrogram_tpu.utils.image import save_png
    from spectrogram_tpu.utils.liveview import StreamScroller, tile_grid
    from spectrogram_tpu.utils.terminal import TerminalViewer

    if args.streams < 2:
        raise SystemExit("--multirate needs --streams >= 2 (two groups)")
    cfg_a = SpectrogramConfig(
        sample_rate=args.sample_rate,
        window_period=args.window,
        hop_period=args.hop,
        viewport_height=args.height,
    )
    # second group: same periods at 2/3 the rate (32 kHz against the default
    # 48 kHz -> different window/hop sample counts, its own pipeline + cadence)
    cfg_b = SpectrogramConfig(
        sample_rate=args.sample_rate * 2.0 / 3.0,
        window_period=args.window,
        hop_period=args.hop,
        viewport_height=args.height,
    )
    n_a = (args.streams + 1) // 2
    cap = max(n_a, args.streams - n_a)
    mgr = StreamGroupManager(
        group_capacity=cap, ingest=True, chunk_hops=args.chunk_hops
    )
    pid = scheme_index(args.palette)
    ids, srcs = [], {}
    for s in range(args.streams):
        cfg = cfg_a if s < n_a else cfg_b
        sid = mgr.add_stream(cfg, palette_id=pid)
        ids.append(sid)
        srcs[sid] = sources.ChirpSource(cfg.sample_rate, f0=100.0 * (1 + s % 4))

    scrollers: dict = {}
    total_rows = 0
    t_end = time.time() + args.seconds
    frame_period = 1.0 / args.fps
    focus = 0

    def scheme_name(i: int) -> str:
        cfg, slot = mgr.location(ids[i])
        g = mgr._groups[cfg]
        return g.pipeline.schemes[int(g.state.palette_id[slot])].name

    with TerminalViewer() as tv:
        frame_h, frame_w = tv.rows * 2, tv.cols
        next_frame = time.time()
        # Per-source cumulative sample clocks: n = int(elapsed * rate) -
        # produced keeps truncation error bounded at < 1 sample forever (a
        # per-iteration int((now-last)*rate) drops a fraction every loop and
        # starves the slower group into zero-filled silence).
        t_start = time.time()
        produced = {sid: 0 for sid in srcs}
        while time.time() < t_end:
            now = time.time()
            elapsed = now - t_start
            for sid, src in srcs.items():
                cfg, _ = mgr.location(sid)
                n = int(elapsed * cfg.sample_rate) - produced[sid]
                if n:
                    produced[sid] += n
                    pcm = src.next_block(n)
                    mgr.push_pcm(
                        sid, (np.clip(pcm, -1, 1) * 32767.0).astype(np.int16)
                    )
            done = mgr.tick(now)
            for cfg, rgba in done.items():
                g = mgr._groups[cfg]
                rgb = np.asarray(g.pipeline.composite(rgba, g.state.palette_id))
                sc = scrollers.get(cfg)
                if sc is None:
                    sc = scrollers[cfg] = StreamScroller(
                        rgb.shape[0], frame_h, frame_w
                    )
                sc.push(rgb)
                total_rows += g.n_streams * g.pipeline.chunk_hops
            for key in tv.keys():
                if key in ("q", "\x03"):
                    t_end = 0.0
                elif key in ("p", "P"):
                    cfg, slot = mgr.location(ids[focus])
                    g = mgr._groups[cfg]
                    step = 1 if key == "p" else -1
                    new = (int(g.state.palette_id[slot]) + step) % len(
                        g.pipeline.schemes
                    )
                    mgr.set_palette(ids[focus], new)
                elif key in ("[", "]"):
                    focus = (focus + (1 if key == "]" else -1)) % args.streams
            if now >= next_frame:
                imgs = []
                for i, sid in enumerate(ids):
                    cfg, slot = mgr.location(sid)
                    sc = scrollers.get(cfg)
                    imgs.append(
                        sc.image(slot)
                        if sc is not None
                        else np.zeros((8, 8, 3), np.uint8)
                    )
                img = tile_grid(imgs, frame_h, frame_w, highlight=focus)
                m = mgr.metrics()
                tv.draw(
                    img,
                    status=(
                        f"[{focus}] {scheme_name(focus)}  "
                        f"{m['groups']} groups  {total_rows} rows  "
                        f"p/P palette  [ ] focus  q quit"
                    ),
                )
                next_frame = now + frame_period
            time.sleep(0.001)
    mgr.flush()
    # final frame: the focused stream's group viewport
    cfg, slot = mgr.location(ids[focus])
    g = mgr._groups[cfg]
    vp = g.pipeline.render_viewport(g.state)[slot]
    rgb = np.asarray(
        g.pipeline.composite(vp[None], g.state.palette_id[slot : slot + 1])
    )[0]
    save_png(args.output, rgb)
    m = mgr.metrics()
    print(
        f"multirate live: {m['groups']} groups, {m['streams']} streams, "
        f"{total_rows} rows, dropped {m.get('dropped')}; wrote {args.output}"
    )
    return 0


def cmd_bench(args) -> int:
    import os

    if args.streams:
        os.environ["BENCH_STREAMS"] = str(args.streams)
    import bench  # repo-root bench.py when run from a checkout

    bench.main()
    return 0


def cmd_palettes(_args) -> int:
    from spectrogram_tpu.color.colorscheme import DEFAULT_COLOR_SCHEMES

    for i, s in enumerate(DEFAULT_COLOR_SCHEMES):
        kind = "stereo" if s.is_stereo else "mono"
        print(f"{i:2d}  {s.name:32s} [{kind}]  bg={s.background_color()}")
    return 0


def cmd_inputs(_args) -> int:
    from spectrogram_tpu.io.registry import InputRegistry

    reg = InputRegistry()
    for i, d in enumerate(reg.inputs):
        print(f"{i:2d}  {d.name:40s} [{d.kind}] {d.sample_rate:.0f} Hz")
    return 0


def _positive_float(text: str) -> float:
    value = float(text)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"must be > 0, got {text}")
    return value


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="spectrogram_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--palette", default="Magma")
        p.add_argument("--sample-rate", type=float, default=48_000.0, dest="sample_rate")
        p.add_argument("--window", type=float, default=0.05)
        p.add_argument("--hop", type=float, default=2.5 / 2048.0)
        p.add_argument("--height", type=int, default=1024)

    p_render = sub.add_parser("render", help="render PCM to a spectrogram PNG")
    p_render.add_argument("input", nargs="?", help="WAV file (with --source file)")
    p_render.add_argument("output")
    p_render.add_argument(
        "--source", default="file", choices=["file", "chirp", "sine", "noise"]
    )
    p_render.add_argument("--seconds", type=float, default=3.0)
    p_render.add_argument("--freq", type=float, default=440.0)
    p_render.add_argument(
        "--golden", action="store_true", help="use the CPU-path golden law"
    )
    common(p_render)
    p_render.set_defaults(fn=cmd_render)

    p_live = sub.add_parser("live", help="run the streaming pipeline")
    p_live.add_argument("output")
    p_live.add_argument(
        "--source", default="chirp", choices=["chirp", "sine", "noise"]
    )
    p_live.add_argument("--seconds", type=float, default=2.0)
    p_live.add_argument("--streams", type=int, default=4)
    p_live.add_argument("--chunk-hops", type=int, default=8, dest="chunk_hops")
    p_live.add_argument(
        "--view", action="store_true",
        help="live ANSI terminal viewer (p/P palette of the focused stream, "
             "[ ] focus, t tiled grid, g/o/a spectrogram/scope/analyzer, "
             "s source, q quit)",
    )
    p_live.add_argument(
        "--multirate", action="store_true",
        help="with --view: split streams across two sample-rate groups, "
             "each advancing at its own hop cadence (StreamGroupManager)",
    )
    p_live.add_argument("--fps", type=_positive_float, default=20.0)
    p_live.add_argument(
        "--render-width", type=int, default=None, dest="render_width",
        help="time-axis width (px) of the final viewport PNG: device-side "
             "bilinear rescale matching the GL sampler law "
             "(gpu_spectrogram.rs:166-174; any widget size renders the "
             "whole ring)",
    )
    common(p_live)
    p_live.set_defaults(fn=cmd_live)

    sub.add_parser("palettes", help="list color schemes").set_defaults(fn=cmd_palettes)
    sub.add_parser("inputs", help="list input devices/sources").set_defaults(fn=cmd_inputs)

    p_bench = sub.add_parser("bench", help="run the throughput benchmark")
    p_bench.add_argument("--streams", type=int, default=None)
    p_bench.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    if args.cmd == "render" and args.source == "file" and not args.input:
        parser.error("render --source file requires an input WAV path")
    return args.fn(args)


def cli() -> int:
    """Console entry point: `main` with the persistent compile cache on."""
    from spectrogram_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return main()


if __name__ == "__main__":
    sys.exit(cli())
