"""Per-push device time and per-layer breakdown on one GPU.

For each cell x STFT backend: the p50 wall time per push (host clock around
`block_until_ready`, compile excluded, backends interleaved A B B A), then a
profiler trace of a few pushes reduced to device busy time per push and its
split over the pipeline's named scopes (framing, stft, ring, colormap — see
`SpectrogramPipeline._push_core`), beside each layer's lower bound on bytes
moved; and the served loop of chip_smoke.py traced over its timed pushes
for the device's idle share.  Refuses to run anywhere but on a GPU.

XLA runs the whole push as one CUDA graph ("command buffer"), which the
trace shows as a single event; the per-scope split needs it off:

    python benchmarks/profile_push.py                       # wall times
    XLA_FLAGS=--xla_gpu_enable_command_buffer= \
        python benchmarks/profile_push.py --out chiprun_out/nograph

Writes <out>/profile_push.json and the raw traces under <out>/traces/.
"""

from __future__ import annotations

import argparse
import gzip
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

SCOPES = ("framing", "stft", "ring", "colormap")
# cell -> (geometry, streams, chunk_hops, store_ring): the served
# 10,240-stream cell and the reference desktop cadence with its viewport.
CELLS = {
    "4096": ("BENCH_CONFIG", 10240, 1, False),
    "4800": ("DEFAULT_CONFIG", 1024, 16, True),
}


def layer_bytes(cfg, s: int, k: int, store_ring: bool) -> dict:
    """Least bytes each layer must move per push (read + write once)."""
    w, b, h = cfg.window_size, cfg.num_bins, cfg.viewport_height
    c = w - cfg.hop_size
    rows = s * k
    return {
        "framing": s * 2 * (c + k * cfg.hop_size) * 4 + rows * 2 * w * 4,
        "stft": rows * 2 * w * 4 + rows * 2 * b * 4,
        "ring": rows * 2 * b * (4 + 2) if store_ring else 0,
        "colormap": rows * 2 * b * 4 + rows * h * 4,
    }


def scope_of_ops(hlo_text: str) -> dict:
    """HLO instruction name -> pipeline scope, from op metadata."""
    out = {}
    pat = re.compile(r'%?([\w.\-]+) = .*?metadata=\{[^}]*op_name="([^"]+)"')
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        scope = next((p for p in parts if p in SCOPES), "other")
        out[m.group(1)] = scope
    return out


def reduce_trace(trace_dir: pathlib.Path, op_scope: dict, pushes: int) -> dict:
    """Device busy time per push and its split over scopes, from the
    perfetto trace jax.profiler writes.  Device lanes are the processes
    whose name mentions a GPU; an event's HLO op comes from its args."""
    path = max(trace_dir.rglob("perfetto_trace.json.gz"),
               key=lambda p: p.stat().st_mtime)
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    pnames = {e["pid"]: e.get("args", {}).get("name", "")
              for e in events
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev_pids = {pid for pid, n in pnames.items() if "GPU" in n or "gpu" in n}
    per_scope = defaultdict(float)
    per_op = defaultdict(float)
    intervals = []
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        args = e.get("args", {})
        op = args.get("hlo_op") or args.get("long_name", e.get("name", ""))
        op = op.split(" ")[0].lstrip("%")
        dur_us = float(e.get("dur", 0.0))
        per_scope[op_scope.get(op, "other")] += dur_us
        per_op[f"{op} [{op_scope.get(op, 'other')}]"] += dur_us
        intervals.append((float(e["ts"]), float(e["ts"]) + dur_us))
    intervals.sort()
    busy, end = 0.0, -1e30
    for a, b in intervals:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:12]
    return {
        "device_lanes": sorted(pnames[p] for p in dev_pids),
        "busy_ms_per_push": busy / 1e3 / pushes,
        "span_ms_per_push": window / 1e3 / pushes,
        "scope_ms_per_push": {k: v / 1e3 / pushes for k, v in per_scope.items()},
        "top_ops_ms_per_push": {k: v / 1e3 / pushes for k, v in top},
        "sample_event_args": next(
            (e.get("args") for e in events
             if e.get("ph") == "X" and e.get("pid") in dev_pids), None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="4096,4800")
    ap.add_argument("--pushes", type=int, default=20)
    ap.add_argument("--trace-pushes", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from spectrogram_tpu import config as config_mod
    from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
    from spectrogram_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"profile_push: needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi {card}", flush=True)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {"card": card, "device_kind": dev.device_kind, "cells": {}}

    def run(cell: str, backend: str, n_pushes: int, trace_dir=None):
        cfg_name, s, k, ring = CELLS[cell]
        cfg = getattr(config_mod, cfg_name)
        p = SpectrogramPipeline(cfg, chunk_hops=k, store_ring=ring,
                                packed_output=True, stft_backend=backend)
        rng = np.random.default_rng(0)
        chunk = jnp.asarray(rng.integers(-12000, 12000, (s, 2, p.chunk_size))
                            .astype(np.int16))
        st = p.set_palette(p.init_state(s), np.arange(s) % 19)
        for _ in range(2):  # compile + warm
            st, out = p.push_planar(st, chunk)
        jax.block_until_ready((st, out))
        times = []
        if trace_dir is not None:
            jax.profiler.start_trace(str(trace_dir), create_perfetto_trace=True)
        for _ in range(n_pushes):
            t0 = time.perf_counter()
            st, out = p.push_planar(st, chunk)
            jax.block_until_ready((st, out))
            times.append(time.perf_counter() - t0)
        if trace_dir is not None:
            jax.profiler.stop_trace()
        hlo = type(p).push_planar.lower(p, st, chunk).compile().as_text()
        del st, out
        return times, hlo, layer_bytes(cfg, s, k, ring)

    for cell in args.cells.split(","):
        walls = {"mxu": [], "xla": []}
        for backend in ("mxu", "xla", "xla", "mxu"):
            times, _, _ = run(cell, backend, args.pushes)
            walls[backend].append(statistics.median(times) * 1e3)
            print(f"cell {cell} {backend}: p50 {walls[backend][-1]:.4f} ms/push",
                  flush=True)
        cell_rep = {"cell": CELLS[cell], "p50_wall_ms": walls, "trace": {}}
        for backend in ("mxu", "xla"):
            tdir = out_dir / "traces" / f"{cell}_{backend}"
            _, hlo, lb = run(cell, backend, args.trace_pushes, trace_dir=tdir)
            try:
                red = reduce_trace(tdir, scope_of_ops(hlo), args.trace_pushes)
            except (OSError, ValueError, KeyError) as exc:
                red = {"error": repr(exc)}
            red["lower_bound_bytes"] = lb
            red["bound_ms_at_3.35TB/s"] = {
                k: v / 3.35e12 * 1e3 for k, v in lb.items()}
            cell_rep["trace"][backend] = red
            print(f"cell {cell} {backend} trace: "
                  f"{json.dumps(red, default=str)[:3000]}", flush=True)
        report["cells"][cell] = cell_rep
    # The served loop (bank -> feeder -> drain) traced over its timed
    # pushes: device busy time against the window's span is the idle share.
    import chip_smoke

    tdir = out_dir / "traces" / "served"
    served = chip_smoke.phase_served(dev, pushes=8, trace_dir=tdir)
    red = reduce_trace(tdir, {}, 8)
    red["idle_share"] = 1.0 - red["busy_ms_per_push"] / red["span_ms_per_push"]
    report["served"] = {"loop": served, "trace": red}
    print(f"served trace: {json.dumps(red, default=str)[:2000]}", flush=True)
    for pb in (out_dir / "traces").rglob("*.xplane.pb"):
        pb.unlink()  # the perfetto json beside it holds the same events
    (out_dir / "profile_push.json").write_text(
        json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
