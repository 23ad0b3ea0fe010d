"""LiveSession: the runtime wiring layer (the reference's `build_ui` story).

Ties together the input registry, host ring, pipeline, and the secondary
visualizers the way src/main.rs wires the GTK app (:62-151):

* selecting an input pauses the old stream, opens the new one, and — when the
  sample rate changes — rebuilds the pipeline (new FFT plan) and resets the
  state, exactly the reference's `select` -> `set_sample_rate` ->
  `fft_texture.set(None)` chain (audio_input_list_model.rs:35-83,
  gpu_spectrogram.rs:320-327);
* palette changes propagate at runtime with no rebuild (the `palette`
  property binding, main.rs:102-104);
* per-tick processing drains the host ring in hop-multiple chunks, feeding
  the spectrogram pipeline and, optionally, the oscilloscope and spectrum
  analyzer from the same samples (the visualizer swap site, main.rs:69-72).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from spectrogram_tpu.color.colorscheme import scheme_index
from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.io.registry import InputRegistry
from spectrogram_tpu.models.oscilloscope import Oscilloscope
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu.models.spectrum_analyzer import SpectrumAnalyzer
from spectrogram_tpu.utils.profiling import LatencyTracker


@dataclasses.dataclass
class SessionConfig:
    window_period: float = 0.05
    hop_period: float = 2.5 / 2048.0
    viewport_height: int = 1024
    viewport_rows: int = 2048
    chunk_hops: int = 8
    palette: str = "Magma"
    enable_scope: bool = False
    enable_analyzer: bool = False


class LiveSession:
    """Single-stream live session over the input registry."""

    def __init__(self, session_cfg: Optional[SessionConfig] = None):
        self.scfg = session_cfg or SessionConfig()
        self.registry = InputRegistry(on_sample_rate=self._on_sample_rate)
        self.pipeline: Optional[SpectrogramPipeline] = None
        self.state = None
        self.scope = None
        self.scope_state = None
        self.analyzer = None
        self.levels = None
        self.latency = LatencyTracker()
        self.palette_id = scheme_index(self.scfg.palette)

    # -- wiring ---------------------------------------------------------------

    def _on_sample_rate(self, rate: float) -> None:
        """Sample-rate notify: rebuild the pipeline (new FFT plan) and reset
        state — the re-specialization path."""
        cfg = SpectrogramConfig(
            sample_rate=rate,
            window_period=self.scfg.window_period,
            hop_period=self.scfg.hop_period,
            viewport_height=self.scfg.viewport_height,
            viewport_rows=self.scfg.viewport_rows,
        )
        self.pipeline = SpectrogramPipeline(cfg, chunk_hops=self.scfg.chunk_hops)
        if self.pipeline.chunk_size > self.registry.ring.capacity:
            # The reference silently deadlocks when its ingest ring is
            # smaller than a window (SURVEY.md §5 / DESIGN.md D7); we refuse.
            raise ValueError(
                f"chunk ({self.pipeline.chunk_size} frames) exceeds ingest "
                f"ring capacity ({self.registry.ring.capacity}); enlarge the "
                "ring or reduce chunk_hops"
            )
        self.state = self.pipeline.init_state(1, palette_id=self.palette_id)
        if self.scfg.enable_scope:
            self.scope = Oscilloscope(push_size=self.pipeline.chunk_size)
            self.scope_state = self.scope.init_state(1)
        if self.scfg.enable_analyzer:
            self.analyzer = SpectrumAnalyzer(cfg)
            self.levels = self.analyzer.init_levels(1)
            # The analyzer consumes the magnitude rows push just wrote into
            # the row ring — ZERO duplicate STFT work (round-1 recomputed the
            # whole planar STFT in a second jitted step every tick; wrong
            # pattern to scale).  Ring rows are bf16: a <=0.4% magnitude
            # rounding, invisible on a dB bar display (the reference's own
            # texture path quantizes to f16 the same way).
            import jax

            pipeline = self.pipeline
            analyzer = self.analyzer
            k = pipeline.chunk_hops
            viewport_rows = pipeline.viewport_rows

            @jax.jit
            def _analyzer_step(levels, ring, cursor):
                # roll back one chunk INSIDE the jit — eager device-scalar
                # arithmetic would cost a dispatch each (k / viewport_rows
                # are Python constants)
                row_cursor = (cursor - k) % viewport_rows
                rows = jax.lax.dynamic_slice_in_dim(
                    ring, row_cursor, k, axis=1
                ).astype(jnp.float32)                       # [1, k, 2, B]
                return analyzer.push_rows(levels, jnp.moveaxis(rows, -2, -1))

            self._analyzer_step = _analyzer_step

    def select_input(self, index: int):
        """Switch input device/source (pause -> reconfigure -> play)."""
        return self.registry.select(index)

    def set_palette(self, name: str) -> None:
        self.palette_id = scheme_index(name)
        if self.pipeline is not None and self.state is not None:
            self.state = self.pipeline.set_palette(self.state, self.palette_id)

    # -- per-tick processing ----------------------------------------------------

    def process_available(self, max_chunks: int = 64):
        """Drain the host ring in chunk-size steps; returns the RGBA rows
        produced this tick (possibly empty)."""
        if self.pipeline is None:
            return []
        out = []
        n = self.pipeline.chunk_size
        for _ in range(max_chunks):
            if len(self.registry.ring) < n:
                break
            frames = self.registry.ring.pop(n)
            chunk = jnp.asarray(frames[None])
            with self.latency.measure():
                self.state, rgba = self.pipeline.push(self.state, chunk)
                rgba_np = np.asarray(rgba[0])
            out.append(rgba_np)
            if self.analyzer is not None:
                # Reuse the rows push just wrote to the ring (no second
                # STFT); the one-chunk cursor roll-back happens inside the
                # jitted step (the pre-push cursor was donated away).
                self.levels = self._analyzer_step(
                    self.levels, self.state.ring, self.state.cursor
                )
            if self.scope is not None:
                self.scope_state = self.scope.push(self.scope_state, chunk)
        return out

    def metrics(self) -> dict:
        """Observability snapshot: rows, latency, drops (SURVEY §5 gap)."""
        out = {
            "ring_fill": len(self.registry.ring),
            "ring_dropped": self.registry.ring.dropped,
            "latency": self.latency.summary(),
        }
        if self.state is not None:
            out["rows_produced"] = int(self.state.row_count)
            out["palette_id"] = int(self.state.palette_id[0])
        src = self.registry._active
        if src is not None and hasattr(src, "overflows"):
            out["capture_overflows"] = src.overflows
        return out

    def viewport(self) -> np.ndarray:
        """[R, H, 4] u8 current scrolling view."""
        vp = self.pipeline.render_viewport(self.state)
        return np.asarray(vp[0])

    def stop(self):
        self.registry.stop()
