"""The flagship model: batched streaming spectrogram pipeline.

JAX redesign of the reference's `GPUSpectrogram` widget
(src/widgets/gpu_spectrogram.rs), which per vsync tick pulls all ready STFT
rows into a scrolling F16F16 ring texture (:254-275) and renders it with a
log-frequency/dB/palette fragment shader (:135-191).  Here:

* the ring texture becomes a device-resident `[streams, rows, 2, bins]`
  bfloat16 array, donated across pushes; "scrolling" is a modular row cursor
  (gpu_spectrogram.rs:274's `offset` arithmetic), shared by all streams in a
  batch because they advance in lockstep;
* hot loop A (STFT production) is the four-step matmul FFT
  (`ops/mxu_fft.py`) or `jnp.fft` (`ops/stft.py`), batched over streams;
* hot loop B (the fragment shader) is the colormap stage: one precomputed
  resample matmul + dB/pan + per-stream palette LUT lookup, so every stream
  can use a different palette without re-upload (the equivalent of swapping
  the palette texture, :232-239);
* runtime palette switching is a state update (`set_palette`), no recompile;
  sample-rate switching re-specializes the jit like the reference rebuilds
  its FFTW plan (gpu_spectrogram.rs:320-327).

Push contract: each `push` carries `chunk_hops * hop_size` new samples per
stream and emits exactly `chunk_hops` rows per stream.  Fixed chunk size keeps
all shapes static for XLA; the host ingest layer (io/) does the re-chunking.

Every float32 contraction pins `Precision.HIGHEST`: GPUs run float32 matmuls
as TF32 by default, which costs ~3 decimal digits — outside the parity
contract with the reference's f32 pipeline.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spectrogram_tpu.color.colorscheme import (
    stacked_backgrounds,
    stacked_factored_tables,
)
from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.ops import colormap as cmap_ops
from spectrogram_tpu.ops import mxu_fft
from spectrogram_tpu.ops import stft as stft_ops

_HIGHEST = jax.lax.Precision.HIGHEST


class StreamState(NamedTuple):
    """Per-batch device state. All arrays lead with the stream axis except
    the scalars shared by the lockstep batch."""

    carry: jax.Array      # [S, 2, window-hop] f32 planar sample history
    ring: jax.Array       # [S, R, 2, B] bf16 — scrolling row ring, channels-planar
    cursor: jax.Array     # [] int32 — next write row (gpu_spectrogram.rs `offset`)
    palette_id: jax.Array # [S] int32 — per-stream palette index
    row_count: jax.Array  # [] int32 — total rows produced since init


class SpectrogramPipeline:
    """Streaming STFT -> colormap pipeline over a batch of S streams.

    Args:
      cfg: geometry/presentation config (static under jit).
      chunk_hops: rows emitted per push; chunk = chunk_hops * hop samples.
      viewport_rows: ring length (rounded up to a multiple of chunk_hops so
        the write slice never wraps — cursor stays a multiple of chunk_hops).
      ring_dtype: storage dtype of the row ring (bfloat16 stands in for the
        reference's F16F16 texture, gpu_spectrogram.rs:222; DESIGN.md D6).
      lut_resolution: palette LUT side (default cfg.lut_resolution).
      store_ring: keep the per-stream viewport ring; False emits rows only
        (at 10k-stream scale a full ring per stream does not fit in device
        memory, SURVEY.md §6).
      stft_backend: "mxu" = four-step matmul FFT (ops/mxu_fft.py), "xla" =
        `jnp.fft` golden path, "auto" = mxu when the geometry has an even-n1
        factorization and pad_factor >= 2, else xla.
      packed_output: emit rows as [S, k, H] int32 RGBA8888 (little-endian
        byte 0 = R) instead of [S, k, H, 4] u8 — identical bytes; unpack on
        host with `ops.colormap.unpack_rgba`.
      sanitize_input: zero non-finite PCM samples at the ingestion edge.
      schemes: the palette registry (default: the 19 built-ins).
    """

    def __init__(
        self,
        cfg: SpectrogramConfig,
        chunk_hops: int = 8,
        viewport_rows: Optional[int] = None,
        ring_dtype=jnp.bfloat16,
        lut_resolution: Optional[int] = None,
        store_ring: bool = True,
        stft_backend: str = "auto",
        packed_output: bool = False,
        sanitize_input: bool = False,
        schemes=None,
    ):
        cfg.validate()
        self.cfg = cfg
        self.chunk_hops = int(chunk_hops)
        rows = viewport_rows or cfg.viewport_rows
        # Round the ring up so cursor never wraps mid-write.
        self.viewport_rows = -(-rows // self.chunk_hops) * self.chunk_hops
        self.ring_dtype = ring_dtype
        self.store_ring = bool(store_ring)
        # schemes: the palette registry for this pipeline.  Defaults to the
        # 19 built-ins (colorscheme.rs:125-151) but accepts ANY sequence of
        # ColorScheme / FactoredScheme — the analog of the reference's
        # public ColorScheme constructors + arbitrary-LUT upload
        # (colorscheme.rs:24-39, gpu_spectrogram.rs:232-239).  palette ids
        # index THIS list.
        from spectrogram_tpu.color.colorscheme import DEFAULT_COLOR_SCHEMES

        self.schemes = tuple(schemes) if schemes is not None else DEFAULT_COLOR_SCHEMES
        self.scheme_names = tuple(s.name for s in self.schemes)
        res = lut_resolution or cfg.lut_resolution
        u, v = stacked_factored_tables(res, self.schemes)
        self.lut_u = jnp.asarray(u)                                     # [P,r,4]
        self.lut_v = jnp.asarray(v)                                     # [P,r,4]
        self.backgrounds = jnp.asarray(
            stacked_backgrounds(self.schemes)
        )                                                               # [P,3] u8
        self.chunk_size = self.chunk_hops * cfg.hop_size
        self.carry_size = stft_ops.carry_size(cfg)
        if stft_backend not in ("auto", "mxu", "xla"):
            raise ValueError(f"unknown stft_backend {stft_backend!r}")
        plan = mxu_fft.make_plan(cfg) if stft_backend != "xla" else None
        # The split-real four-step needs an even-n1 plan AND the
        # half-spectrum covering all bins (pad_factor >= 2) — the same
        # guard stft_rows_split_planar applies.
        plan_usable = plan is not None and plan.n1 % 2 == 0 and cfg.pad_factor >= 2
        if stft_backend == "mxu" and not plan_usable:
            raise ValueError(
                f"stft_backend='mxu' needs an even-n1 four-step "
                f"factorization and pad_factor >= 2; geometry {cfg} has "
                f"plan={plan} pad_factor={cfg.pad_factor}. "
                f"Use stft_backend='xla' or 'auto'."
            )
        self.fft_plan = plan if plan_usable else None
        self.sanitize_input = bool(sanitize_input)
        self.resample_t = jnp.asarray(cmap_ops.resample_matrix(cfg).T)  # [B,H]
        self.packed_output = bool(packed_output)

    # ------------------------------------------------------------------ state

    def init_state(self, n_streams: int, palette_id: int = 1) -> StreamState:
        """Fresh state for S streams. Default palette 1 = Magma, the
        reference widget's default (gpu_spectrogram.rs:88)."""
        ring_rows = self.viewport_rows if self.store_ring else 0
        return StreamState(
            carry=jnp.zeros((n_streams, 2, self.carry_size), jnp.float32),
            ring=jnp.zeros(
                (n_streams, ring_rows, 2, self.cfg.num_bins), self.ring_dtype
            ),
            cursor=jnp.zeros((), jnp.int32),
            palette_id=jnp.full((n_streams,), palette_id, jnp.int32),
            row_count=jnp.zeros((), jnp.int32),
        )

    def set_palette(self, state: StreamState, palette_id) -> StreamState:
        """Runtime palette switch (per stream or broadcast) — a pure state
        update, the analog of the `palette` GObject property (main.rs:102-104).
        Host-provided (python/numpy) ids are range-checked; device ids clamp
        to the registry like the reference's GL sampler."""
        if not isinstance(palette_id, jax.Array):
            ids = np.asarray(palette_id)
            if ids.min() < 0 or ids.max() >= len(self.schemes):
                raise ValueError(
                    f"palette_id {palette_id!r} out of range "
                    f"0..{len(self.schemes) - 1}"
                )
        pid = jnp.broadcast_to(
            jnp.asarray(palette_id, jnp.int32), state.palette_id.shape
        )
        return state._replace(palette_id=pid)

    # ------------------------------------------------------------------- push

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def push(self, state: StreamState, chunk: jax.Array):
        """Jitted `push_impl`; the state is donated so the ring updates in
        place in device memory."""
        return self.push_impl(state, chunk)

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def push_planar(self, state: StreamState, chunk_planar: jax.Array):
        """As push, but the chunk arrives channels-planar [S, 2, chunk_size]
        (e.g. from RingBank.pop_matrix_planar) — skips the device-side
        transpose at the ingestion edge."""
        return self.push_planar_impl(state, chunk_planar)

    @staticmethod
    def _chunk_f32(chunk: jax.Array) -> jax.Array:
        """Wire-dtype edge: float chunks cast to f32; int16 chunks are raw
        PCM words and scale by 1/32768 ON DEVICE (exactly the scale the
        native bank's f32 drains apply host-side, ring_buffer.cpp
        pop16_range_planar) — pushing int16 halves the host->device
        transfer bytes and the multiply fuses into the framing pass.
        The dtype is part of the traced aval, so each wire format compiles
        its own graph; no runtime branch exists."""
        if chunk.dtype == jnp.int16:
            return chunk.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
        return chunk.astype(jnp.float32)

    def push_planar_impl(self, state: StreamState, chunk_planar: jax.Array):
        if chunk_planar.ndim != 3 or chunk_planar.shape[1:] != (2, self.chunk_size):
            raise ValueError(
                f"planar chunk must be [S, 2, {self.chunk_size}]; got "
                f"{chunk_planar.shape}"
            )
        return self._push_core(state, self._chunk_f32(chunk_planar))

    def push_impl(self, state: StreamState, chunk: jax.Array):
        """Advance all streams by one chunk (pure, untraced — used directly
        by `push` and by `parallel.mesh` under shard_map/jit).

        chunk: [S, chunk_size, 2] f32 (or int16) PCM.
        Returns (new_state, rgba) with rgba [S, chunk_hops, H, 4] u8 — the
        freshly produced colormapped rows (streaming product).
        """
        cfg = self.cfg
        k = self.chunk_hops
        if chunk.ndim != 3 or chunk.shape[1:] != (self.chunk_size, 2):
            raise ValueError(
                f"chunk must be [S, {self.chunk_size}, 2] "
                f"(chunk_hops={k} x hop={cfg.hop_size}); got {chunk.shape}"
            )
        # One small transpose at the ingestion edge; everything downstream
        # is channels-planar.  push_planar skips even this.
        chunk_pl = jnp.swapaxes(self._chunk_f32(chunk), 1, 2)  # [S, 2, T]
        return self._push_core(state, chunk_pl)

    def _push_core(self, state: StreamState, chunk_pl: jax.Array):
        # The named scopes label each layer's device ops in profiler traces
        # (benchmarks/profile_push.py groups device time by them).
        k = self.chunk_hops
        with jax.named_scope("framing"):
            if self.sanitize_input:
                chunk_pl = jnp.where(jnp.isfinite(chunk_pl), chunk_pl, 0.0)
            buf = jnp.concatenate([state.carry, chunk_pl], axis=2)  # [S, 2, C+T]
            new_carry = buf[:, :, buf.shape[2] - self.carry_size :]
            windows = self._frames(buf)                             # [S, k, 2, W]
        with jax.named_scope("stft"):
            rows = self._stft_windows(windows)                      # [S, k, 2, B]
        with jax.named_scope("ring"):
            if self.store_ring:
                ring = jax.lax.dynamic_update_slice(
                    state.ring,
                    rows.astype(self.ring_dtype),
                    (0, state.cursor, 0, 0),
                )
            else:
                ring = state.ring
        cursor = (state.cursor + k) % self.viewport_rows
        new_state = StreamState(
            carry=new_carry,
            ring=ring,
            cursor=cursor,
            palette_id=state.palette_id,
            row_count=state.row_count + k,
        )
        with jax.named_scope("colormap"):
            rgba = self._colormap_u8(rows, state.palette_id)
        return new_state, rgba

    def _stft(self, pcm: jax.Array) -> jax.Array:
        """[S, T, 2] interleaved PCM -> [S, rows, 2, bins] planar rows."""
        if self.fft_plan is not None:
            return mxu_fft.stft_rows_split_planar(pcm, self.cfg, self.fft_plan)
        return stft_ops.stft_rows_planar(pcm, self.cfg)

    def _frames(self, buf: jax.Array) -> jax.Array:
        """[S, 2, T] planar buffer -> [S, k, 2, W] windows; static slice
        framing (peek-window/skip-hop semantics)."""
        w, h = self.cfg.window_size, self.cfg.hop_size
        n = stft_ops.num_rows(buf.shape[2], self.cfg)
        return jnp.stack([buf[:, :, r * h : r * h + w] for r in range(n)], axis=1)

    def _stft_windows(self, windows: jax.Array) -> jax.Array:
        """[S, k, 2, W] planar windows -> [S, k, 2, bins] magnitudes."""
        if self.fft_plan is not None:
            return mxu_fft.stft_planar_windows(windows, self.cfg, self.fft_plan)
        return stft_ops.stft_frame_planar(jnp.swapaxes(windows, -1, -2), self.cfg)

    def _colormap_u8(self, rows: jax.Array, palette_id: jax.Array) -> jax.Array:
        """[S, k, 2, B] magnitude rows -> [S, k, H, 4] u8 RGBA (or [S, k, H]
        packed int32 when packed_output) with a per-stream palette."""
        rgba = self._colormap(rows, palette_id)
        if self.packed_output:
            q = jnp.clip(jnp.round(rgba * 255.0), 0.0, 255.0).astype(jnp.int32)
            return (
                q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
            )
        return cmap_ops.rgba_f32_to_u8(rgba)

    def _colormap(self, rows: jax.Array, palette_id: jax.Array) -> jax.Array:
        """[S, k, 2, B] planar magnitude rows -> [S, k, H, 4] f32 RGBA with a
        per-stream palette."""
        pixels = jnp.einsum(
            "skcb,bh->skch",
            rows,
            self.resample_t,
            preferred_element_type=jnp.float32,
            precision=_HIGHEST,
        )
        left, right = pixels[..., 0, :], pixels[..., 1, :]
        mag = cmap_ops.db_normalize(left, right, self.cfg)
        pan = cmap_ops.pan_fraction(left, right)
        pid = jnp.clip(palette_id, 0, len(self.schemes) - 1)
        return cmap_ops.sample_lut_factored(
            self.lut_u[pid], self.lut_v[pid], pan, mag
        )

    # ----------------------------------------------------------------- render

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def render_viewport(
        self, state: StreamState, width: int | None = None
    ) -> jax.Array:
        """Full scrolling viewport per stream: [S, R, H, 4] u8 RGBA,
        chronological (oldest row first) — the batch analog of the fragment
        shader's `(uv.x * rows + offset) / rows` time wrap
        (gpu_spectrogram.rs:166-171).

        `width` renders the viewport at any time-axis size, matching the GL
        widget's width-independent display: the ring texture is sampled
        bilinearly along continuous uv.x (gpu_spectrogram.rs:166-174, the
        Linear sampler at :285) — here a two-tap interpolation matmul over
        the row axis, in magnitude space BEFORE the colormap exactly like
        GL filters the F16 texture before the shader laws.  Edge policy is
        clamp (DESIGN.md D2; the reference's Repeat wrap is a sampler
        artifact).

        Reads the bf16 ring, so output precision matches the texture path,
        not the f32 streaming path.  The ring is copied to f32 (four times
        its bytes): render small batches of streams.
        """
        ordered = jnp.roll(state.ring, -state.cursor, axis=1).astype(jnp.float32)
        if width is not None and width != self.viewport_rows:
            m = jnp.asarray(_time_resample_matrix(self.viewport_rows, width))
            ordered = jnp.einsum(
                "rw,srcb->swcb", m, ordered,
                preferred_element_type=jnp.float32,
                precision=_HIGHEST,
            )
        return self._colormap_u8(ordered, state.palette_id)

    @functools.partial(jax.jit, static_argnums=0)
    def composite(self, rgba_u8: jax.Array, palette_id: jax.Array) -> jax.Array:
        """Blend [S, ..., 4] u8 RGBA rows over each stream's palette
        background (frame clear + alpha blend, gpu_spectrogram.rs:278-293)."""
        bg = self.backgrounds[palette_id]  # [S, 3] u8
        rgba = rgba_u8.astype(jnp.float32) / 255.0
        shape = (rgba.shape[0],) + (1,) * (rgba.ndim - 2) + (3,)
        return cmap_ops.composite_over_background(rgba, bg.reshape(shape) * 1.0)

    # ------------------------------------------------------------ one-shot API

    def process(self, pcm: jax.Array, palette_id: int = 1):
        """Non-streaming convenience: [S, T, 2] (or [T, 2]) PCM -> u8 RGBA
        rows for all complete windows. Matches push()-ing the same samples
        in hop-multiple chunks.  Default palette 1 (Magma, the reference
        widget's default)."""
        squeeze = pcm.ndim == 2
        if squeeze:
            pcm = pcm[None]
        if self.sanitize_input:
            # same ingestion-edge guard as _push_core — process() must keep
            # matching push() under every option
            pcm = jnp.where(jnp.isfinite(pcm), pcm, 0.0)
        rows = self._stft(pcm)
        pid = jnp.full((pcm.shape[0],), palette_id, jnp.int32)
        rgba = self._colormap_u8(rows, pid)
        return rgba[0] if squeeze else rgba


@functools.lru_cache(maxsize=32)
def _time_resample_matrix(rows: int, width: int) -> "np.ndarray":
    """[rows, width] two-tap bilinear time-resample matrix implementing the
    GL texel sampling law: output column j reads continuous coordinate
    x = (j + 0.5) / width * rows, i.e. lerp(texel floor(x-.5), next,
    frac) with clamp-to-edge taps (gpu_spectrogram.rs:166-174 + DESIGN D2).
    Works for both minification and magnification, like the GL sampler."""
    x = (np.arange(width) + 0.5) / width * rows - 0.5
    i0 = np.floor(x).astype(int)
    w = (x - i0).astype(np.float32)
    cols = np.arange(width)
    m = np.zeros((rows, width), np.float32)
    np.add.at(m, (np.clip(i0, 0, rows - 1), cols), 1.0 - w)
    np.add.at(m, (np.clip(i0 + 1, 0, rows - 1), cols), w)
    return m


def reference_pipeline(**overrides) -> SpectrogramPipeline:
    """Pipeline with the exact reference geometry (48 kHz, window 0.05 s,
    819.2 rows/s, 2048-row viewport)."""
    return SpectrogramPipeline(SpectrogramConfig(**overrides))
