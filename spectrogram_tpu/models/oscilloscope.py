"""Oscilloscope: raw-waveform visualizer, batched over streams.

JAX redesign of the reference `Oscilloscope` widget
(src/widgets/oscilloscope.rs): a 16384-sample F32F32 ring texture written
destructively from the stream (:199-213) and drawn as two GL line strips
whose vertex shader fetches sample i at (gl_VertexID + ring_index) (:122-136).

Here the ring is a device array [S, N, 2] with a modular cursor, and the
"draw" is a min/max envelope reduction: each output pixel column covers
N/width consecutive samples and reports their (min, max) per channel — the
standard way to rasterize a waveform without a vertex pipeline, returning
[S, width, 2ch, 2] envelopes a host UI can fill between.  Line color comes
from the palette extremes exactly like the reference (color_for((1,0)) /
color_for((0,1)), oscilloscope.rs:177-178).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from spectrogram_tpu.color.colorscheme import ColorScheme

BUFFER_SIZE = 1024 * 16  # oscilloscope.rs:19


class ScopeState(NamedTuple):
    ring: jax.Array    # [S, N, 2] f32 sample ring
    cursor: jax.Array  # [] int32 next write index (shared: lockstep pushes)


class Oscilloscope:
    """Batched waveform ring + envelope renderer.

    chunk contract mirrors the pipeline: push_size samples per push, with
    buffer_size % push_size == 0 so writes never wrap mid-chunk.
    """

    def __init__(self, push_size: int, buffer_size: int = BUFFER_SIZE):
        self.push_size = int(push_size)
        # Round up so writes never wrap mid-chunk (same policy as the
        # spectrogram ring's viewport_rows rounding).
        self.buffer_size = -(-int(buffer_size) // self.push_size) * self.push_size

    def init_state(self, n_streams: int) -> ScopeState:
        return ScopeState(
            ring=jnp.zeros((n_streams, self.buffer_size, 2), jnp.float32),
            cursor=jnp.zeros((), jnp.int32),
        )

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def push(self, state: ScopeState, chunk: jax.Array) -> ScopeState:
        """Destructive ring write (the reference pops the stream dry,
        oscilloscope.rs:199-213)."""
        ring = jax.lax.dynamic_update_slice(
            state.ring, chunk.astype(jnp.float32), (0, state.cursor, 0)
        )
        return ScopeState(
            ring=ring, cursor=(state.cursor + self.push_size) % self.buffer_size
        )

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def envelope(self, state: ScopeState, width: int = 1024) -> jax.Array:
        """[S, width, 2, 2] (min, max) per pixel column per channel, in
        chronological order (oldest sample left).

        Any width <= buffer_size works: each column covers
        buffer_size // width samples, and when width does not divide
        buffer_size the envelope spans the NEWEST width * (buffer_size //
        width) samples (the oldest sliver is dropped — the buffer is
        rounded up to a push multiple, so the display window is an
        approximation of the full ring by at most one column's worth)."""
        if not 0 < width <= self.buffer_size:
            raise ValueError(
                f"width must be in 1..{self.buffer_size}, got {width}"
            )
        per_col = self.buffer_size // width
        ordered = jnp.roll(state.ring, -state.cursor, axis=1)
        ordered = ordered[:, self.buffer_size - width * per_col :]
        s = ordered.shape[0]
        grouped = ordered.reshape(s, width, per_col, 2)
        return jnp.stack(
            [grouped.min(axis=2), grouped.max(axis=2)], axis=-1
        )

    @staticmethod
    def line_colors(scheme: ColorScheme) -> tuple[np.ndarray, np.ndarray]:
        """(left_rgb, right_rgb) u8 — palette extremes (oscilloscope.rs:177-178)."""
        left, _ = scheme.color_for(1.0, 0.0)
        right, _ = scheme.color_for(0.0, 1.0)
        return left, right

    def rasterize(
        self, envelopes: jax.Array, height: int, scheme: ColorScheme
    ) -> np.ndarray:
        """Host-side raster of one stream's envelope [width, 2, 2] ->
        [height, width, 3] u8 image — the live-view analog of the reference's
        two GL line strips (oscilloscope.rs:169-257): each pixel column fills
        [min, max] per channel in the palette-extreme line colors.

        Vectorized (one boolean mask per channel); right channel drawn last,
        matching the reference's draw order (:251-256)."""
        env = np.asarray(envelopes)
        width = env.shape[0]
        bg = np.asarray(scheme.background_color(), np.uint8)
        img = np.broadcast_to(bg, (height, width, 3)).copy()
        colors = self.line_colors(scheme)
        ys = np.arange(height)[:, None]  # [height, 1] vs per-column [1, width]
        for ch in range(2):
            lo = np.clip(
                (1.0 - env[:, ch, 1]) * 0.5 * (height - 1), 0, height - 1
            ).astype(int)
            hi = np.clip(
                (1.0 - env[:, ch, 0]) * 0.5 * (height - 1), 0, height - 1
            ).astype(int)
            img[(ys >= lo[None, :]) & (ys <= hi[None, :])] = colors[ch]
        return img
