"""Async device feeder: host ring -> pipelined pushes with bounded depth.

The reference achieves <= 1 display frame of latency by doing exactly one
texture upload + draw per vsync (README.md:10-11; gpu_spectrogram.rs's tick
callback).  The analog here is JAX's async dispatch: a push can be ENQUEUED
while the previous one still executes, overlapping H2D transfer of chunk
N+1 with compute of chunk N — the double-buffered pipeline of SURVEY.md §7
("hop-tick dispatch cadence with async dispatch depth 2").

`DeviceFeeder` bounds the number of in-flight pushes (depth): unbounded
enqueueing would hide a falling-behind pipeline until OOM; depth-1 serializes
and wastes the transfer/compute overlap.  Depth 2 is the reference-equivalent
setting.  Results are yielded in order once forced.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator, Optional

import jax
import numpy as np

from spectrogram_tpu.models.spectrogram import SpectrogramPipeline, StreamState
from spectrogram_tpu.utils.probe import ThroughputProbe


class ChunkPool:
    """Rotating pool of preallocated host chunk buffers.

    The copy-free drain pattern at scale (a 10,240-stream planar chunk is
    ~65 MB; a defensive copy per push would burn most of the hop budget on
    the host):

        pool = ChunkPool.for_feeder(feeder, bank.n_streams)
        buf = pool.next()
        bank.pop_matrix_f32_planar(n, out=buf)   # drain INTO the pool slot
        feeder.push(buf)                          # zero further host copies

    Safety contract: with `n_buffers >= depth + 1`, by the time a slot is
    handed out again the push that used it has been FORCED (the feeder
    drains push i while admitting push i+depth-1), so its H2D transfer is
    complete — the async backend can no longer be reading the buffer when
    the bank overwrites it.  One extra slot beyond the proof's minimum
    (depth) guards the fill-while-enqueued window.
    """

    def __init__(self, n_buffers: int, shape: tuple, dtype=np.float32):
        if n_buffers < 2:
            raise ValueError("a rotation pool needs >= 2 buffers")
        self._bufs = [np.zeros(shape, dtype) for _ in range(n_buffers)]
        self._i = 0

    @classmethod
    def for_feeder(
        cls, feeder: "DeviceFeeder", n_streams: int, dtype=np.float32
    ) -> "ChunkPool":
        """Pool sized depth+1 with the feeder's chunk geometry ([S, 2, n]
        planar or [S, n, 2] interleaved).

        dtype=np.int16 is the HALF-BANDWIDTH wire path: drain raw PCM words
        with `RingBank16.pop_matrix_i16_planar(n, out=buf)` and push the
        int16 block as-is — the pipeline scales by 1/32768 on device
        (SpectrogramPipeline._chunk_f32), bit-identical to the f32 drain's
        host-side conversion, at half the host->device transfer bytes."""
        n = feeder.pipeline.chunk_size
        shape = (n_streams, 2, n) if feeder.planar else (n_streams, n, 2)
        return cls(feeder.depth + 1, shape, dtype)

    def next(self) -> np.ndarray:
        """Hand out the next buffer in rotation (caller fills then pushes)."""
        buf = self._bufs[self._i]
        self._i = (self._i + 1) % len(self._bufs)
        return buf

    def __len__(self) -> int:
        return len(self._bufs)


class DeviceFeeder:
    """Pipelined push loop over a host chunk source.

    chunk_source: callable returning the next [S, chunk, 2] numpy block (or
    None when exhausted) — e.g. RingBank.pop_matrix bound to the right size.
    on_rows: optional consumer called with each push's RGBA output (host
    numpy, forced — this is the point where latency is paid).
    """

    def __init__(
        self,
        pipeline: SpectrogramPipeline,
        state: StreamState,
        depth: int = 2,
        on_rows: Optional[Callable[[np.ndarray], None]] = None,
        planar: bool = False,
        readback: str = "full",
        copy_chunks: bool = True,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if readback not in ("full", "probe"):
            raise ValueError(f"readback must be 'full' or 'probe', got {readback!r}")
        self.pipeline = pipeline
        self.state = state
        self.depth = depth
        self.on_rows = on_rows
        # planar=True: chunks arrive [S, 2, n] (RingBank.pop_matrix_planar),
        # skipping the device-side transpose at the ingestion edge.
        self.planar = bool(planar)
        # readback="probe": wait for the push and hand back the DEVICE array
        # instead of a full host copy — for consumers that keep rows
        # on-device (renderers, device-side sinks).
        self.readback = readback
        # copy_chunks=False is safe ONLY when the caller rotates >= depth+1
        # host buffers — use ChunkPool.for_feeder (see its safety contract).
        # The default pays one defensive host copy per push, which at 10k
        # streams is ~65 MB/push: production serve loops should rotate.
        self.copy_chunks = bool(copy_chunks)
        self.probe = ThroughputProbe()
        self._inflight: collections.deque = collections.deque()

    def _drain_one(self) -> np.ndarray:
        rgba = self._inflight.popleft()
        if self.readback == "probe":
            host = jax.block_until_ready(rgba)  # stays on device
        else:
            host = np.asarray(rgba)  # waits for the push, copies to host
        if self.on_rows is not None:
            self.on_rows(host)
        return host

    def push(self, chunk: np.ndarray) -> Optional[np.ndarray]:
        """Enqueue one chunk; returns a completed older result once the
        pipeline is primed (None during the first `depth-1` pushes)."""
        import jax.numpy as jnp

        # np.asarray below may return before the H2D transfer completes on
        # async backends; callers reusing one pinned buffer (the recommended
        # pop_matrix pattern) would overwrite it mid-transfer.  A defensive
        # host copy is cheap relative to the push; callers that rotate
        # >= depth+1 buffers can pass copy=False via the attribute.
        if self.copy_chunks and isinstance(chunk, np.ndarray):
            chunk = chunk.copy()
        if self.planar:
            self.state, rgba = self.pipeline.push_planar(
                self.state, jnp.asarray(chunk)
            )
            chunk_len = chunk.shape[2]
        else:
            self.state, rgba = self.pipeline.push(self.state, jnp.asarray(chunk))
            chunk_len = chunk.shape[1]
        self._inflight.append(rgba)
        self.probe.record_push(chunk.shape[0], chunk_len, self.pipeline.chunk_hops)
        if len(self._inflight) > self.depth - 1:
            return self._drain_one()
        return None

    def flush(self) -> list[np.ndarray]:
        """Force all in-flight pushes (end of stream / checkpoint point)."""
        out = []
        while self._inflight:
            out.append(self._drain_one())
        return out

    def run(self, chunk_source: Callable[[], Optional[np.ndarray]]) -> Iterator[np.ndarray]:
        """Drive until the source is exhausted, yielding completed row
        blocks in order."""
        while True:
            chunk = chunk_source()
            if chunk is None:
                break
            done = self.push(chunk)
            if done is not None:
                yield done
        yield from self.flush()
