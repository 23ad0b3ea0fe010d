"""Multi-host serving: process-spanning meshes + host-local ingest shards.

Fulfills SURVEY.md §2's comm-backend row (`jax.distributed` + XLA collectives
between hosts).  The reference is a single-process desktop app; its one
cross-thread boundary is the SPSC ring handed from the audio callback to the
UI thread (reference src/devices/audio_input_list_model.rs:30).  At serving
scale the same boundary becomes a cross-HOST one: every host captures/receives
the PCM for ITS OWN stream shard, drains it from a host-local RingBank, and
the device mesh stitches the shards into one global batch — samples never
cross hosts, only the (tiny) metrics reductions do.

Topology contract: the global mesh orders devices process-contiguously (JAX's
default `jax.devices()` order), so a 1-D `streams` mesh gives every process a
CONTIGUOUS global stream range — `local_stream_range` below.  Producers feed
the host bank with LOCAL indices; `make_global_chunk` assembles the global
device array from purely process-local data (no host gathers, no transposes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax

from spectrogram_tpu.parallel.mesh import STREAM_AXIS, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    Where a cluster manager tells JAX about the cluster, call with no
    arguments (JAX autodetects the coordinator); otherwise pass the trio
    explicitly (e.g. `coordinator_address="localhost:<port>"` on one
    host).  Single-process callers may skip this entirely.

    Must be the process's FIRST JAX call: anything that initializes the XLA
    backends (even `jax.process_count()`) makes distributed init impossible,
    so the only safe guard here is the distributed-client check itself.
    """
    if _already_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as exc:
        # Idempotency fallback when the private-state probe below was
        # unavailable: jax raises RuntimeError on double-initialize.
        if "already" not in str(exc).lower():
            raise


def _already_initialized() -> bool:
    # jax._src.distributed is private and can move across JAX upgrades; on
    # any shape change, report "unknown" (False) and let initialize()'s
    # RuntimeError fallback preserve idempotency (ADVICE r2).
    try:
        from jax._src import distributed

        return distributed.global_state.client is not None
    except Exception:
        return False


def global_mesh():
    """1-D `streams` mesh over every device of every process (process-
    contiguous order — the property `local_stream_range` relies on)."""
    return make_mesh(devices=jax.devices())


def local_stream_range(mesh, n_streams: int) -> tuple[int, int]:
    """Global [lo, hi) stream range whose shards live on THIS process.

    With `n_streams` sharded over the mesh's `streams` axis, each device owns
    `n_streams / n_devices` consecutive streams in mesh order; a process's
    devices are contiguous in the default order, so its union is one range.
    """
    devs = list(mesh.devices.flat)
    n_dev = len(devs)
    if n_streams % n_dev:
        raise ValueError(f"{n_streams} streams not divisible by {n_dev} devices")
    per = n_streams // n_dev
    mine = [i for i, d in enumerate(devs) if d.process_index == jax.process_index()]
    if not mine:
        return (0, 0)
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(
            "mesh devices of this process are not contiguous; build the mesh "
            "with the default jax.devices() order"
        )
    return (mine[0] * per, (mine[-1] + 1) * per)


def make_global_chunk(mesh, local_chunk: np.ndarray, n_streams: int) -> jax.Array:
    """Assemble the global [n_streams, ...] stream-sharded device array from
    this process's local [local_streams, ...] host chunk.

    Pure process-local data movement: each host only uploads its own shard
    (`jax.make_array_from_process_local_data`); no PCM crosses hosts.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(STREAM_AXIS, *([None] * (local_chunk.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    global_shape = (n_streams,) + tuple(local_chunk.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, local_chunk, global_shape
    )


class HostShardIngest:
    """Per-host ingest for a multi-process deployment: a host-local RingBank16
    covering only this process's stream shard, draining straight into the
    global sharded chunk.

    Producers push with LOCAL stream indices (0..local_streams); `drain`
    returns the global device array for `sharded_push`/`shard_map_step`.
    """

    def __init__(self, mesh, n_streams: int, chunk_size: int,
                 capacity: int = 16384):
        from spectrogram_tpu.io.ring import RingBank16

        self.mesh = mesh
        self.n_streams = int(n_streams)
        self.chunk_size = int(chunk_size)
        self.lo, self.hi = local_stream_range(mesh, n_streams)
        self.local_streams = self.hi - self.lo
        self.bank = RingBank16(self.local_streams, capacity)
        self._pinned = np.empty((self.local_streams, self.chunk_size, 2),
                                np.float32)

    def drain(self) -> jax.Array:
        """One hop tick: pop every local ring (zero-fill on underrun) and
        assemble the global stream-sharded chunk."""
        local, _counts = self.bank.pop_matrix_f32(self.chunk_size, self._pinned)
        return make_global_chunk(self.mesh, local, self.n_streams)

    def metrics(self) -> dict:
        return {
            "process": jax.process_index(),
            "streams": (self.lo, self.hi),
            "dropped": self.bank.dropped_total,
            "min_buffered": self.bank.min_size(),
        }
