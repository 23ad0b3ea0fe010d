"""Scale-out over a device mesh: stream-sharded SPMD.

The reference is a single-process, two-thread program (SURVEY.md §2,
"Parallelism"); its only concurrency is one SPSC ring between the audio
callback and the UI thread.  The scaling story here is data parallelism
over a 1-D `streams` mesh axis:

* every per-stream array (carry, ring, palette ids, PCM chunks, RGBA rows) is
  sharded along `streams`;
* the batch-shared scalars (cursor, row counter) are replicated;
* steady state needs NO collectives — streams are embarrassingly parallel;
  the only cross-device traffic is monitoring reductions (`psum` of row/drop
  counters).  The mesh stays 1-D: the algorithm has one axis, and the
  devices of one host are joined all to all.

Two equivalent entry points:
* `sharded_push`: `jax.jit` with explicit NamedShardings (GSPMD partitioning).
* `shard_map_step`: explicit per-shard SPMD with a `psum` metrics reduction,
  for when the per-device code must be spelled out (and as the pattern for
  future cross-device features).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spectrogram_tpu.models.spectrogram import SpectrogramPipeline, StreamState

STREAM_AXIS = "streams"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the stream axis."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (STREAM_AXIS,))


def state_shardings(mesh: Mesh) -> StreamState:
    """NamedShardings for every StreamState leaf: stream-sharded arrays,
    replicated scalars."""
    def s(*spec):
        return NamedSharding(mesh, P(*spec))

    return StreamState(
        carry=s(STREAM_AXIS, None, None),
        ring=s(STREAM_AXIS, None, None, None),
        cursor=s(),
        palette_id=s(STREAM_AXIS),
        row_count=s(),
    )


def _state_specs() -> StreamState:
    return StreamState(
        carry=P(STREAM_AXIS, None, None),
        ring=P(STREAM_AXIS, None, None, None),
        cursor=P(),
        palette_id=P(STREAM_AXIS),
        row_count=P(),
    )


def chunk_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(STREAM_AXIS, None, None))


def _rgba_spec(packed: bool) -> P:
    """Output rows spec; packed pipelines emit rank-3 [S, k, H] int32."""
    return P(STREAM_AXIS, None, None) if packed else P(STREAM_AXIS, None, None, None)


def rgba_sharding(mesh: Mesh, packed: bool = False) -> NamedSharding:
    return NamedSharding(mesh, _rgba_spec(packed))


def shard_state(state: StreamState, mesh: Mesh) -> StreamState:
    """Place an (unsharded) state onto the mesh."""
    return jax.device_put(state, state_shardings(mesh))


def sharded_init(
    pipeline: SpectrogramPipeline, n_streams: int, mesh: Mesh, palette_id: int = 1
) -> StreamState:
    """Create the initial state directly ON the mesh (no host round-trip).

    Works in multi-process deployments where `device_put` of a host array
    cannot span non-addressable devices: the zeros materialize sharded,
    straight out of the compiled init."""
    return jax.jit(
        functools.partial(pipeline.init_state, n_streams, palette_id=palette_id),
        out_shardings=state_shardings(mesh),
    )()


def sharded_push(pipeline: SpectrogramPipeline, mesh: Mesh):
    """jit-compiled push with stream-axis sharding constraints.

    Returns step(state, chunk) -> (state, rgba_u8).  The stream count must be
    divisible by mesh size.  State is donated: the ring never leaves device
    memory."""
    ss = state_shardings(mesh)
    return jax.jit(
        pipeline.push_impl,
        in_shardings=(ss, chunk_sharding(mesh)),
        out_shardings=(ss, rgba_sharding(mesh, pipeline.packed_output)),
        donate_argnums=0,
    )


def shard_map_step(pipeline: SpectrogramPipeline, mesh: Mesh):
    """Explicit SPMD push: each device runs the pipeline on its stream shard;
    a psum aggregates the global row counter (the only collective).

    Returns step(state, chunk) -> (state, rgba_u8, global_rows)."""
    state_specs = _state_specs()

    def per_device(state: StreamState, chunk: jax.Array):
        new_state, rgba = pipeline.push_impl(state, chunk)
        local_rows = jnp.asarray(rgba.shape[0] * pipeline.chunk_hops, jnp.int32)
        global_rows = jax.lax.psum(local_rows, STREAM_AXIS)
        return new_state, rgba, global_rows

    mapped = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(state_specs, P(STREAM_AXIS, None, None)),
        out_specs=(state_specs, _rgba_spec(pipeline.packed_output), P()),
    )
    return jax.jit(mapped, donate_argnums=0)


def global_metrics(state: StreamState) -> dict:
    """Monitoring summary (fills the observability gap noted in SURVEY.md §5
    — the reference only ever printed to stderr).  Works on sharded state:
    reading the replicated scalars costs no transfer; the per-stream reduce
    runs where the data lives."""
    return {
        "streams": int(state.palette_id.shape[0]),
        "rows_produced": int(state.row_count),
        "cursor": int(state.cursor),
    }
