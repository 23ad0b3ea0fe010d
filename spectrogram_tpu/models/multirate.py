"""Multi-rate stream management: ragged stream populations.

SURVEY.md §7 "Hard parts / Ragged time": per-stream sample rates and hops
make row production rates differ across a batch, but XLA wants static shapes
and lockstep batches.  The resolution is the standard accelerator serving
pattern:
**group streams by geometry** — every stream with the same (sample_rate,
window, hop, height) config shares one `SpectrogramPipeline` and one lockstep
state batch; groups advance independently, each at its own hop cadence.

`StreamGroupManager` owns the groups: adding a stream with a new config spins
up a pipeline for that geometry (the FFTW-plan-cache analog); pushes are
per-group; global metrics aggregate across groups.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import jax
import numpy as np

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline, StreamState


@dataclasses.dataclass
class StreamGroup:
    """One geometry bucket: a pipeline + its lockstep state + the global ids
    of its member streams.  With ingest attached (serve_* members non-None)
    the live state is owned by the feeder; `state` stays a synced snapshot."""

    cfg: SpectrogramConfig
    pipeline: SpectrogramPipeline
    state: StreamState
    stream_ids: list[int]
    bank: object = None          # io.ring.RingBank16 (ingest mode)
    feeder: object = None        # io.feeder.DeviceFeeder (ingest mode)
    pinned: object = None        # io.feeder.ChunkPool (rotating drain buffers)
    next_due: float = 0.0        # next hop-tick deadline (group clock)
    step: object = None          # mesh mode: the group's shard_map push step

    @property
    def n_streams(self) -> int:
        return len(self.stream_ids)

    @property
    def chunk_period(self) -> float:
        """Seconds of audio consumed per push (the group's cadence)."""
        return self.pipeline.chunk_size / self.cfg.sample_rate


class StreamGroupManager:
    """Routes a heterogeneous stream population onto uniform device batches.

    Capacity model: each group is created with a fixed capacity (static
    shapes); attach/detach flips slots within it.  Detached slots keep
    running on silence — the cost of a dead slot is one row of background
    color, which beats a recompile (the reference analog: the GTK widget
    keeps rendering when the input pauses).
    """

    def __init__(
        self,
        group_capacity: int = 256,
        ingest: bool = False,
        ring_capacity: int = 16384,
        feeder_depth: int = 2,
        wire_int16: bool = False,
        mesh=None,
        **pipeline_kwargs,
    ):
        self.group_capacity = int(group_capacity)
        self.pipeline_kwargs = dict(pipeline_kwargs)
        # mesh (direct mode): every geometry group's lockstep state lives
        # stream-sharded on the jax.sharding.Mesh; push_group routes
        # through parallel.mesh.shard_map_step (psum row metrics),
        # set_palette re-places mutated states on the mesh.
        # Ingest ticking stays single-process per host BY DESIGN — in the
        # multi-host deployment PCM never crosses hosts (one manager per
        # process over its host-local shard, parallel/distributed.py), so
        # mesh+ingest in one manager is a topology error, not a feature.
        if mesh is not None:
            if ingest:
                raise ValueError(
                    "mesh + ingest in one manager is unsupported: host "
                    "ingest shards are per-process (PCM never crosses "
                    "hosts) — run one ingest manager per process, or use "
                    "mesh mode with push_group"
                )
            n_dev = int(np.prod(list(mesh.shape.values())))
            if self.group_capacity % n_dev:
                raise ValueError(
                    f"group_capacity {self.group_capacity} must divide "
                    f"evenly over the {n_dev}-device mesh"
                )
        self.mesh = mesh
        # ingest=True wires each geometry group to its own host RingBank16 +
        # DeviceFeeder: producers push int16 PCM by stream id, and `tick`
        # advances every group at ITS OWN hop cadence (the "ragged time"
        # resolution of SURVEY §7; the reference analog is one AudioTransform
        # consuming its ring per stride, audio_transform.rs:34-42).
        self.ingest = bool(ingest)
        self.ring_capacity = int(ring_capacity)
        self.feeder_depth = int(feeder_depth)
        # wire_int16: drain each group's bank as RAW int16 and scale on
        # device (half the host->device bytes per tick; bit-identical —
        # see RingBank16.pop_matrix_i16_planar / DESIGN.md host-ingest)
        self.wire_int16 = bool(wire_int16)
        self._groups: dict[SpectrogramConfig, StreamGroup] = {}
        self._locations: dict[int, tuple[SpectrogramConfig, int]] = {}
        self._next_id = 0

    # -- membership -------------------------------------------------------------

    def add_stream(self, cfg: SpectrogramConfig, palette_id: int = 1) -> int:
        """Register a stream; returns its global id.  Creates the geometry
        group on first use."""
        group = self._groups.get(cfg)
        if group is None:
            pipeline = SpectrogramPipeline(cfg, **self.pipeline_kwargs)
            if self.mesh is not None:
                from spectrogram_tpu.parallel import mesh as pmesh

                state = pmesh.sharded_init(
                    pipeline, self.group_capacity, self.mesh,
                    palette_id=palette_id,
                )
            else:
                state = pipeline.init_state(
                    self.group_capacity, palette_id=palette_id
                )
            group = StreamGroup(cfg, pipeline, state, [])
            if self.ingest:
                from spectrogram_tpu.io.feeder import ChunkPool, DeviceFeeder
                from spectrogram_tpu.io.ring import RingBank16

                group.bank = RingBank16(self.group_capacity, self.ring_capacity)
                # copy-free drain: the bank pops into a rotating depth+1
                # buffer pool, so the feeder never pays the defensive
                # per-push host copy (ChunkPool safety contract)
                group.feeder = DeviceFeeder(
                    pipeline, state, depth=self.feeder_depth, planar=True,
                    copy_chunks=False,
                )
                group.pinned = ChunkPool.for_feeder(
                    group.feeder, self.group_capacity,
                    dtype=np.int16 if self.wire_int16 else np.float32,
                )
            self._groups[cfg] = group
        # Reuse a tombstoned slot before growing (long-running services churn
        # streams; leaking slots would exhaust the group at low occupancy).
        if -1 in group.stream_ids:
            slot = group.stream_ids.index(-1)
            # Zero the slot's device state: the new tenant must not inherit
            # the dead stream's carry samples or retained viewport rows
            # (cross-stream data leakage in a multi-tenant service).
            st = self._state(group)
            self._set_state(group, st._replace(
                carry=st.carry.at[slot].set(0.0),
                ring=st.ring.at[slot].set(0) if st.ring.shape[1] else st.ring,
            ))
            if group.bank is not None:
                group.bank.reset(slot)  # drop the dead tenant's backlog too
        elif group.n_streams < self.group_capacity:
            slot = group.n_streams
            group.stream_ids.append(-1)  # placeholder, set below
        else:
            raise RuntimeError(
                f"group for {cfg.sample_rate:.0f} Hz full "
                f"({self.group_capacity} slots); create a second manager shard"
            )
        stream_id = self._next_id
        self._next_id += 1
        group.stream_ids[slot] = stream_id
        self._locations[stream_id] = (cfg, slot)
        st = self._state(group)
        self._set_state(
            group,
            self._place(group, group.pipeline.set_palette(
                st, st.palette_id.at[slot].set(palette_id)
            )),
        )
        return stream_id

    # The live state is owned by the feeder once ingest is attached; these
    # keep `group.state` a coherent snapshot either way.
    def _state(self, group: StreamGroup) -> StreamState:
        return group.feeder.state if group.feeder is not None else group.state

    def _set_state(self, group: StreamGroup, st: StreamState) -> None:
        if group.feeder is not None:
            group.feeder.state = st
        group.state = st

    def _place(self, group: StreamGroup, st: StreamState) -> StreamState:
        """Mesh mode: re-place a host-mutated state onto the mesh.  Called
        at mutation points only — pushed states are already sharded."""
        if self.mesh is None:
            return st
        from spectrogram_tpu.parallel import mesh as pmesh

        return pmesh.shard_state(st, self.mesh)

    def remove_stream(self, stream_id: int) -> None:
        """Detach: the slot keeps computing silence until reused (no
        recompile, no reshuffle of live neighbors)."""
        cfg, slot = self._locations.pop(stream_id)
        group = self._groups[cfg]
        group.stream_ids[slot] = -1  # tombstone

    def location(self, stream_id: int) -> tuple[SpectrogramConfig, int]:
        return self._locations[stream_id]

    # -- processing ---------------------------------------------------------------

    def groups(self) -> Iterator[StreamGroup]:
        return iter(self._groups.values())

    def push_group(self, cfg: SpectrogramConfig, chunk) -> "np.ndarray":
        """Advance one geometry group by one chunk (direct mode).

        chunk: [capacity, chunk_size, 2] — the host ring bank for this group
        supplies silence for unattached slots (RingBank.pop_matrix zero-fill).
        Returns the group's RGBA rows.
        """
        group = self._groups[cfg]
        st = self._state(group)
        if self.mesh is not None:
            from spectrogram_tpu.parallel import mesh as pmesh
            import jax.numpy as jnp

            if group.step is None:
                group.step = pmesh.shard_map_step(group.pipeline, self.mesh)
            st, rgba, _global_rows = group.step(
                st,
                jax.device_put(
                    jnp.asarray(chunk), pmesh.chunk_sharding(self.mesh)
                ),
            )
        else:
            st, rgba = group.pipeline.push(st, chunk)
        self._set_state(group, st)
        return rgba

    def set_palette(self, stream_id: int, palette_id: int) -> None:
        cfg, slot = self._locations[stream_id]
        group = self._groups[cfg]
        st = self._state(group)
        self._set_state(
            group,
            self._place(group, group.pipeline.set_palette(
                st, st.palette_id.at[slot].set(palette_id)
            )),
        )

    # -- ingest mode ------------------------------------------------------------

    def push_pcm(self, stream_id: int, frames_i16) -> int:
        """Producer edge: int16 PCM frames [n, 2] for one stream, into its
        group's host ring (SPSC per slot; counted drops on overrun)."""
        if not self.ingest:
            raise RuntimeError("manager created without ingest=True")
        cfg, slot = self._locations[stream_id]
        return self._groups[cfg].bank.push(slot, frames_i16)

    def tick(self, now: float) -> dict:
        """Advance every group whose hop deadline has passed — each geometry
        at its own cadence.  Underrun slots get zero-fill (silence rows, like
        the reference widget on a paused input); overruns were already
        counted at push_pcm time.

        Returns {cfg: completed RGBA block} for pushes the async feeder
        finished this tick (depth-pipelined: a block completes one tick
        late at depth 2).
        """
        if not self.ingest:
            raise RuntimeError("manager created without ingest=True")
        out = {}
        for cfg, group in self._groups.items():
            if group.next_due == 0.0:
                group.next_due = now
            if now < group.next_due:
                continue
            buf = group.pinned.next()
            chunk, _counts = (
                group.bank.pop_matrix_i16_planar(
                    group.pipeline.chunk_size, buf)
                if self.wire_int16
                else group.bank.pop_matrix_f32_planar(
                    group.pipeline.chunk_size, buf)
            )
            done = group.feeder.push(chunk)
            group.state = group.feeder.state
            group.next_due += group.chunk_period
            if now - group.next_due > 2 * group.chunk_period:
                group.next_due = now + group.chunk_period  # fell behind: snap
            if done is not None:
                out[cfg] = done
        return out

    def gc_empty_groups(self) -> int:
        """Drop geometry groups whose every slot is tombstoned, releasing
        their device STATE arrays and host rings (an abandoned 10k-slot
        group pins real HBM).  Returns the number of groups collected.

        Known limit: the pipeline's jitted entry points keep the pipeline
        object (its constant resample matrix, ~10-20 MB per geometry) and
        compiled executables alive in JAX's jit cache — JAX has no
        per-instance eviction; call `jax.clear_caches()` if geometry churn
        is unbounded (it drops ALL compiled functions, so the next push per
        surviving geometry recompiles)."""
        empty = [
            cfg for cfg, g in self._groups.items()
            if all(sid == -1 for sid in g.stream_ids)
        ]
        for cfg in empty:
            g = self._groups.pop(cfg)
            if g.feeder is not None:
                g.feeder.flush()
        return len(empty)

    def flush(self) -> dict:
        """Force all in-flight pushes (shutdown / checkpoint point)."""
        out = {}
        for cfg, group in self._groups.items():
            if group.feeder is not None:
                blocks = group.feeder.flush()
                group.state = group.feeder.state
                if blocks:
                    out[cfg] = blocks
        return out

    def metrics(self) -> dict:
        m = {
            "groups": len(self._groups),
            "streams": len(self._locations),
            "rows_produced": {
                f"{cfg.sample_rate:.0f}Hz/w{cfg.window_size}":
                    int(self._state(g).row_count)
                for cfg, g in self._groups.items()
            },
        }
        if self.ingest:
            m["dropped"] = {
                f"{cfg.sample_rate:.0f}Hz/w{cfg.window_size}": g.bank.dropped_total
                for cfg, g in self._groups.items()
            }
        return m
