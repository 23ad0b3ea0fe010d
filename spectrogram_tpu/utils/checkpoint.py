"""Checkpoint / resume for streaming state.

The reference persists nothing — its scrolling texture is rebuilt empty on
every sample-rate change (gpu_spectrogram.rs:326) and all history dies with
the process (SURVEY.md §5).  Here the device row-ring + cursors + palette ids
form real resumable state: a long-running 10k-stream service should survive
restarts without blanking every client's viewport.

Two formats:
* .npz + JSON sidecar (`save_state`/`load_state`): single-process; sharded
  states are gathered to host and re-sharded on load.
* orbax (`save_sharded`/`load_sharded`): distributed-native — every process
  writes only its own shards and restore places them straight onto the mesh
  (no host gather, works across multi-host deployments where non-addressable
  shards make device_get impossible).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import numpy as np

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline, StreamState


def _sidecar_payload(cfg: SpectrogramConfig, pipeline=None) -> str:
    """Config sidecar JSON.  Alongside the geometry it records the saving
    pipeline's chunk_hops/viewport_rows when known: cursor validity depends
    on them but they are not part of any array shape, so without the record
    a k=8 checkpoint restored at k=4 could pass the modular fallback check
    by luck (ADVICE r2)."""
    doc = dict(dataclasses.asdict(cfg))
    if pipeline is not None:
        doc["_pipeline"] = {
            "chunk_hops": pipeline.chunk_hops,
            "viewport_rows": pipeline.viewport_rows,
        }
    return json.dumps(doc, sort_keys=True)


def _parse_sidecar(text: str) -> tuple[SpectrogramConfig, dict]:
    doc = json.loads(text)
    pipeline_meta = doc.pop("_pipeline", {})
    return SpectrogramConfig(**doc), pipeline_meta


def save_state(
    path, state: StreamState, cfg: SpectrogramConfig, pipeline=None
) -> None:
    """Write state + config. `path` gets `.npz`; a `.json` sidecar holds the
    geometry (plus chunk_hops/viewport_rows when `pipeline` is given)."""
    path = pathlib.Path(path)
    host = jax.device_get(state)
    np.savez_compressed(
        path.with_suffix(".npz"),
        carry=np.asarray(host.carry),
        ring=np.asarray(host.ring, dtype=np.float32),  # bf16 -> f32 container
        cursor=np.asarray(host.cursor),
        palette_id=np.asarray(host.palette_id),
        row_count=np.asarray(host.row_count),
        ring_dtype=str(state.ring.dtype),
    )
    path.with_suffix(".json").write_text(_sidecar_payload(cfg, pipeline))


def load_config(path) -> SpectrogramConfig:
    path = pathlib.Path(path)
    return _parse_sidecar(path.with_suffix(".json").read_text())[0]


def load_state(path, pipeline: SpectrogramPipeline) -> StreamState:
    """Restore state for `pipeline`; raises if the checkpoint geometry is
    incompatible (the analog of the reference's forced texture realloc on
    rate change — a changed geometry means a fresh state, not a bad load)."""
    import jax.numpy as jnp

    path = pathlib.Path(path)
    saved_cfg, pipeline_meta = _parse_sidecar(
        path.with_suffix(".json").read_text()
    )
    if (
        saved_cfg.window_size != pipeline.cfg.window_size
        or saved_cfg.sample_rate != pipeline.cfg.sample_rate
        or saved_cfg.pad_factor != pipeline.cfg.pad_factor
    ):
        raise ValueError(
            f"checkpoint geometry {saved_cfg} incompatible with pipeline "
            f"{pipeline.cfg}; start a fresh state instead"
        )
    z = np.load(path.with_suffix(".npz"))
    ring_dtype = jnp.dtype(str(z["ring_dtype"]))
    carry = np.asarray(z["carry"])
    if carry.ndim != 3 or carry.dtype != np.float32:
        # Older pipelines could keep the carry transposed ([S, 2, n1, C/n1])
        # or as int16 sample planes; neither format exists any more.
        raise ValueError(
            f"checkpoint carry is {carry.dtype} {carry.shape}, a sample-plane "
            f"format this version no longer reads (expected float32 "
            f"[S, 2, C]); start a fresh state"
        )
    state = StreamState(
        carry=jnp.asarray(carry),
        ring=jnp.asarray(z["ring"]).astype(ring_dtype),
        cursor=jnp.asarray(z["cursor"]),
        palette_id=jnp.asarray(z["palette_id"]),
        row_count=jnp.asarray(z["row_count"]),
    )
    import functools

    expected = jax.eval_shape(
        functools.partial(pipeline.init_state, state.palette_id.shape[0])
    )
    for name in StreamState._fields:
        got = getattr(state, name).shape
        want = getattr(expected, name).shape
        if got != want:
            raise ValueError(
                f"checkpoint field {name} shape {got} != pipeline "
                f"expectation {want}"
            )
    _check_cursor_alignment(state, pipeline, pipeline_meta)
    return state


def save_sharded(
    path, state: StreamState, cfg: SpectrogramConfig, pipeline=None
) -> None:
    """Orbax save of a (possibly multi-host) sharded state: each process
    persists only its addressable shards; the config sidecar travels in the
    same directory.  `path` is a directory."""
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).resolve()
    payload = state._asdict()
    # streaming states (store_ring=False) carry a ZERO-SIZE ring leaf,
    # which orbax refuses to serialize; drop empty leaves and let
    # load_sharded rebuild them from the pipeline template
    payload = {
        k: v for k, v in payload.items() if getattr(v, "size", 1) > 0
    }
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path / "state", payload, force=True)
    if jax.process_index() == 0:
        (path / "config.json").write_text(_sidecar_payload(cfg, pipeline))


def load_sharded(path, pipeline: SpectrogramPipeline, mesh=None) -> StreamState:
    """Restore straight onto the mesh: shapes/shardings come from an
    ABSTRACT template (jax.eval_shape — no HBM is allocated for a throwaway
    zero state, restore peaks at 1x the state size), so every process reads
    only the shards it owns.  `mesh=None` restores unsharded."""
    import functools

    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).resolve()
    saved_cfg, pipeline_meta = _parse_sidecar(
        (path / "config.json").read_text()
    )
    if (
        saved_cfg.window_size != pipeline.cfg.window_size
        or saved_cfg.sample_rate != pipeline.cfg.sample_rate
        or saved_cfg.pad_factor != pipeline.cfg.pad_factor
    ):
        raise ValueError(
            f"checkpoint geometry {saved_cfg} incompatible with pipeline "
            f"{pipeline.cfg}; start a fresh state instead"
        )
    with ocp.StandardCheckpointer() as ckptr:
        meta = ckptr.metadata(path / "state")
        n_streams = meta.item_metadata["palette_id"].shape[0]
        template = jax.eval_shape(
            functools.partial(pipeline.init_state, n_streams)
        )
        stored_fields = [f for f in StreamState._fields if f in meta.item_metadata]
        for name in stored_fields:
            got = meta.item_metadata[name]
            want = getattr(template, name)
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint field {name} shape {tuple(got.shape)} != "
                    f"pipeline expectation {tuple(want.shape)} (viewport/"
                    f"chunk geometry changed; start a fresh state)"
                )
        if mesh is not None:
            from spectrogram_tpu.parallel.mesh import state_shardings

            shardings = state_shardings(mesh)
        else:
            shardings = jax.tree.map(lambda _: None, template)
        abstract = {
            name: jax.ShapeDtypeStruct(
                getattr(template, name).shape,
                getattr(template, name).dtype,
                sharding=getattr(shardings, name),
            )
            for name in stored_fields
        }
        restored = ckptr.restore(path / "state", abstract)
    # zero-size leaves (a streaming state's empty ring) are never stored
    # (orbax rejects them) — rebuild them from the template
    for name in StreamState._fields:
        if name not in restored:
            want = getattr(template, name)
            if want.size:
                raise ValueError(
                    f"checkpoint is missing field {name!r} but the "
                    f"pipeline expects {tuple(want.shape)} (store_ring "
                    f"mismatch between save and load pipelines?)"
                )
            restored[name] = jnp.zeros(want.shape, want.dtype)
    state = StreamState(**restored)
    _check_cursor_alignment(state, pipeline, pipeline_meta)
    return state


def _check_cursor_alignment(
    state: StreamState, pipeline, pipeline_meta: dict | None = None
) -> None:
    """A restored cursor must sit on the restoring pipeline's chunk grid:
    chunk_hops is not part of the array shapes, and a misaligned cursor
    silently corrupts the ring (the write slice clamps at the wrap).

    Checkpoints written since round 3 record the saving pipeline's
    chunk_hops/viewport_rows in the sidecar — compared directly.  Older
    checkpoints fall back to the modular heuristic (which a lucky cursor,
    e.g. saved at k=8 restored at k=4, could pass undetected)."""
    meta = pipeline_meta or {}
    if meta:
        saved_k = meta.get("chunk_hops")
        if saved_k is not None and saved_k != pipeline.chunk_hops:
            raise ValueError(
                f"checkpoint was saved with chunk_hops={saved_k}; this "
                f"pipeline uses chunk_hops={pipeline.chunk_hops} — start a "
                f"fresh state"
            )
        saved_rows = meta.get("viewport_rows")
        if saved_rows is not None and saved_rows != pipeline.viewport_rows:
            raise ValueError(
                f"checkpoint was saved with viewport_rows={saved_rows}; "
                f"this pipeline uses {pipeline.viewport_rows} — start a "
                f"fresh state"
            )
    cursor = int(state.cursor)
    if cursor % pipeline.chunk_hops:
        raise ValueError(
            f"checkpoint cursor {cursor} is not a multiple of this "
            f"pipeline's chunk_hops={pipeline.chunk_hops}; it was saved "
            f"under a different chunking — start a fresh state"
        )
