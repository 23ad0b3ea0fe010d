"""The trace-to-metrics reduction of benchmarks/profile_push.py, checked on
small recorded inputs, and the GPU-only tools' refusal to run elsewhere."""

import gzip
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from spectrogram_tpu.config import BENCH_CONFIG
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))
import profile_push as pp  # noqa: E402


def test_scope_of_ops_finds_every_layer():
    p = SpectrogramPipeline(BENCH_CONFIG, chunk_hops=2, store_ring=True,
                            viewport_rows=4, packed_output=True)
    st = p.init_state(2)
    chunk = jnp.zeros((2, 2, p.chunk_size), jnp.int16)
    hlo = type(p).push_planar.lower(p, st, chunk).compile().as_text()
    scopes = set(pp.scope_of_ops(hlo).values())
    assert {"framing", "stft", "ring", "colormap"} <= scopes


def test_reduce_trace_on_a_recorded_trace(tmp_path):
    """Two pushes: overlapping kernels count once toward busy time; host
    lanes and unknown ops are kept apart."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "ts": 0.0, "dur": 100.0,
         "args": {"hlo_op": "gemm.1"}},
        {"ph": "X", "pid": 1, "ts": 50.0, "dur": 100.0,
         "args": {"hlo_op": "fusion.2"}},
        {"ph": "X", "pid": 1, "ts": 400.0, "dur": 100.0,
         "args": {"hlo_op": "copy.3"}},
        {"ph": "X", "pid": 2, "ts": 0.0, "dur": 999.0,
         "args": {"hlo_op": "gemm.1"}},
    ]
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "perfetto_trace.json.gz", "wt") as f:
        json.dump({"traceEvents": ev}, f)
    red = pp.reduce_trace(tmp_path, {"gemm.1": "colormap", "fusion.2": "stft"}, 2)
    assert red["busy_ms_per_push"] == pytest.approx(0.250 / 2)
    assert red["span_ms_per_push"] == pytest.approx(0.500 / 2)
    assert red["scope_ms_per_push"] == pytest.approx(
        {"colormap": 0.05, "stft": 0.05, "other": 0.05})
    assert red["device_lanes"] == ["/device:GPU:0"]


def test_layer_bytes_of_the_served_cell():
    lb = pp.layer_bytes(BENCH_CONFIG, 10240, 1, False)
    # colormap reads two f32 magnitude planes and writes one packed row
    assert lb["colormap"] == 10240 * (2 * 2047 * 4 + 1024 * 4)
    assert lb["ring"] == 0


@pytest.mark.parametrize("script", ["bench.py", "benchmarks/profile_push.py"])
def test_gpu_tools_refuse_the_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / script)], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs" in r.stderr and "GPU" in r.stderr
    assert '"metric"' not in r.stdout
