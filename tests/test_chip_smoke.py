"""chip_smoke.py off the card: it must refuse to run (exit non-zero, print
no result) without a GPU or outside a checkout, and each of its phases must
run at a tiny size when handed a CPU device."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

from spectrogram_tpu.config import SpectrogramConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

TINY = {"4096": SpectrogramConfig(sample_rate=48_000.0,
                                  window_period=2048 / 48_000.0,
                                  hop_period=800 / 48_000.0,
                                  viewport_height=128)}


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                          env=env, capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_a_gpu():
    r = _run(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        cs.check_device(1)


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_phase_served_tiny(cpu):
    out = cs.phase_served(cpu, n_streams=8, pushes=3)
    assert out["rows"] == 8 * 5 and out["p50_ms"] > 0
    assert out["budget_ms"] == pytest.approx(1e3 * 800 / 48_000)


def test_phase_ring_tiny(cpu):
    out = cs.phase_ring(cpu, n_streams=4, pushes=2, render_streams=2,
                        viewport_rows=64)
    assert out["ring_bytes"] == 4 * 64 * 2 * 2399 * 2


def test_phase_multirate_tiny(cpu):
    out = cs.phase_multirate(cpu, capacity=2, ticks=2)
    assert out["fft"] == {44_100.0: 4410, 48_000.0: 4800, 96_000.0: 9600}
    # 2205-sample windows have no even-n1 plan: that group takes jnp.fft
    assert out["stft"][44_100.0] == "xla" and out["stft"][96_000.0] == "mxu"


def test_phase_parity_tiny(cpu):
    out = cs.phase_parity(cpu, cpu, n_streams=2, pushes=2, chunk_hops=4,
                          geometries=TINY)
    assert out["4096"]["xla_vs_ref"][0] == 0.0  # same backend, same device
    assert out["4096"]["mxu_vs_ref"][0] <= cs.TOLERANCE_U8


def test_phase_streaming_tiny(cpu):
    out = cs.phase_streaming(cpu, n_streams=2, pushes=2, chunk_hops=4,
                             geometries=TINY)
    assert out["4096"][0] is True  # exact on the CPU


def test_phase_gpu_tests_call_every_case(cpu):
    assert cs.phase_gpu_tests(cpu) == 3


def test_phase_mesh_tiny():
    out = cs.phase_mesh(jax.devices()[:4], per_device=4, pushes=2)
    assert out == {**out, "devices": 4, "streams": 16, "bitwise": True}


def test_result_line_is_the_contract_json(capsys, monkeypatch):
    """main() ends with the one JSON line; phases are stubbed here."""
    from spectrogram_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "off")
    monkeypatch.setattr(cs, "check_device", lambda count: jax.devices()[:count])
    for name in ("phase_served", "phase_ring", "phase_multirate",
                 "phase_streaming", "phase_gpu_tests"):
        monkeypatch.setattr(cs, name, lambda *a, **k: {})
    monkeypatch.setattr(cs, "phase_parity", lambda *a, **k: {})
    assert cs.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    doc = json.loads(last)
    assert doc["ok"] is True
    assert doc["device"] == {"platform": "cpu",
                             "kind": jax.devices()[0].device_kind,
                             "count": len(jax.devices())}
