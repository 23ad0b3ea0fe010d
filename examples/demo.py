"""End-to-end demo: every major subsystem in ~80 lines.

Run: python examples/demo.py [out_dir]     (default: demo_out/ in the checkout)

1. Renders a chirp through the production pipeline and the golden CPU-law
   model side by side.
2. Runs a 64-stream batch with per-stream palettes.
3. Shows the oscilloscope envelope and spectrum-analyzer levels.
4. Saves/loads a checkpoint mid-stream.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax.numpy as jnp

import spectrogram_tpu as sg
from spectrogram_tpu.io.sources import ChirpSource
from spectrogram_tpu.models.golden import GoldenSpectrogram
from spectrogram_tpu.models.oscilloscope import Oscilloscope
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu.models.spectrum_analyzer import SpectrumAnalyzer
from spectrogram_tpu.ops import stft as stft_ops
from spectrogram_tpu.utils import checkpoint
from spectrogram_tpu.utils.compile_cache import enable_compile_cache
from spectrogram_tpu.utils.image import save_png

enable_compile_cache()
out_dir = pathlib.Path(
    sys.argv[1] if len(sys.argv) > 1
    else pathlib.Path(__file__).resolve().parent.parent / "demo_out"
)
out_dir.mkdir(parents=True, exist_ok=True)

cfg = sg.SpectrogramConfig(sample_rate=48_000.0, viewport_height=512)
pcm = ChirpSource(cfg.sample_rate, f0=100, f1=12_000, duration=2.0).next_block(
    int(2.0 * cfg.sample_rate)
)

# 1a. production path
pipe = SpectrogramPipeline(cfg, store_ring=False)
rgba = np.asarray(pipe.process(jnp.asarray(pcm), palette_id=sg.scheme_index("Magma")))
rgb = np.asarray(pipe.composite(jnp.asarray(rgba)[None], jnp.asarray([1])))[0]
save_png(out_dir / "production.png", rgb)

# 1b. golden CPU-law path (cubic band means) — lower hop rate, it is scalar
golden_cfg = sg.SpectrogramConfig(
    sample_rate=48_000.0, viewport_height=256, hop_period=0.02
)
golden = GoldenSpectrogram(golden_cfg)
gold_rgba = golden.render(pcm[: int(0.8 * cfg.sample_rate)])
save_png(out_dir / "golden.png", golden.composite(gold_rgba))

# 2. 64-stream batch, one palette per stream
batch_pipe = SpectrogramPipeline(cfg, chunk_hops=8, viewport_rows=256)
state = batch_pipe.init_state(64)
state = batch_pipe.set_palette(state, jnp.arange(64) % 19)
tones = np.stack(
    [
        0.4 * np.sin(2 * np.pi * (100 * (s + 1)) * np.arange(batch_pipe.chunk_size) / cfg.sample_rate)
        for s in range(64)
    ]
)
chunk = jnp.asarray(np.stack([tones, tones], axis=-1).astype(np.float32))
for _ in range(16):
    state, rows = batch_pipe.push(state, chunk)
strip = np.asarray(batch_pipe.render_viewport(state))[:8, :, ::8]  # 8 streams
save_png(out_dir / "batch_strip.png", strip.reshape(-1, strip.shape[2], 4)[..., :3])

# 3. oscilloscope + analyzer on the chirp
scope = Oscilloscope(push_size=4096)
sstate = scope.init_state(1)
sstate = scope.push(sstate, jnp.asarray(pcm[None, :4096]))
env = np.asarray(scope.envelope(sstate, width=512))[0]
print("oscilloscope envelope:", env.shape, "peak", float(env.max()))

ana = SpectrumAnalyzer(cfg)
rows = stft_ops.stft_rows(jnp.asarray(pcm[None, : cfg.window_size + 1]), cfg)
levels = ana.push_rows(ana.init_levels(1), rows)
print("analyzer bands > 0.5:", int((np.asarray(levels) > 0.5).sum()))

# 4. checkpoint round trip
checkpoint.save_state(out_dir / "ckpt", state, cfg)
restored = checkpoint.load_state(out_dir / "ckpt", batch_pipe)
print("checkpoint ok, cursor", int(restored.cursor), "rows", int(restored.row_count))
print("wrote", sorted(p.name for p in out_dir.iterdir()))
