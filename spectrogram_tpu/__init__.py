"""spectrogram-tpu: accelerator-batched live audio spectrogram framework.

Capabilities of `spectrogram-rs` (Rust/GTK/FFTW/OpenGL), rebuilt in JAX:
push raw PCM frames in, get log-frequency colormapped spectrogram rows out,
batched over thousands of concurrent streams (jax / XLA / shard_map).
"""

from spectrogram_tpu.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu.color.colorscheme import (
    DEFAULT_COLOR_SCHEMES,
    ColorScheme,
    scheme_by_name,
    scheme_index,
    stacked_backgrounds,
    stacked_lookup_tables,
)
from spectrogram_tpu.ops.stft import stft_frame, stft_rows, hann_window
from spectrogram_tpu.ops.colormap import (
    colormap_rows,
    composite_over_background,
    resample_matrix,
    rgba_f32_to_u8,
)


def __getattr__(name):
    # Lazy heavyweight exports: importing the package stays cheap for tools
    # that only need config/palettes.
    if name == "SpectrogramPipeline":
        from spectrogram_tpu.models.spectrogram import SpectrogramPipeline

        return SpectrogramPipeline
    if name == "LiveSession":
        from spectrogram_tpu.session import LiveSession

        return LiveSession
    if name == "StreamGroupManager":
        from spectrogram_tpu.models.multirate import StreamGroupManager

        return StreamGroupManager
    if name == "DeviceFeeder":
        from spectrogram_tpu.io.feeder import DeviceFeeder

        return DeviceFeeder
    if name == "ChunkPool":
        from spectrogram_tpu.io.feeder import ChunkPool

        return ChunkPool
    if name == "FactoredScheme":
        from spectrogram_tpu.color.colorscheme import FactoredScheme

        return FactoredScheme
    raise AttributeError(name)

__version__ = "0.1.0"

__all__ = [
    "BENCH_CONFIG",
    "DEFAULT_CONFIG",
    "SpectrogramConfig",
    "DEFAULT_COLOR_SCHEMES",
    "ColorScheme",
    "scheme_by_name",
    "scheme_index",
    "stacked_backgrounds",
    "stacked_lookup_tables",
    "stft_frame",
    "stft_rows",
    "hann_window",
    "colormap_rows",
    "composite_over_background",
    "resample_matrix",
    "rgba_f32_to_u8",
    "SpectrogramPipeline",
    "LiveSession",
    "StreamGroupManager",
    "DeviceFeeder",
    "ChunkPool",
    "FactoredScheme",
    "__version__",
]
