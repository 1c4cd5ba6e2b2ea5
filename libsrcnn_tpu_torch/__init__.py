"""libsrcnn_tpu_torch -- the PyTorch / CUDA port of libsrcnn_tpu.

SRCNN 9-1-5 super-resolution with classical interpolation upscaling, on an
NVIDIA H100: ``upscale`` (srcnn, any filter, the exact ``float32`` tier,
the ``bfloat16`` / ``bfloat16_fast`` throughput tiers or the ``int8``
tier, the flip self-ensemble) runs color conversion and resize as PyTorch
ops and the fused conv stack as a hand-written CUDA kernel
(:mod:`.kernels.fused_conv`); the model zoo's families (``vdsr``,
``srcnn955``, ``fsrcnn``, ``espcn``, at ``float32`` and ``bfloat16``) run
their convs as library convs (:mod:`.ops.conv`); :mod:`.serve` batches video clips
(``upscale_frames``) and streams frames (``VideoUpscaler``);
``upscale_chunked`` streams a frame too large for the device through it in
row bands.  The JAX package ``libsrcnn_tpu`` is the reference the port is
tested against; this package never imports jax.
"""

from .config import DEFAULT_CONFIG, FilterType, SRCNNConfig
from .api import configure_filter_srcnn, process_srcnn, upscale
from .chunked import upscale_chunked
from .serve import VideoUpscaler, upscale_frames

__version__ = "0.1.0"
SRCNN_VERSION = 0x00010A28  # the reference's numeric macro (`libsrcnn.h:35`)

__all__ = [
    "DEFAULT_CONFIG",
    "FilterType",
    "SRCNNConfig",
    "SRCNN_VERSION",
    "VideoUpscaler",
    "configure_filter_srcnn",
    "process_srcnn",
    "upscale",
    "upscale_chunked",
    "upscale_frames",
    "__version__",
]
