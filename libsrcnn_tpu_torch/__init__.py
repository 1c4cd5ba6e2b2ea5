"""libsrcnn_tpu_torch -- the PyTorch / CUDA port of libsrcnn_tpu.

SRCNN 9-1-5 super-resolution with classical interpolation upscaling, on an
NVIDIA H100: the main path (``upscale`` with the default config: srcnn,
bicubic, the exact float32 tier) runs color conversion and resize as
PyTorch ops and the fused conv stack as a hand-written CUDA kernel
(:mod:`.kernels.fused_conv`).  The JAX package ``libsrcnn_tpu`` is the
reference the port is tested against; this package never imports jax.
"""

from .config import DEFAULT_CONFIG, FilterType, SRCNNConfig
from .api import configure_filter_srcnn, process_srcnn, upscale

__version__ = "0.1.0"
SRCNN_VERSION = 0x00010A28  # the reference's numeric macro (`libsrcnn.h:35`)

__all__ = [
    "DEFAULT_CONFIG",
    "FilterType",
    "SRCNNConfig",
    "SRCNN_VERSION",
    "configure_filter_srcnn",
    "process_srcnn",
    "upscale",
    "__version__",
]
