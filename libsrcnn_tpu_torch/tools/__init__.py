"""The kernel-profiling tools, run as ``python -m
libsrcnn_tpu_torch.tools.<name>``: :mod:`.trace_kernel`,
:mod:`.kernel_ablation` and :mod:`.int8_ablation`."""
