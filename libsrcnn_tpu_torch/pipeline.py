"""End-to-end single-pass upscale pipeline (the `doSRCNN` equivalent),
PyTorch port of ``libsrcnn_tpu/pipeline.py``.

One pass: u8 image on the device -> planar f32 YCbCr -> band resample ->
the model (SRCNN 9-1-5, or a family of the zoo) on Y -> u8 out.  PyTorch
runs eagerly, so there is no compiled program per shape; what a shape
needs from the host (the f64 resize tables, as device index / weight
tensors) is built once and cached in :mod:`.ops.resize`.

On the kernel path the Y resize emits the conv stack's 6 px halo plane
directly (``resize_plane_padded``) and a fused CUDA kernel consumes it: K1
for the exact ``float32`` tier, K2 (split-bf16x2) for ``bfloat16``, K3
(bf16x1) for ``bfloat16_fast`` (`libsrcnn_tpu/pipeline.py:181-209`), K4
(int8 GEMMs) for ``int8`` (`:167-175`).  Otherwise -- ``use_kernel=False``,
or a CPU tensor -- the Y plane goes through the plain convs: for both bf16
tiers the JAX package's XLA twin (bf16-rounded input, h1 and h2; f32
accumulation), as the JAX package does off the TPU, and for ``int8``
``models/srcnn_int8`` (`:176-180`).  So on the CPU the ``bfloat16`` tier
matches the JAX package's CPU output, not the split math K2 computes on
the card; the int8 tier's plain convs are exact, and K4 equals them bit
for bit.

The model zoo (`:156-166`) runs its families on the same color and resize
ops: the HR families (``vdsr``, ``srcnn955``) refine the classically
resized Y plane, the LR families (``fsrcnn``, ``espcn``) upscale the
source Y plane with their learned heads.  Their convs are library convs
(:mod:`.ops.conv`), as the JAX package's are XLA convs, at the two family
tiers of :func:`family_precision`.

A pass takes one frame ``[H, W, D]`` or a clip ``[N, H, W, D]``: the
batch dimension rides through color and resize, and the clip's Y planes go
to the kernel in one launch.  The plain convs and the families run one
plane at a time.
"""

from __future__ import annotations

import torch

from .config import FilterType, SRCNNConfig, chroma_filter
from .kernels import fused_conv
from .models import espcn, fsrcnn, srcnn, srcnn_generic, srcnn_int8, vdsr
from .ops import color, resize

#: valid srcnn compute tiers of the JAX package
SRCNN_TIERS = ("float32", "bfloat16", "bfloat16_fast", "int8")

#: srcnn float tier -> GEMM mode of the fused kernel
#: (`libsrcnn_tpu/pipeline.py:191-193`); ``int8`` has its own kernel, K4
KERNEL_PRECISION = {"float32": "exact", "bfloat16": "split",
                    "bfloat16_fast": "bf16x1"}
#: model families that run at LOW resolution with a learned upscale head
#: (``forward_lr``); one checkpoint per integer factor
LR_FAMILIES = ("fsrcnn", "espcn")
#: learned families that, like srcnn, refine the classically interpolated
#: plane (``forward_hr``): one checkpoint serves every factor
HR_FAMILIES = ("vdsr", "srcnn955")
#: model name -> its module
FAMILY_MODULES = {"fsrcnn": fsrcnn, "espcn": espcn, "vdsr": vdsr,
                  "srcnn955": srcnn_generic}


def validate_compute_dtype(cfg: SRCNNConfig) -> None:
    """Reject unknown srcnn tiers up front, before weights load or any
    compute branch runs (`libsrcnn_tpu/pipeline.py:52-60`)."""
    if cfg.model == "srcnn" and cfg.compute_dtype not in SRCNN_TIERS:
        raise ValueError(
            f"srcnn compute_dtype={cfg.compute_dtype!r} is not a tier: "
            f"use one of {SRCNN_TIERS}")


def family_precision(compute_dtype: str) -> str:
    """The conv precision of a family tier (`libsrcnn_tpu/pipeline.py:71-81`):
    ``float32`` -> ``"exact"``, ``bfloat16`` -> ``"bf16"`` (bf16 operands,
    exact products, f32 accumulation, on every device; see
    :mod:`.ops.conv`)."""
    if compute_dtype == "float32":
        return "exact"
    if compute_dtype == "bfloat16":
        return "bf16"
    raise ValueError(
        f"compute_dtype={compute_dtype!r} is only supported by the srcnn "
        f"model; the fsrcnn/espcn/vdsr families take 'float32' or "
        f"'bfloat16'")


def check_supported(cfg: SRCNNConfig) -> None:
    """Raise ``ValueError`` for a config the JAX package rejects: an unknown
    model, an srcnn tier that is not one, a family tier other than
    ``float32`` / ``bfloat16``."""
    if cfg.model == "srcnn":
        validate_compute_dtype(cfg)
    elif cfg.model in FAMILY_MODULES:
        family_precision(cfg.compute_dtype)
    else:
        raise ValueError(f"unknown model {cfg.model!r}")


def head_scale(cfg: SRCNNConfig, scale: float) -> int | None:
    """The factor of the checkpoint an LR family loads for ``scale``
    (`libsrcnn_tpu/pipeline.py:84-107`): x2 under step-scale, which chains
    x2 passes, ``int(scale)`` otherwise; None for the other models."""
    if cfg.model not in LR_FAMILIES:
        return None
    return 2 if cfg.step_scale else int(scale)


def load_model_params(cfg: SRCNNConfig, scale: float = 2.0,
                      device: str | torch.device = "cpu") -> dict:
    """Default parameters of ``cfg`` on ``device`` (port of
    `libsrcnn_tpu/pipeline.py:84-107`): a family's shipped checkpoint with
    its spec under ``"__spec__"`` (an LR family's head for
    :func:`head_scale`), srcnn's int8 pack at the int8 tier, else the
    9-1-5 f32 weights, which every srcnn float tier takes (the bf16 tiers
    round them in the convs and kernels)."""
    check_supported(cfg)
    if cfg.model in FAMILY_MODULES:
        fparams, spec = FAMILY_MODULES[cfg.model].load_params(
            scale=head_scale(cfg, scale), device=device)
        return dict(fparams, __spec__=spec)
    if cfg.compute_dtype == "int8":
        return srcnn_int8.load_params(device)
    return srcnn.load_params(device)


def prepare_model_params(cfg: SRCNNConfig, params: dict, h: int, w: int,
                         dst_h: int, dst_w: int, multiply):
    """Split a family's spec off its parameters and check the geometry
    (`libsrcnn_tpu/pipeline.py:110-132`): returns (params, spec), the spec
    None for srcnn.  An LR head takes its own scale exactly; without a
    ``"__spec__"`` entry the spec comes from the parameters' shapes."""
    check_supported(cfg)
    if cfg.model == "srcnn":
        return params, None
    mod = FAMILY_MODULES[cfg.model]
    spec = params.get("__spec__")
    params = {k: v for k, v in params.items() if k != "__spec__"}
    spec = spec or mod.spec_of(params)
    if cfg.model in LR_FAMILIES and (dst_h, dst_w) != (h * spec.scale, w * spec.scale):
        raise ValueError(
            f"{cfg.model} x{spec.scale} weights require scale {spec.scale} "
            f"exactly; got {multiply} ({w}x{h} -> {dst_w}x{dst_h})")
    return params, spec


def resolve_kernel(use_kernel: bool | None, device: torch.device) -> bool:
    """``None`` -> the fused CUDA kernel for a CUDA device, the plain convs
    for the CPU.  ``True`` off CUDA raises: the CPU never stands in for
    the kernel."""
    if use_kernel is None:
        return device.type == "cuda"
    if use_kernel and device.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA device, got {device}")
    return bool(use_kernel)


def _per_plane(fn, planes: torch.Tensor) -> torch.Tensor:
    """``fn`` on [H, W] planes one at a time (a [N, H, W] stack or one
    plane), so that a clip equals its frames bit for bit whatever algorithm
    a batch would pick, and a family's activations stay one plane deep."""
    return torch.stack([fn(p) for p in planes]) if planes.dim() == 3 else fn(planes)


def _single_pass(img_u8: torch.Tensor, params: dict, *, dst_h: int, dst_w: int,
                 filter_type: FilterType, use_kernel: bool,
                 compute_dtype: str = "float32", model: str = "srcnn",
                 spec=None):
    """[..., H,W,D] u8 -> ([..., dst_h,dst_w,D] u8, [..., dst_h,dst_w] u8),
    on the image's device; ``...`` is empty or one batch dimension.

    Mirrors `doSRCNN` (`libsrcnn.cpp:628-923`): the second output is the
    truncated-u8 conv3 map (`:889-915`), for a family its model's output.
    An LR family's Y skips the classical resize and goes through its
    low-resolution stack and learned head; an HR family's refines the
    resized plane (`libsrcnn_tpu/pipeline.py:156-166`).  Chroma keeps the
    reference's classical policy for every model.
    """
    d = img_u8.shape[-1]
    planes = color.rgb_to_ycbcr(img_u8)  # [D,...,H,W] f32

    y_filter = FilterType(filter_type)
    c_filter = chroma_filter(y_filter)
    rest = [resize.resize_plane(planes[c], dst_h, dst_w, c_filter)
            for c in range(1, d)]

    if model in LR_FAMILIES:
        prec = family_precision(compute_dtype)
        y_sr = _per_plane(lambda p: FAMILY_MODULES[model].forward_lr(
            params, p, spec, precision=prec), planes[0])
    elif model in HR_FAMILIES:
        prec = family_precision(compute_dtype)
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        y_sr = _per_plane(lambda p: FAMILY_MODULES[model].forward_hr(
            params, p, spec, precision=prec), y_r)
    elif use_kernel:
        halo = fused_conv.HALO
        y_r = resize.resize_plane_padded(planes[0], dst_h, dst_w, y_filter,
                                         halo, dst_h + 2 * halo,
                                         dst_w + 2 * halo)
        if compute_dtype == "int8":
            y_sr = fused_conv.forward_y_int8(params, y_r, dst_h, dst_w)
        else:
            y_sr = fused_conv.forward_y(params, y_r, dst_h, dst_w,
                                        precision=KERNEL_PRECISION[compute_dtype])
    else:
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        if compute_dtype == "int8":
            y_sr = _per_plane(lambda p: srcnn_int8.forward_y(params, p), y_r)
        else:
            y_sr = _per_plane(lambda p: srcnn.forward_y(params, p, compute_dtype), y_r)

    out_u8 = color.ycbcr_to_rgb(torch.stack([y_sr, *rest], dim=0))
    # the model's output is already clamped to [0,255]; truncating u8 cast
    # (`libsrcnn.cpp:897-901`)
    conv_u8 = torch.floor(y_sr).to(torch.uint8)
    return out_u8, conv_u8


def run_pass(img_u8: torch.Tensor, params: dict, multiply: float,
             cfg: SRCNNConfig):
    """One resize+model pass of a [H,W,D] u8 frame, or of a [N,H,W,D] clip
    in one batched pass (one kernel launch for its Y planes); returns
    (out_u8, conv_u8) tensors on the image's device.  ``params`` are
    ``cfg.model``'s (a family's with or without ``"__spec__"``).
    ``cfg.self_ensemble`` is the caller's business (``api`` / ``serve``)."""
    check_supported(cfg)
    if img_u8.dim() not in (3, 4):
        raise ValueError(f"expected [H,W,D] or [N,H,W,D], got {list(img_u8.shape)}")
    h, w, _ = img_u8.shape[-3:]
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    if dst_w <= 0 or dst_h <= 0:
        raise ValueError(f"bad scale {multiply} for {w}x{h}")
    params, spec = prepare_model_params(cfg, params, h, w, dst_h, dst_w, multiply)
    return _single_pass(img_u8, params, dst_h=dst_h, dst_w=dst_w,
                        filter_type=cfg.filter,
                        use_kernel=resolve_kernel(cfg.use_kernel,
                                                  img_u8.device),
                        compute_dtype=cfg.compute_dtype, model=cfg.model,
                        spec=spec)
