"""Public API: functional `upscale` plus a reference-compatible shim
(PyTorch port of ``libsrcnn_tpu/api.py``).

The reference exposes exactly two C functions (`libsrcnn.h:46-54`):
``ConfigureFilterSRCNN(filter, stepscale)`` writing process globals, and
``ProcessSRCNN(buf, w, h, d, multiply, ...)`` returning int codes.  The
port's API is :func:`upscale` (config-in/arrays-out, on an explicit
device); the shims :func:`configure_filter_srcnn` / :func:`process_srcnn`
reproduce the reference's stateful surface and error codes.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from .config import DEFAULT_CONFIG, FilterType, SRCNNConfig
from .models import srcnn_int8
from .models.srcnn import SRCNN915
from .models.srcnn_generic import SRCNNGeneric
from .ops.resize import scaled_size
from . import pipeline

__all__ = [
    "upscale",
    "configure_filter_srcnn",
    "process_srcnn",
    "FilterType",
    "SRCNNConfig",
]


def _as_u8_image(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)  # gray -> RGB, as the reference
        # test app normalizes inputs to RGB (`test.cpp:45-120`)
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"expected [H,W,3|4] image, got {img.shape}")
    return img


def _device(device: str | torch.device) -> torch.device:
    """The requested device; a CUDA request without a card raises (the
    port never carries on on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but no CUDA "
                           f"device is available")
    return dev


@functools.lru_cache(maxsize=64)
def _default_params(model: str, tier: str, head: int | None,
                    dev: torch.device) -> dict:
    """The shipped parameters of ``model`` at ``tier`` (an LR family's x
    ``head`` checkpoint) on ``dev``."""
    return pipeline.load_model_params(SRCNNConfig(model=model, compute_dtype=tier),
                                      head or 2.0, dev)


def _params_on(params, config: SRCNNConfig, dev: torch.device,
               scale: float) -> dict:
    """The parameters a pass of ``config`` at ``scale`` runs with, on
    ``dev``: the defaults (cached per model, tier, LR head and device) when
    ``params`` is None; a module's (:class:`.models.srcnn.SRCNN915`,
    :class:`.models.srcnn_generic.SRCNNGeneric`) ``params()``.  The int8
    tier takes the quantized pack with its dtypes (int8 weights, f32
    scales); the other tiers take f32 weights, and a family's spec rides
    along under ``"__spec__"``."""
    if params is None:
        return _default_params(config.model, config.compute_dtype,
                               pipeline.head_scale(config, scale), dev)
    if isinstance(params, (SRCNN915, SRCNNGeneric)):
        params = params.params()
    if config.compute_dtype == "int8":
        params = {k: (v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v)))
                  .to(dev) for k, v in params.items()}
        srcnn_int8.check_params(params)
        return params
    return {k: v if k == "__spec__" else torch.as_tensor(v, dtype=torch.float32).to(dev)
            for k, v in params.items()}


def upscale(
    image: np.ndarray,
    scale: float,
    config: SRCNNConfig = DEFAULT_CONFIG,
    params: dict | SRCNN915 | SRCNNGeneric | None = None,
    return_conv_map: bool | None = None,
    device: str | torch.device = "cuda",
):
    """Super-resolve an RGB(A) u8 image by ``scale``.

    Args:
      image: [H, W, 3|4] uint8 array (RGB or RGBA interleaved); [H, W]
        grayscale is promoted to RGB.
      scale: multiply factor (> 0); non-integer factors supported, output
        size truncates like the reference (`libsrcnn.cpp:662-663`).
      config: immutable run options (filter, step_scale, use_kernel, ...).
      params: ``config.model``'s params, OIHW tensors (see each model's
        ``params_from_jax``; a family's may carry its spec under
        ``"__spec__"``, else it comes from their shapes) or a module
        holding them (:class:`.models.srcnn.SRCNN915`,
        :class:`.models.srcnn_generic.SRCNNGeneric`); for srcnn at
        ``compute_dtype="int8"`` the quantized pack (see
        :func:`.models.srcnn_int8.params_from_jax`).  Defaults to the
        shipped weights of the model and tier (an LR family's head for
        ``scale``, or x2 under step-scale).
      return_conv_map: also return the u8 Y-channel conv3 map (a family's
        output plane); defaults to ``config.emit_conv_map``.
      device: where the pass runs.  ``"cuda"`` (default) raises when there
        is no card; CPU runs pass ``"cpu"``.

    Returns:
      ``out`` u8 numpy array [H', W', D], or ``(out, conv_map)`` when
      requested -- matching the reference's optional convbuff output
      (`libsrcnn.cpp:889-915`).

    Step-scale mode (`config.step_scale`) decomposes the factor into chained
    x2 passes with a u8 round-trip between passes, exactly like
    `ProcessSRCNN`'s else-branch (`libsrcnn.cpp:980-1061`) -- including its
    quantization-between-passes behavior.  An LR family chains its x2 head,
    and a fractional remainder pass raises its exact-scale error, as in the
    JAX package.
    """
    pipeline.check_supported(config)
    dev = _device(device)
    img = _as_u8_image(image)
    want_conv = config.emit_conv_map if return_conv_map is None else return_conv_map

    h, w, _ = img.shape
    if float(scale) <= 0.0 or min(scaled_size(w, h, scale)) <= 0:
        raise ValueError(f"invalid scale factor {scale}")
    params = _params_on(params, config, dev, scale)
    if config.self_ensemble:
        out, conv = _upscale_flip_ensemble(img, scale, config, params, dev)
        return (out, conv) if want_conv else out

    cur = torch.tensor(img, device=dev)
    if not config.step_scale:
        out, conv = pipeline.run_pass(cur, params, float(scale), config)
        out, conv = out.cpu().numpy(), conv.cpu().numpy()
        return (out, conv) if want_conv else out

    # --- step-scale: chained x2 passes (`libsrcnn.cpp:980-1061`) ---
    multiply = np.float32(scale)
    lf = np.fmod(multiply, np.float32(2.0))
    repeat = int(multiply / np.float32(2.0))
    if lf > 0.0:
        repeat += 1

    sw, sh = w, h
    out = conv = None
    final_ran = False
    for cnt in range(repeat):
        curmf = np.float32(2.0)
        if cnt + 1 == repeat:
            curmf = (np.float32(w) * multiply) / np.float32(sw)
            if curmf == 0.0 or curmf == 1.0:
                break
            final_ran = True
        out, conv = pipeline.run_pass(cur, params, float(curmf), config)
        cur = out  # stays on the device between passes (u8 quantization intact)
        if repeat > 1:
            sw = int(np.float32(sw) * curmf)
            sh = int(np.float32(sh) * curmf)

    # conv-map parity: the reference passes convbuff only to the FINAL
    # chain pass (`libsrcnn.cpp:1025-1029`); an early-broken chain (exact
    # remainder) therefore emits NO conv map even though the output is
    # the last completed pass's buffer (`:1058-1060`).
    if not final_ran:
        conv = None
    out = out.cpu().numpy() if out is not None else img.copy()
    conv = conv.cpu().numpy() if conv is not None else None
    return (out, conv) if want_conv else out


def _upscale_flip_ensemble(img: np.ndarray, scale, config: SRCNNConfig,
                           params: dict, dev: torch.device):
    """Flip self-ensemble (port of ``libsrcnn_tpu/api.py:129-173``): the 4
    flip variants of ``img`` through the pipeline, outputs unflipped and
    averaged in f32 before the u8 cast.

    Without step-scale all 4 variants go through ONE batched pass
    (``serve._ensemble_pass``, which holds the flip bookkeeping).
    Step-scale chains go through :func:`upscale` per variant and are
    averaged on the host (``np.rint``, ties to even).  Flips only (no
    transposes): 90-degree rotations swap H/W and would need a second set
    of resize tables for non-square frames."""
    base = dataclasses.replace(config, self_ensemble=False)
    if not base.step_scale:
        from . import serve

        out, conv = serve._ensemble_pass(torch.tensor(img, device=dev)[None],
                                         params, float(scale), base)
        return out[0].cpu().numpy(), conv[0].cpu().numpy()

    flips = ((False, False), (False, True), (True, False), (True, True))

    def flip(a, fy, fx):
        return a[::-1 if fy else 1, ::-1 if fx else 1]

    res = [upscale(np.ascontiguousarray(flip(img, fy, fx)), scale, base,
                   params, True, dev) for fy, fx in flips]
    outs, convs = [o for o, _ in res], [c for _, c in res]
    out = np.rint(np.mean(
        [flip(o, fy, fx).astype(np.float32)
         for (fy, fx), o in zip(flips, outs)], axis=0)).astype(np.uint8)
    if any(c is None for c in convs):
        # a degenerate chain (e.g. scale 1.0) ran zero passes: the plain
        # step path returns conv=None, so the ensemble does too
        return out, None
    conv = np.rint(np.mean(
        [flip(c, fy, fx).astype(np.float32)
         for (fy, fx), c in zip(flips, convs)], axis=0)).astype(np.uint8)
    return out, conv


# ---------------------------------------------------------------------------
# Reference-compatible stateful shim
# ---------------------------------------------------------------------------

_state_lock = threading.Lock()
_state = {"filter": FilterType.BICUBIC, "step_scale": False, "device": "cuda",
          "model": "srcnn"}


def configure_filter_srcnn(filter_type: FilterType | int, step_scale: bool = False,
                           device: str | torch.device = "cuda",
                           model: str = "srcnn") -> None:
    """Drop-in for ``ConfigureFilterSRCNN`` (`libsrcnn.cpp:930-941`) --
    process-global, but lock-protected unlike the reference.  Two options
    beyond the reference's: ``device`` is where later :func:`process_srcnn`
    calls run (``"cuda"`` without a card raises here), and ``model`` the
    model they run (``"srcnn"``, the reference's, or a family of the zoo
    at its ``float32`` tier)."""
    dev = _device(device)
    pipeline.check_supported(SRCNNConfig(model=model))
    with _state_lock:
        _state["filter"] = FilterType(int(filter_type))
        _state["step_scale"] = bool(step_scale)
        _state["device"] = dev
        _state["model"] = model


def process_srcnn(refbuff, w: int, h: int, d: int, multiply: float):
    """Drop-in for ``ProcessSRCNN`` (`libsrcnn.cpp:943-1064`).

    Args:
      refbuff: bytes / u8 array of interleaved RGB(A), length w*h*d.
      w, h, d: image geometry (d must be 3 or 4).
      multiply: scale factor.

    Returns:
      (retcode, outbuff, convbuff): retcode 0 on success, -1 for bad args,
      -2 for bad scale (matching `libsrcnn.cpp:951-966`; an LR family's
      head that cannot serve the factor raises its ``ValueError``, as
      :func:`upscale` does), -100 for a
      step-scale chain that runs no pass, -11 when the device or host runs
      out of memory for the output, -12 when the conv map's buffer cannot
      be allocated (the output is still handed back); outbuff/convbuff are
      flat u8 numpy arrays (or None on failure).
    """
    # The reference declares w/h/d `unsigned` (`libsrcnn.h:48-50`), so a
    # negative geometry is unrepresentable there; in Python we report it as
    # bad args (-1) like the NULL/zero check (`libsrcnn.cpp:951-952`).
    if refbuff is None or w <= 0 or h <= 0 or d <= 0:
        return -1, None, None
    if isinstance(refbuff, np.ndarray):
        if refbuff.dtype != np.uint8:
            # an unsafe cast would silently value-wrap (300 -> 44)
            return -1, None, None
        buf = refbuff.ravel()
    else:
        buf = np.frombuffer(bytes(refbuff), dtype=np.uint8)
    if buf.size != w * h * d:
        return -1, None, None
    m_w = np.float32(w) * np.float32(multiply)
    m_h = np.float32(h) * np.float32(multiply)
    if m_w <= 0.0 or m_h <= 0.0:
        return -2, None, None
    if int(m_w) < 1 or int(m_h) < 1:
        # output would be empty (e.g. 0 < w*multiply < 1): bad scale
        return -2, None, None
    if d not in (3, 4):
        # reference UB territory: depth<3 leaves doSRCNN's buffers
        # uninitialized (`libsrcnn.cpp:235-236`); we report bad args.
        return -1, None, None
    with _state_lock:
        cfg = SRCNNConfig(filter=_state["filter"], step_scale=_state["step_scale"],
                          model=_state["model"])
        device = _state["device"]
    if cfg.step_scale and np.float32(multiply) == np.float32(1.0):
        # reference parity: a step-scale chain whose single pass breaks
        # (curmf == 1) leaves retval = -100 and NULL buffers
        # (`libsrcnn.cpp:1004-1008,636`)
        return -100, None, None
    img = buf.reshape(h, w, d)
    # Allocation-failure parity (`libsrcnn.cpp:883,910`): -11 when the
    # output buffer cannot be allocated, on the host or on the card; -12
    # when the conv map's cannot, with the output already handed back
    # (`libsrcnn.cpp:895-912`).
    try:
        out, conv = upscale(img, multiply, cfg, return_conv_map=True,
                            device=device)
        out_flat = out.ravel()
    except (MemoryError, torch.cuda.OutOfMemoryError):
        return -11, None, None
    try:
        conv_flat = conv.ravel() if conv is not None else None
    except MemoryError:
        return -12, out_flat, None
    return 0, out_flat, conv_flat
