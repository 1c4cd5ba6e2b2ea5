"""Streaming / batched serving: video frames through the pipeline (PyTorch
port of ``libsrcnn_tpu/serve.py``).

* :func:`upscale_frames` -- batched API over [N, H, W, D] u8 clips: one
  pass per clip, so the clip's Y planes go to the kernel in one launch.
* :class:`VideoUpscaler` -- streaming loop that keeps one frame in flight:
  CUDA launches are asynchronous, so the host uploads and dispatches frame
  t+1 while the card runs frame t.

Every model and tier the port runs is served (srcnn at its four tiers, the
zoo's families at ``float32`` and ``bfloat16``), and the flip
self-ensemble too.  The serve paths run one pass per frame, so step-scale
is refused; sharding a clip over several cards (``mesh=``) is ROADMAP
M14.
"""

from __future__ import annotations

import dataclasses
import logging
import time

from collections.abc import Iterable, Iterator

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SRCNNConfig
from . import api, pipeline


def _reject_step_scale(config: SRCNNConfig) -> None:
    """The serve paths run ONE pass per frame; silently skipping the
    reference's chained-x2 step-scale recipe (`libsrcnn.cpp:980-1061`)
    would produce different pixels than api.upscale with the same
    config, so reject it explicitly (use api.upscale per frame)."""
    if config.step_scale:
        raise ValueError(
            "step_scale is not supported by the serving paths (they "
            "dispatch one pass per frame); call api.upscale per frame "
            "for chained-x2 semantics")


def _as_u8_clip(frames) -> np.ndarray:
    clip = np.asarray(frames)
    if clip.dtype != np.uint8:
        raise TypeError(f"expected a uint8 clip, got {clip.dtype}")
    if clip.ndim != 4 or clip.shape[-1] not in (3, 4):
        raise ValueError(f"expected a [N,H,W,3|4] clip, got {clip.shape}")
    return clip


def upscale_frames(frames: np.ndarray, scale: float = 2.0,
                   config: SRCNNConfig = DEFAULT_CONFIG,
                   params=None, mesh=None,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Upscale a [N, H, W, D] u8 clip in one batched pass (with
    ``config.self_ensemble``, one pass over its 4N flips); returns
    [N, H', W', D] u8.  Each frame equals ``api.upscale`` of it with the
    same config, bit for bit.  ``device``: where the pass runs (``"cpu"``
    for CPU runs); ``mesh`` is not ported yet."""
    _reject_step_scale(config)
    if mesh is not None:
        raise NotImplementedError(
            "upscale_frames(mesh=...) is not ported yet (ROADMAP M14)")
    pipeline.check_supported(config)
    dev = api._device(device)
    clip = _as_u8_clip(frames)
    params = api._params_on(params, config, dev, scale)
    x = torch.tensor(clip, device=dev)
    if config.self_ensemble:
        out, _ = _ensemble_pass(x, params, float(scale), config)
    else:
        out, _ = pipeline.run_pass(x, params, float(scale), config)
    return out.cpu().numpy()


def _ensemble_pass(frames: torch.Tensor, params: dict, scale: float,
                   config: SRCNNConfig):
    """Flip self-ensemble of a [N,H,W,D] u8 clip on its device: the 4 flip
    variants of every frame through ONE batched pass, unflipped and
    averaged in f32 before the u8 cast (``torch.round`` rounds ties to
    even, as ``jnp.round`` does, `serve.py:122-134` of the JAX package).
    Returns (out [N,H',W',D], conv [N,H',W']) u8."""
    base = dataclasses.replace(config, self_ensemble=False)
    n = frames.shape[0]
    # [N, 4, H, W, D]: identity, flip W, flip H, flip both
    v = torch.stack([frames, frames.flip(2), frames.flip(1),
                     frames.flip(1, 2)], dim=1)
    outs, convs = pipeline.run_pass(v.reshape(4 * n, *frames.shape[1:]),
                                    params, scale, base)

    def unflip_mean(a):
        a = a.reshape(n, 4, *a.shape[1:])
        back = torch.stack([a[:, 0], a[:, 1].flip(2), a[:, 2].flip(1),
                            a[:, 3].flip(1, 2)], dim=1)
        return torch.round(back.to(torch.float32).mean(dim=1)).to(torch.uint8)

    return unflip_mean(outs), unflip_mean(convs)


class VideoUpscaler:
    """Streaming upscaler: overlaps host frame feed with device compute.

    >>> up = VideoUpscaler(scale=2.0)
    >>> for out in up.stream(frame_iter):
    ...     sink(out)
    """

    #: transient device errors are retried this many times per frame before
    #: propagating (the reference has no failure handling at all, SURVEY.md
    #: section 5)
    max_retries: int = 2
    #: first retry waits this long; each subsequent retry doubles it
    retry_backoff_s: float = 0.05

    def __init__(self, scale: float = 2.0,
                 config: SRCNNConfig = DEFAULT_CONFIG,
                 params=None, device: str | torch.device = "cuda"):
        _reject_step_scale(config)
        pipeline.check_supported(config)
        self.scale = float(scale)
        self.config = config
        self.device = api._device(device)
        self.params = api._params_on(params, config, self.device, scale)

    def _run_one(self, frame: np.ndarray, sync: bool = False):
        """Dispatch one frame's pass; returns the device tensor, or (with
        ``sync``) the fetched u8 array.

        Only ``torch.AcceleratorError`` is retried: an error the device
        runtime raised that leaves the CUDA context usable.  A sticky CUDA
        error poisons the context, and every retry of it fails the same
        way until ``max_retries`` is spent.  Deterministic failures
        (``ValueError``, ``TypeError``) propagate at once."""
        last_err = None
        for attempt in range(self.max_retries + 1):
            try:
                img = torch.tensor(api._as_u8_image(frame), device=self.device)
                if self.config.self_ensemble:
                    out = _ensemble_pass(img[None], self.params, self.scale,
                                         self.config)[0][0]
                else:
                    out = pipeline.run_pass(img, self.params, self.scale,
                                            self.config)[0]
                # sync=True fetches INSIDE the retry scope, so failures that
                # surface only when the result is read are retried too --
                # the slow path; stream() keeps the fast path asynchronous
                # and comes here only on error
                return out.cpu().numpy() if sync else out
            except torch.AcceleratorError as e:
                last_err = e
                if attempt < self.max_retries:
                    wait = self.retry_backoff_s * (2 ** attempt)
                    logging.getLogger(__name__).warning(
                        "device error on frame dispatch (attempt %d/%d), "
                        "retrying in %.2fs: %s", attempt + 1,
                        self.max_retries, wait, e)
                    time.sleep(wait)
        raise last_err

    def stream(self, frames: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Yield upscaled frames; keeps one frame in flight on the device
        (launches are asynchronous, so the host prepares frame t+1 while
        the card processes frame t)."""
        pending = None
        for frame in frames:
            cur = self._run_one(frame)
            if pending is not None:
                yield self._materialize(*pending)
            pending = (frame, cur)
        if pending is not None:
            yield self._materialize(*pending)

    def _materialize(self, frame: np.ndarray, result) -> np.ndarray:
        """Device -> host fetch with the retry policy: launches are
        asynchronous, so a failed execution raises HERE, not in _run_one --
        re-run the frame synchronously through the retry loop then."""
        try:
            return result.cpu().numpy()
        except torch.AcceleratorError:
            return self._run_one(frame, sync=True)

    def stream_from_ring(self, ring, frame_shape: tuple[int, int, int],
                         stop=lambda: False) -> Iterator[np.ndarray]:
        """Consume u8 frames from a ring buffer (a producer thread pushes
        raw buffers); yields upscaled frames until ``stop()`` and the ring
        drains.  ``ring`` is any object with ``pop()`` (a u8 buffer, or
        None when empty) and ``len()``, such as the JAX package's native
        ``FrameRing``."""
        h, w, d = frame_shape

        def gen():
            while True:
                buf = ring.pop()
                if buf is None:
                    if stop() and len(ring) == 0:
                        return
                    time.sleep(0.001)
                    continue
                yield np.asarray(buf).reshape(h, w, d)

        yield from self.stream(gen())
