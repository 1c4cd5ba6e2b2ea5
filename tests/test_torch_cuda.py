"""The port on the card: the CUDA kernel against its plain version, and the
kernel path against the plain path.

Every test here needs an NVIDIA GPU and skips without one; the CUDA kernel
has no CPU mode.  This file imports no jax, so it also runs where jax is
not installed (tests/conftest.py does import it; skip it there):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

import os

import numpy as np
import pytest
import torch

import libsrcnn_tpu_torch as lt
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn

pytestmark = pytest.mark.cuda

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
ATOL = 2e-3  # f32 sums in another order than cuDNN's


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _plane(h, w, seed, device):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = 128 + 60 * np.sin(0.05 * yy + 0.03 * xx) + rng.normal(0, 8, (h, w))
    return torch.from_numpy(np.clip(f, 0, 255).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape,flags", [
    ((3, 3), None), ((1, 70), None), ((70, 1), None), ((5, 2), None),
    ((33, 47), None), ((130, 250), None), ((130, 250), (0, 1, 0, 1)),
    ((67, 45), (1, 0, 1, 0)), ((40, 40), (0, 0, 0, 0)),
    ((61, 181), (1, 0, 0, 1)),
])
def test_kernel_matches_plain_version(cuda, shape, flags):
    h, w = shape
    p = srcnn.load_params(cuda)
    y = _plane(h + 12, w + 12, 10, cuda)
    before = fused_conv.launches
    got = fused_conv.forward_y(p, y, h, w, flags)
    torch.cuda.synchronize()
    assert fused_conv.launches == before + 1
    ref = fused_conv.forward_y_reference(p, y, h, w, flags)
    assert got.shape == (h, w)
    assert float((got - ref).abs().max()) <= ATOL


def test_kernel_rejects_non_contiguous_plane(cuda):
    p = srcnn.load_params(cuda)
    y = _plane(32, 64, 11, cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv.forward_y(p, y, 20, 20)


@pytest.mark.parametrize("scale,filt,step", [(2.0, 2, False), (1.37, 3, False),
                                             (4.0, 2, True), (0.5, 1, False)])
def test_kernel_path_matches_plain_path(cuda, scale, filt, step):
    img = np.random.default_rng(12).integers(0, 256, (61, 47, 3), dtype=np.uint8)
    cfg = lt.SRCNNConfig(filter=lt.FilterType(filt), step_scale=step)
    plain = lt.SRCNNConfig(filter=lt.FilterType(filt), step_scale=step,
                           use_kernel=False)
    before = fused_conv.launches
    out, conv = lt.upscale(img, scale, cfg, return_conv_map=True, device=cuda)
    assert fused_conv.launches > before
    pout, pconv = lt.upscale(img, scale, plain, return_conv_map=True, device=cuda)
    assert np.abs(out.astype(int) - pout.astype(int)).max() <= 1
    assert np.abs(conv.astype(int) - pconv.astype(int)).max() <= 1


@pytest.mark.parametrize("idx", [0, 10, 14, 23])
def test_goldens_through_kernel(cuda, idx):
    z = np.load(GOLDENS)
    key, name, mult, filt, step, _ms = str(z["meta"][idx]).split(",")
    cfg = lt.SRCNNConfig(filter=lt.FilterType(int(filt)), step_scale=bool(int(step)))
    out, conv = lt.upscale(z[f"in_{name}"], float(mult), cfg,
                           return_conv_map=True, device=cuda)
    d = np.abs(out.astype(int) - z[f"out_{key}"].astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.02
    assert np.abs(conv.astype(int) - z[f"conv_{key}"].astype(int)).max() <= 1
