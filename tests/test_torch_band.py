"""K5, the row-band bf16x1 kernel (``fused_conv.forward_y_band``), on the
CPU vs the JAX package.

K5's plain version is K3's (``forward_y_reference(precision="bf16x1")``):
the band geometry changes nothing a pixel computes, as the JAX package's
``_kernel_band`` is bit-identical to its column-tile kernel
(tests/test_kernels.py:156-174).  It is compared with JAX
``forward_y_band`` in interpret mode at K3's gate (p99.9 <= 0.05, max <=
2.0; tests/test_torch_kernel.py says why), for both of JAX's inner-loop
strategies.  The CUDA kernel is held to K3 bit for bit on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libsrcnn_tpu.kernels import fused_conv as jfused
from libsrcnn_tpu.models import srcnn as jsrcnn
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn

BF16X1_MAX, BF16X1_P999 = 2.0, 0.05


@pytest.fixture(scope="module")
def jparams():
    return jsrcnn.load_params()


@pytest.fixture(scope="module")
def params(jparams):
    return srcnn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})


def _assert_bf16x1_close(got, ref):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert d.max() <= BF16X1_MAX, d.max()
    assert np.quantile(d, 0.999) <= BF16X1_P999, np.quantile(d, 0.999)


def _halo_plane(y):
    return torch.nn.functional.pad(torch.from_numpy(y)[None, None],
                                   (6, 6, 6, 6), mode="replicate")[0, 0]


@pytest.mark.parametrize("band_impl", fused_conv.BAND_IMPLS)
@pytest.mark.parametrize("shape", [(70, 260), (37, 131)])
def test_band_reference_matches_pallas_band_interpret(params, jparams, shape,
                                                      band_impl):
    y = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jfused.forward_y_band(jparams, jnp.asarray(y), tile_h=16,
                                           band_impl=band_impl, interpret=True))
    yh = _halo_plane(y)
    got = fused_conv.forward_y_band_reference(params, yh, *shape, tile_h=16,
                                              band_impl=band_impl)
    _assert_bf16x1_close(got.numpy(), ref)
    # the band geometry computes what K3 computes, bit for bit
    assert torch.equal(got, fused_conv.forward_y_reference(params, yh, *shape,
                                                           precision="bf16x1"))


@pytest.mark.parametrize("tile_h", [1, 12, 16, 64, 500])
@pytest.mark.parametrize("flags", [None, (0, 1, 0, 1), (0, 0, 0, 0)])
def test_band_wrapper_on_cpu_is_k3_plain_version(params, tile_h, flags):
    """Any band height and edge flags, a batch of two planes: the CPU
    wrapper runs K3's plain version and counts no launch."""
    ys = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 255, (2, 45, 73)).astype(np.float32))
    before = dict(fused_conv.launches_by)
    got = fused_conv.forward_y_band(params, ys, 33, 61, flags, tile_h=tile_h)
    assert got.shape == (2, 33, 61)
    assert torch.equal(got, fused_conv.forward_y_reference(
        params, ys, 33, 61, flags, precision="bf16x1"))
    assert fused_conv.launches_by == before


@pytest.mark.parametrize("kwargs,match", [
    (dict(band_impl="scan"), "band_impl"),
    (dict(tile_h=0), "tile_h"),
    (dict(tile_h=-12), "tile_h"),
    (dict(tile_h=1.5), "tile_h"),
    (dict(tile_h=True), "tile_h"),
])
def test_band_rejects_bad_arguments(params, kwargs, match):
    y = torch.zeros(32, 32)
    with pytest.raises(ValueError, match=match):
        fused_conv.forward_y_band(params, y, 20, 20, **kwargs)
    with pytest.raises(ValueError, match=match):
        fused_conv.forward_y_band_reference(params, y, 20, 20, **kwargs)


@pytest.mark.parametrize("y,h,w", [(torch.zeros(30, 30), 20, 20),
                                   (torch.zeros(2, 3, 32, 32), 20, 20),
                                   (torch.zeros(32, 32, dtype=torch.float64), 20, 20)])
def test_band_rejects_non_halo_planes(params, y, h, w):
    with pytest.raises((ValueError, TypeError)):
        fused_conv.forward_y_band(params, y, h, w)


def test_band_launch_takes_cuda_tensors_only(params):
    """K5's raw launch refuses CPU tensors before it builds anything, and
    checks its band height."""
    y, out = torch.zeros(32, 41), torch.empty(20, 29)
    packed = fused_conv.pack_params(params)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch("K5", packed, y, out, tile_h=12)
    with pytest.raises(ValueError, match="tile_h"):
        fused_conv.launch("K5", packed, y, out, tile_h=0)
    for cut in ("K6", "K7"):
        with pytest.raises(ValueError, match="ablation"):
            fused_conv.launch(cut, packed, y, out)
