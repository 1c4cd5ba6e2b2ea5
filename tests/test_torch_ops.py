"""Port vs JAX package: color conversion and band resize on the CPU.

Both packages evaluate the same f32 expressions in the same order (no
fused multiply-adds on either side), so the results are expected to be
bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libsrcnn_tpu.ops import color as jcolor
from libsrcnn_tpu.ops import resize as jresize
from libsrcnn_tpu_torch.config import FilterType
from libsrcnn_tpu_torch.ops import color, resize


@pytest.mark.parametrize("d", [3, 4])
def test_rgb_to_ycbcr_bit_equal(d):
    img = np.random.default_rng(2).integers(0, 256, (37, 53, d), dtype=np.uint8)
    got = color.rgb_to_ycbcr(torch.from_numpy(img)).numpy()
    ref = np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(img)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("d", [3, 4])
def test_ycbcr_to_rgb_bit_equal(d):
    rng = np.random.default_rng(3)
    planes = rng.uniform(-40, 300, (d, 37, 53)).astype(np.float32)
    planes[0, 0, :6] = [0.0, 255.0, 254.9999, -0.0001, 255.0001, 127.5]
    got = color.ycbcr_to_rgb(torch.from_numpy(planes)).numpy()
    ref = np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(planes)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_trunc_u8_floors():
    x = torch.tensor([-3.0, 0.0, 0.99, 1.0, 254.999, 255.0, 300.0])
    assert color.trunc_u8(x).tolist() == [0, 0, 0, 1, 254, 255, 255]


# (src_h, src_w, dst_h, dst_w): up, down, width-down/height-up, same size,
# same-size height
SHAPES = [(23, 31, 46, 62), (40, 36, 17, 15), (20, 40, 33, 21),
          (19, 27, 19, 27), (19, 27, 19, 50)]


@pytest.mark.parametrize("ft", list(FilterType), ids=lambda f: f.name)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_plane_bit_equal(ft, shape):
    sh, sw, dh, dw = shape
    plane = np.random.default_rng(4).uniform(0, 255, (sh, sw)).astype(np.float32)
    got = resize.resize_plane(torch.from_numpy(plane), dh, dw, ft).numpy()
    ref = np.asarray(jresize.resize_plane(jnp.asarray(plane), dh, dw, int(ft)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ft", [FilterType.BICUBIC, FilterType.LANCZOS3,
                                FilterType.NEAREST], ids=lambda f: f.name)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_plane_padded_bit_equal(ft, shape):
    sh, sw, dh, dw = shape
    plane = np.random.default_rng(5).uniform(0, 255, (sh, sw)).astype(np.float32)
    args = (dh, dw, ft, 6, dh + 12, dw + 12)
    got = resize.resize_plane_padded(torch.from_numpy(plane), *args).numpy()
    ref = np.asarray(jresize.resize_plane_padded(jnp.asarray(plane), dh, dw,
                                                 int(ft), 6, dh + 12, dw + 12))
    np.testing.assert_array_equal(got, ref)
    # the halo is the replicate padding of the unpadded resize
    inner = resize.resize_plane(torch.from_numpy(plane), dh, dw, ft)
    padded = torch.nn.functional.pad(inner[None, None], (6, 6, 6, 6),
                                     mode="replicate")[0, 0]
    np.testing.assert_array_equal(got, padded.numpy())


@pytest.mark.parametrize("w,h,m", [(30, 40, 1.37), (64, 64, 2.0),
                                   (33, 47, 2.5), (96, 96, 0.5)])
def test_scaled_size_equal(w, h, m):
    assert resize.scaled_size(w, h, m) == jresize.scaled_size(w, h, m)
