"""The port's fused conv stack (``kernels/fused_conv``) vs the JAX package.

On the CPU the wrapper runs its plain PyTorch version; it is compared with
the Pallas kernel in interpret mode, as tests/test_kernels.py runs it.
Tolerance atol 2e-3 on [0, 255] planes: the two sum the 5,184 + 2,048 +
800 f32 products of each pixel in different orders (about 2.5e-4 seen).
The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libsrcnn_tpu.kernels import fused_conv as jfused
from libsrcnn_tpu.models import srcnn as jsrcnn
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn

ATOL = 2e-3


@pytest.fixture(scope="module")
def jparams():
    return jsrcnn.load_params()


@pytest.fixture(scope="module")
def params(jparams):
    return srcnn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})


def _random_hwio(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (9, 9, 1, 64), "b1": (64,), "w2": (1, 1, 64, 32),
              "b2": (32,), "w3": (5, 5, 32, 1), "b3": (1,)}
    return {k: (rng.standard_normal(s) * (0.05 if k[0] == "w" else 1.0))
            .astype(np.float32) for k, s in shapes.items()}


def _halo_plane(y):
    return torch.nn.functional.pad(torch.from_numpy(y)[None, None],
                                   (6, 6, 6, 6), mode="replicate")[0, 0]


@pytest.mark.parametrize("shape", [(37, 53), (96, 124), (130, 250)])
def test_reference_matches_pallas_interpret(params, jparams, shape):
    y = np.random.default_rng(13).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jfused.forward_y(jparams, jnp.asarray(y), interpret=True))
    got = fused_conv.forward_y_reference(params, _halo_plane(y), *shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_reference_interior_ring_matches_pallas_halo_mode(params, jparams):
    """edge_flags (0,1,0,1): top and left are interior borders, so the c2
    ring there comes from the real halo pixels, not the edge clamp."""
    h, w = 37, 53
    yh = np.random.default_rng(14).uniform(0, 255, (h + 12, w + 12)).astype(np.float32)
    p = {k: jnp.asarray(v) for k, v in jparams.items()}
    ref = jfused._fused(
        jnp.asarray(yh), p["w1"].reshape(81, 64), p["b1"],
        p["w2"].reshape(64, 32), p["b2"],
        p["w3"][:, :, :, 0].transpose(1, 0, 2).reshape(25, 32),
        p["b3"].reshape(1), jnp.asarray([0, 1, 0, 1], jnp.int32),
        th=jfused.DEFAULT_TH, interpret=True, pad_mode="halo",
        precision=jax.lax.Precision.HIGHEST)
    got = fused_conv.forward_y_reference(params, torch.from_numpy(yh), h, w,
                                         (0, 1, 0, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # and the flags matter: all-edges differs on the top/left border
    edges = fused_conv.forward_y_reference(params, torch.from_numpy(yh), h, w)
    assert np.abs(edges.numpy()[:2] - got.numpy()[:2]).max() > 1e-2


def test_params_from_jax_round_trip():
    """Random HWIO weights: layouts survive the conversion (OIHW for the
    plain convs, the packed layout for the kernel) and the plain forward
    matches the JAX forward on them."""
    hwio = _random_hwio(7)
    p = srcnn.params_from_jax(hwio)
    assert p["w1"].shape == (64, 1, 9, 9) and p["w3"].shape == (1, 32, 5, 5)
    for k in ("w1", "w2", "w3"):
        np.testing.assert_array_equal(p[k].numpy().transpose(2, 3, 1, 0), hwio[k])
    packed = fused_conv.pack_params(p).numpy()
    assert packed.size == 8129
    np.testing.assert_array_equal(packed[:5184], hwio["w1"].reshape(81, 64).ravel())
    np.testing.assert_array_equal(packed[5248:7296], hwio["w2"].reshape(64, 32).ravel())
    np.testing.assert_array_equal(packed[7328:8128], hwio["w3"].reshape(25, 32).ravel())
    assert packed[8128] == hwio["b3"][0]

    y = np.random.default_rng(8).uniform(0, 255, (29, 41)).astype(np.float32)
    ref = np.asarray(jsrcnn.forward_y({k: jnp.asarray(v) for k, v in hwio.items()},
                                      jnp.asarray(y)))
    got = srcnn.forward_y(p, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # the halo-plane reference agrees with the plain forward on a replicate halo
    np.testing.assert_allclose(
        fused_conv.forward_y_reference(p, _halo_plane(y), 29, 41).numpy(), got,
        atol=1e-4)


def test_shipped_weights_match_jax_package(jparams):
    p = srcnn.load_params()
    back = {k: jnp.asarray(v) for k, v in jparams.items()}
    again = srcnn.params_from_jax(back)
    for k in srcnn.PARAM_KEYS:
        assert torch.equal(p[k], again[k])
    assert sum(v.numel() for v in p.values()) == 8129
    model = srcnn.SRCNN915()
    y = torch.rand(1, 21, 19) * 255
    assert torch.equal(model(y), srcnn.forward_y(p, y))


def test_wrapper_on_cpu_runs_plain_version(params):
    before = fused_conv.launches
    y = _halo_plane(np.random.default_rng(9).uniform(0, 255, (20, 24)).astype(np.float32))
    got = fused_conv.forward_y(params, y, 20, 24)
    assert torch.equal(got, fused_conv.forward_y_reference(params, y, 20, 24))
    assert fused_conv.launches == before == 0


@pytest.mark.parametrize("bad", [
    dict(y=torch.zeros(30, 30), h=20, w=20),                      # shape
    dict(y=torch.zeros(32, 32, dtype=torch.float64), h=20, w=20),  # dtype
    dict(y=torch.zeros(32, 32), h=20, w=20, edge_flags=(1, 1, 2, 1)),
    dict(y=torch.zeros(32, 32), h=20, w=20, edge_flags=(1, 1, 1)),
])
def test_wrapper_rejects_bad_input(params, bad):
    with pytest.raises((ValueError, TypeError)):
        fused_conv.forward_y(params, bad["y"], bad["h"], bad["w"],
                             bad.get("edge_flags"))
