"""The port's fused conv stack (``kernels/fused_conv``) vs the JAX package.

On the CPU the wrapper runs its plain PyTorch version; it is compared with
the Pallas kernel in interpret mode, as tests/test_kernels.py runs it.
Tolerances on [0, 255] planes, all from sums of the same products taken in
another order:

* exact: atol 2e-3 (about 2.5e-4 seen).
* split: atol 5e-3 (1.9e-3 seen).
* bf16x1: 99.9th percentile 0.05 (0.020 seen) and max 2.0.  A sum-order
  difference can flip one bf16 rounding of h1 or c2; most flips move a
  pixel by a few hundredths, but h1 in [128, 256) has a bf16 step of 1.0,
  so a rare flip there moves its pixels by up to ~1 (0.36 seen here at
  96x124, 0.96 on the card at 1024^2 and 2048^2).
* the XLA twin (both bf16 tiers off the kernel): 0.1 (0.025 seen).

The CUDA kernels themselves are compared with the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
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


SPLIT_ATOL = 5e-3
BF16X1_MAX, BF16X1_P999 = 2.0, 0.05

JAX_PRECISION = {"exact": jax.lax.Precision.HIGHEST,
                 "split": jax.lax.Precision.DEFAULT, "bf16x1": jfused.BF16X1}


def _assert_bf16x1_close(got, ref):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert d.max() <= BF16X1_MAX, d.max()
    assert np.quantile(d, 0.999) <= BF16X1_P999, np.quantile(d, 0.999)


def _assert_mode_close(precision, got, ref):
    if precision == "bf16x1":
        _assert_bf16x1_close(got, ref)
    else:
        tol = ATOL if precision == "exact" else SPLIT_ATOL
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol)


def _jax_fused_args(jparams):
    p = {k: jnp.asarray(v) for k, v in jparams.items()}
    return (p["w1"].reshape(81, 64), p["b1"], p["w2"].reshape(64, 32), p["b2"],
            p["w3"][:, :, :, 0].transpose(1, 0, 2).reshape(25, 32),
            p["b3"].reshape(1))


@pytest.mark.parametrize("precision", ["split", "bf16x1"])
@pytest.mark.parametrize("shape", [(37, 53), (96, 124)])
def test_bf16_reference_matches_pallas_interpret(params, jparams, precision, shape):
    """K2 / K3's plain versions vs the Pallas kernel at DEFAULT / BF16X1
    (the pipeline's bfloat16 / bfloat16_fast tiers on the TPU)."""
    y = np.random.default_rng(31).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jfused.forward_y(jparams, jnp.asarray(y), interpret=True,
                                      precision=JAX_PRECISION[precision]))
    got = fused_conv.forward_y_reference(params, _halo_plane(y), *shape,
                                         precision=precision)
    _assert_mode_close(precision, got.numpy(), ref)


def test_hilo_reference_matches_pallas_hilo(params, jparams):
    """K3h's plain version (K2's) vs the Pallas kernel's hi/lo-packed
    conv1: the same hi + lo decomposition summed in another order."""
    y = np.random.default_rng(32).uniform(0, 255, (70, 150)).astype(np.float32)
    ref = np.asarray(jfused.forward_y(jparams, jnp.asarray(y), interpret=True,
                                      precision=jax.lax.Precision.DEFAULT,
                                      pack_im2col=True))
    got = fused_conv.forward_y_reference(params, _halo_plane(y), 70, 150,
                                         precision="split", pack_im2col=True)
    assert float(np.abs(got.numpy() - ref).max()) <= 0.01


@pytest.mark.parametrize("precision,pack", [("split", False), ("split", True),
                                            ("bf16x1", True)])
def test_bf16_reference_halo_mode_matches_pallas(params, jparams, precision, pack):
    """Each bf16 mode in halo mode with edge flags (0,1,0,1): top and left
    are interior borders whose c2 ring comes from the real halo pixels."""
    h, w = 37, 53
    yh = np.random.default_rng(33).uniform(0, 255, (h + 12, w + 12)).astype(np.float32)
    ref = jfused._fused(
        jnp.asarray(yh), *_jax_fused_args(jparams),
        jnp.asarray([0, 1, 0, 1], jnp.int32), th=jfused.BF16_TH,
        interpret=True, pad_mode="halo", precision=JAX_PRECISION[precision],
        pack_im2col=pack)
    got = fused_conv.forward_y_reference(params, torch.from_numpy(yh), h, w,
                                         (0, 1, 0, 1), precision=precision,
                                         pack_im2col=pack)
    _assert_mode_close(precision, got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tier", ["bfloat16", "bfloat16_fast"])
@pytest.mark.parametrize("shape", [(37, 53), (96, 124)])
def test_xla_twin_matches_jax(params, tier, shape):
    """The plain convs of both bf16 tiers vs the JAX package's XLA path on
    bf16-stored weights (what both tiers run off the TPU)."""
    y = np.random.default_rng(34).uniform(0, 255, shape).astype(np.float32)
    jp = jsrcnn.load_params(dtype=jnp.bfloat16)
    ref = np.asarray(jsrcnn.forward_y(jp, jnp.asarray(y)))
    got = srcnn.forward_y(params, torch.from_numpy(y), tier).numpy()
    assert float(np.abs(got - ref).max()) <= 0.1
    # rounding inside the forward is idempotent on bf16-stored weights
    again = srcnn.params_from_jax({k: np.asarray(v, np.float32)
                                   for k, v in jp.items()})
    assert torch.equal(srcnn.forward_y(again, torch.from_numpy(y), tier),
                       torch.from_numpy(got))


def test_bf16_modes_accuracy_ladder(params):
    """exact < split < bf16x1 against the plain exact path, each within the
    JAX package's envelope (tests/test_kernels.py:50-71)."""
    y = np.random.default_rng(18).uniform(0, 255, (100, 150)).astype(np.float32)
    yh = _halo_plane(y)
    ref = srcnn.forward_y(params, torch.from_numpy(y))
    d = {m: float((fused_conv.forward_y_reference(params, yh, 100, 150,
                                                  precision=m) - ref).abs().max())
         for m in ("exact", "split", "bf16x1")}
    assert d["exact"] <= ATOL and d["split"] <= 4.0 and d["bf16x1"] <= 8.0
    assert d["exact"] < d["split"] < d["bf16x1"], d


def test_round_bf16_is_round_to_nearest_even():
    """``round_bf16`` equals the RNE integer identity the TPU kernel uses
    (`fused_conv.py:229`) and ``__float2bfloat16_rn``."""
    x = np.random.default_rng(35).uniform(-300, 300, 10000).astype(np.float32)
    x[:4] = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 255.5, 0.0]   # ties
    bits = x.view(np.uint32).astype(np.uint64)
    rne = (((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16).astype(np.uint32)
    got = srcnn.round_bf16(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), rne)


@pytest.mark.parametrize("args,kernel", [
    (("exact",), "K1"), (("exact", False, "wide"), "K1"),
    (("split",), "K2"), (("split", False), "K2"), (("split", True), "K3h"),
    (("bf16x1",), "K3"), (("bf16x1", True), "K3"), (("bf16x1", False), "K3"),
    (("bf16x1", None, "narrow"), "K3n"), (("bf16x1", True, "narrow"), "K3n"),
])
def test_kernel_for_modes(args, kernel):
    assert fused_conv.kernel_for(*args) == kernel


def test_kernel_for_defaults_follow_module_flags(monkeypatch):
    monkeypatch.setattr(fused_conv, "PACK_IM2COL_SPLIT_DEFAULT", True)
    monkeypatch.setattr(fused_conv, "NARROW_DEFAULT", True)
    assert fused_conv.kernel_for("split") == "K3h"
    assert fused_conv.kernel_for("split", False) == "K2"
    assert fused_conv.kernel_for("bf16x1") == "K3n"
    assert fused_conv.kernel_for("bf16x1", None, "wide") == "K3"
    assert fused_conv.kernel_for("exact") == "K1"


@pytest.mark.parametrize("kwargs,match", [
    (dict(precision="exact", pack_im2col=True), "f32 scratch"),
    (dict(precision="exact", geom="narrow"), "narrow"),
    (dict(precision="split", geom="narrow"), "narrow"),
    (dict(precision="bfloat16"), "precision"),
    (dict(precision="bf16x1", geom="tall"), "geom"),
])
def test_wrapper_rejects_bad_modes(params, kwargs, match):
    y = torch.zeros(32, 32)
    with pytest.raises(ValueError, match=match):
        fused_conv.forward_y(params, y, 20, 20, **kwargs)
    if "geom" not in kwargs:      # the plain version has no geometry
        with pytest.raises(ValueError, match=match):
            fused_conv.forward_y_reference(params, y, 20, 20, **kwargs)


@pytest.mark.parametrize("precision", ["exact", "split", "bf16x1"])
def test_batched_planes_equal_one_at_a_time(params, precision):
    """[N, h+12, w+12] in one call equals the planes one at a time, and the
    CPU wrapper runs the plain version without counting a launch."""
    ys = torch.from_numpy(np.random.default_rng(36).uniform(
        0, 255, (3, 32, 41)).astype(np.float32))
    before = dict(fused_conv.launches_by)
    got = fused_conv.forward_y(params, ys, 20, 29, precision=precision)
    assert got.shape == (3, 20, 29)
    for i in range(3):
        assert torch.equal(got[i], fused_conv.forward_y_reference(
            params, ys[i], 20, 29, precision=precision))
    assert fused_conv.launches_by == before and fused_conv.launches == 0


def test_launch_takes_cuda_tensors_only(params):
    """The raw launch refuses CPU tensors before it builds or loads
    anything: there is no CPU kernel."""
    y = torch.zeros(32, 41)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch("K3", fused_conv.pack_params(params), y,
                          torch.empty(20, 29))
