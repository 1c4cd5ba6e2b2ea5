"""Fuzz the port as ``tests/test_fuzz.py`` fuzzes the JAX package, on the
same seeds: random shapes, depths, filters and scales, the degenerate
sizes, the extreme scales and the random step-scale geometry through
``upscale(device="cpu")``, each output and conv map within 1 u8 of the
loop-level oracle (``tests/oracle.py``; it has no step-scale) and of the
JAX package's ``upscale``.

The card case (``cuda``) sends the seeded random plane shapes of
``test_fuzz.py``'s kernel fuzz through K1, K2, K3 and K4, each held to its
plain version on the card under the gates of ``tests/test_torch_cuda.py``
(K3's: every pixel within the flip bound of ``tests/bf16x1_gate.py``).
This module imports the JAX side only inside the CPU tests, so the card
case runs where jax is not installed:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_fuzz.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import bf16x1_gate
import libsrcnn_tpu_torch as T
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn, srcnn_int8

#: the port against the oracle and against the JAX package, on the image
#: and on the conv map (u8)
U8_TOL = 1
#: the kernels against their plain versions (tests/test_torch_cuda.py; K3's
#: gate is bf16x1_gate's)
K1_ATOL, SPLIT_ATOL = 2e-3, 5e-3


@pytest.fixture(scope="module")
def jax_side():
    """(the oracle, the JAX package), imported only by the CPU tests."""
    import oracle

    import libsrcnn_tpu
    return oracle, libsrcnn_tpu


def lsb(a, b) -> int:
    assert a.shape == b.shape
    return int(np.abs(a.astype(int) - b.astype(int)).max()) if a.size else 0


def against_jax(J, img, scale, step_scale=False, ft=None):
    """The port's output and conv map of one image, each held to the JAX
    package's; ``ft`` the filter's number (the default when None)."""
    got, want = (m.upscale(img, scale, m.SRCNNConfig(
        step_scale=step_scale, **({} if ft is None else {"filter": m.FilterType(ft)})),
        return_conv_map=True, **kw) for m, kw in ((T, {"device": "cpu"}), (J, {})))
    for a, b in zip(got, want):
        assert lsb(a, np.asarray(b)) <= U8_TOL
    return got


@pytest.mark.parametrize("seed", range(10))
def test_random_config_matches_oracle_and_jax(jax_side, seed):
    oracle, J = jax_side
    rng = np.random.default_rng(1000 + seed)
    h = int(rng.integers(3, 40))
    w = int(rng.integers(3, 40))
    d = int(rng.choice([3, 4]))
    ft = int(rng.integers(0, 5))
    scale = float(rng.choice([0.4, 0.75, 1.5, 2.0, 2.3, 3.0]))
    img = rng.integers(0, 256, (h, w, d), np.uint8)
    if int(np.float32(w) * np.float32(scale)) < 1 or \
       int(np.float32(h) * np.float32(scale)) < 1:
        scale = 2.0
    out, conv = against_jax(J, img, scale, ft=ft)
    want, wantc = oracle.do_srcnn(img, scale, J.FilterType(ft))
    assert lsb(out, want) <= U8_TOL, (seed, h, w, d, ft, scale)
    assert lsb(conv, wantc) <= U8_TOL, (seed, h, w, d, ft, scale)


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 8, 3), (2, 2, 4)])
def test_degenerate_sizes(jax_side, shape):
    oracle, J = jax_side
    img = np.random.default_rng(60).integers(0, 256, shape, np.uint8)
    out, conv = against_jax(J, img, 2.0)
    assert out.shape == (shape[0] * 2, shape[1] * 2, shape[2])
    want, wantc = oracle.do_srcnn(img, 2.0)
    assert lsb(out, want) <= U8_TOL and lsb(conv, wantc) <= U8_TOL


@pytest.mark.parametrize("scale,step_scale,size", [(8.0, False, 64), (0.25, False, 2),
                                                   (7.5, True, 60)])
def test_extreme_scales(jax_side, scale, step_scale, size):
    oracle, J = jax_side
    img = np.random.default_rng(61).integers(0, 256, (8, 8, 3), np.uint8)
    out, conv = against_jax(J, img, scale, step_scale)
    assert out.shape == (size, size, 3)
    if not step_scale:
        want, wantc = oracle.do_srcnn(img, scale)
        assert lsb(out, want) <= U8_TOL and lsb(conv, wantc) <= U8_TOL


@pytest.mark.parametrize("seed", range(5))
def test_random_step_scale(jax_side, seed):
    _, J = jax_side
    rng = np.random.default_rng(2000 + seed)
    h, w = int(rng.integers(8, 24)), int(rng.integers(8, 24))
    scale = float(rng.choice([2.0, 2.5, 3.0, 4.0]))
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    out, _ = against_jax(J, img, scale, step_scale=True)
    # the reference's chained-x2 geometry (test_fuzz.py)
    mult = np.float32(scale)
    lf = np.fmod(mult, np.float32(2.0))
    repeat = int(mult / np.float32(2.0)) + (1 if lf > 0 else 0)
    sw, sh = w, h
    for cnt in range(repeat):
        curmf = np.float32(2.0)
        if cnt + 1 == repeat:
            curmf = (np.float32(w) * mult) / np.float32(sw)
            if curmf == 0.0 or curmf == 1.0:
                break
        sw = int(np.float32(sw) * curmf)
        sh = int(np.float32(sh) * curmf)
    assert out.shape == (sh, sw, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_fuzz_kernels_against_plain_versions(cuda, seed):
    """The planes of ``test_fuzz.py``'s kernel fuzz (seeds 4000 + seed, h
    in [3, 140), w in [3, 300), uniform in [0, 255], with the 6 px ring
    the kernels read) through K1, K2, K3 and K4, each launched once
    against its plain version on the card: K1 within 2e-3, K2 within
    5e-3, K3 at every pixel within its flip bound (and max 2.0), K4 bit
    for bit.  A miss reports every kernel's max and K3's verdict (its worst
    pixel), and the same verdict of bf16x1's plain version on the card
    against the same on the CPU (two f32 sum orders of K3's math)."""
    rng = np.random.default_rng(4000 + seed)
    h = int(rng.integers(3, 140))
    w = int(rng.integers(3, 300))
    y = torch.from_numpy(rng.uniform(0, 255, (h + 12, w + 12)).astype(np.float32)).to(cuda)
    p, q = srcnn.load_params(cuda), srcnn_int8.load_params(cuda)
    runs = {"K1": (fused_conv.forward_y, fused_conv.forward_y_reference, p, {}),
            "K2": (fused_conv.forward_y, fused_conv.forward_y_reference, p,
                   {"precision": "split"}),
            "K3": (fused_conv.forward_y, fused_conv.forward_y_reference, p,
                   {"precision": "bf16x1"}),
            "K4": (fused_conv.forward_y_int8, fused_conv.forward_y_int8_reference, q, {})}
    bounds = bf16x1_gate.flip_bound(p, y, h, w)
    stats, ok = {}, {}
    for kernel, (launch, plain, params, kw) in runs.items():
        before = fused_conv.launches_by[kernel]
        got = launch(params, y, h, w, **kw)
        torch.cuda.synchronize()
        assert fused_conv.launches_by[kernel] == before + 1, kernel
        assert got.shape == (h, w)
        ref = plain(params, y, h, w, **kw)
        if kernel == "K3":
            v = bf16x1_gate.judge(got, ref, bounds)
            print(f"seed {seed}, {h}x{w}: K3 {v}")
            stats[kernel], ok[kernel] = str(v), v.ok
            continue
        stats[kernel] = float((got - ref).abs().max())
        ok[kernel] = {"K1": stats[kernel] <= K1_ATOL, "K2": stats[kernel] <= SPLIT_ATOL,
                      "K4": stats[kernel] == 0}[kernel]
    if not all(ok.values()):
        stats["bf16x1 plain, card vs CPU"] = str(bf16x1_gate.judge(
            fused_conv.forward_y_reference(p, y, h, w, precision="bf16x1").cpu(),
            fused_conv.forward_y_reference(srcnn.load_params(), y.cpu(), h, w,
                                           precision="bf16x1"), bounds))
    assert all(ok.values()), f"{h}x{w}: {ok}; {stats}"
