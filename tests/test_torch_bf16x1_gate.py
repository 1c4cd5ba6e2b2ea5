"""The per-pixel gate of K3 (``tests/bf16x1_gate.py``) on the CPU.

Three stand-ins for K3 that are sound by construction meet the gate at
every pixel against K3's plain version, ``fused_conv.forward_y_reference(
..., precision="bf16x1")``: K3's k16 emulator and the same arithmetic
with every sum in f64 in one fixed order (``tests/test_torch_bf16x1_wgmma.py``),
and the JAX package's ``_kernel`` at ``BF16X1`` with the pair pack in
Pallas interpret mode.  Faults that the old p99.9 statistic let through
(one pixel off by 1.0, a few off by 0.3, all off by 0.02, b3 off by
0.01, a gain of 1e-4, one weight of w2 or w3 off by one bf16 ulp) fail it
on every plane.  The planes are those of the kernel fuzz
(``tests/test_fuzz.py``: seeds 4000 +, uniform noise with the 6 px ring),
two 256^2 noise planes and, for the window's margin, the smooth planes of
``tests/test_torch_cuda.py``.  Also: the gate's :data:`WINDOW` has 1.5x
margin over the largest sum-order gap measured at h1, c2 and the output;
the cut bounds hold for the emulator's cut sums; the bounds do not depend
on the row bands they are computed in.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bf16x1_gate as gate
from libsrcnn_tpu.kernels import fused_conv as jfused
from libsrcnn_tpu.models import srcnn as jsrcnn
from libsrcnn_tpu_torch.kernels import ablation, fused_conv
from libsrcnn_tpu_torch.models import srcnn
from test_torch_bf16x1_wgmma import (_dot_k16, _dot_ordered, forward_y_bf16x1, im2col,
                                     kernel_weights)
from test_torch_bf16x2 import bf16
from test_torch_cuda import _plane as smooth_plane

#: the edge-flag cases of test_emulator_matches_bf16x1_plain_version
FLAGS = [None, (0, 1, 0, 1), (0, 0, 0, 0), (1, 0, 1, 0)]
#: the smooth planes of test_torch_cuda.py's bf16 kernel cases (seed 20)
SMOOTH = [(3, 3), (1, 70), (70, 1), (33, 47), (130, 250), (67, 45), (40, 40)]
PLANES = [f"fuzz{s}" for s in range(6)] + ["noise0", "noise1"]
#: the planes the window's margin is measured on
MARGIN_PLANES = PLANES + [f"smooth{i}" for i in range(len(SMOOTH))] + ["card256"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plane(name: str):
    """(halo plane [h+12, w+12] f32, h, w): ``fuzz<s>`` is seed 4000 + s of
    the kernel fuzz, ``noise<i>`` a 256^2 uniform plane, ``smooth<i>`` the
    i-th of :data:`SMOOTH`, ``card<n>`` an n^2 plane of the recipe that
    ``chip_smoke.py`` holds K3 to its plain version on (seed 0)."""
    if name.startswith("fuzz"):
        rng = np.random.default_rng(4000 + int(name[4:]))
        h, w = int(rng.integers(3, 140)), int(rng.integers(3, 300))
        return torch.from_numpy(rng.uniform(0, 255, (h + 12, w + 12)).astype(np.float32)), h, w
    if name.startswith("noise"):
        rng = np.random.default_rng(88 + int(name[5:]))
        return torch.from_numpy(rng.uniform(0, 255, (268, 268)).astype(np.float32)), 256, 256
    if name.startswith("card"):
        import chip_smoke

        n = int(name[4:])
        return torch.from_numpy(chip_smoke.smooth_plane(np.random.default_rng(0), n + 12,
                                                        n + 12)), n, n
    h, w = SMOOTH[int(name[6:])]
    return smooth_plane(h + 12, w + 12, 20, "cpu"), h, w


@pytest.fixture(scope="module")
def jparams():
    return jsrcnn.load_params()


@pytest.fixture(scope="module")
def params(jparams):
    return srcnn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})


@pytest.fixture(scope="module")
def case(params):
    """(name, flags) -> (y, h, w, the plain version, the bounds), computed once."""
    cache = {}

    def get(name, flags):
        if (name, flags) not in cache:
            y, h, w = plane(name)
            cache[name, flags] = (y, h, w, fused_conv.forward_y_reference(
                params, y, h, w, flags, precision="bf16x1"),
                gate.flip_bound(params, y, h, w, flags))
        return cache[name, flags]
    return get


# --- the window's margin -----------------------------------------------------


def _rows(t):
    """[1, C, H, W] -> [H W, C]"""
    return t[0].reshape(t.shape[1], -1).t()


def _planes(t, h, w):
    """[H W, C] -> [1, C, H, W]"""
    return t.t().reshape(1, -1, h, w)


def sum_order_gaps(params, y, h, w) -> dict:
    """stage (h1, c2, out) -> the largest |pre_a - pre_b| / (U S) over the
    pairs of sound orders: the plain f32 conv (``srcnn.conv``), K3's k16
    emulator, f64 sums and a sequential f32 sum.  Each stage's orders get
    the same input: the bf16 window, bf16(h1) and bf16(c2) of the f64
    order (c2 gathered through the ring clamp of all four edges; the
    emulators sum conv3 as K3 does, the tap GEMM and then the shift-add)."""
    wk = {32: kernel_weights(params), 64: kernel_weights(params, torch.float64)}
    r, c = h + 4, w + 4
    ring = (fused_conv._ring_index(h, 1, 1, "cpu"), fused_conv._ring_index(w, 1, 1, "cpu"))

    def gather(t):
        return t.index_select(2, ring[0]).index_select(3, ring[1])

    def stage(x, key, bias, plain, then=lambda t: t):
        """x [positions, K] f32 -> (each order's pre-activations, S)"""
        pre = {"plain": plain}
        for name, dot, dt in (("k16", _dot_k16, 32), ("seq", _dot_ordered, 32),
                              ("f64", _dot_ordered, 64)):
            pre[name] = then(dot(x.to(wk[dt][key].dtype), wk[dt][key])) + wk[dt][bias]
        return pre, then(x.double().abs() @ wk[64][key].abs()) + wk[64][bias].abs()

    def conv(x, key, bias):
        return srcnn.conv(x, params[key], "bf16x1") + params[bias].reshape(1, -1, 1, 1)

    pre1, s1 = stage(im2col(bf16(y[None]))[0], "w1", "b1", _rows(conv(y[None, None], "w1", "b1")))
    h1 = bf16(torch.relu(pre1["f64"])).float()
    pre2, s2 = stage(h1, "w2", "b2", _rows(conv(_planes(h1, r, c), "w2", "b2")))
    c2 = bf16(torch.relu(pre2["f64"])).float()

    def shift_add(taps):
        """[positions, 32] -> conv3's sums [1, h, w], unclamped, no bias"""
        g = gather(_planes(taps[:, :25], r, c))
        return sum(g[:, k, k // 5:k // 5 + h, k % 5:k % 5 + w] for k in range(25))

    out, s3 = stage(c2, "w3", "b3", conv(gather(_planes(c2, r, c)), "w3", "b3")[:, 0],
                    shift_add)
    return {name: max(float(((pre[a].double() - pre[b].double()).abs() / (gate.U * s)).max())
                      for a, b in itertools.combinations(pre, 2))
            for name, (pre, s) in (("h1", (pre1, s1)), ("c2", (pre2, s2)), ("out", (out, s3)))}


@pytest.fixture(scope="module")
def order_gaps(params):
    return {n: sum_order_gaps(params, *plane(n)) for n in MARGIN_PLANES}


@pytest.mark.parametrize("stage", ["h1", "c2", "out"])
def test_window_has_its_margin(order_gaps, stage):
    """WINDOW is at least 1.5x the largest two-sided gap |pre_a - pre_b| /
    (U S) between two sound sum orders at h1, c2 and the output, on every
    plane of :data:`MARGIN_PLANES`."""
    worst = max(g[stage] for g in order_gaps.values())
    assert 0 < worst <= gate.WINDOW / 1.5, (stage, worst, order_gaps)


# --- sound orders stay within the bound ------------------------------------


@pytest.mark.parametrize("name,flags", [(f"fuzz{s}", f) for s in range(6) for f in FLAGS]
                         + [("noise0", None), ("noise1", None)],
                         ids=lambda v: v if isinstance(v, str) else "".join(map(str, v or "-")))
@pytest.mark.parametrize("ordered", [False, True], ids=["k16", "f64"])
def test_emulator_within_the_bound(params, case, name, flags, ordered):
    """K3's k16 emulator and its f64 fixed-order twin against the plain
    version: every pixel within its bound."""
    y, h, w, ref, bounds = case(name, flags)
    got = forward_y_bf16x1(params, y, h, w, flags, ordered=ordered).float()
    v = gate.judge(got, ref, bounds)
    assert v.ok, f"{name} {h}x{w} flags={flags}: {v}"


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("name", [f"fuzz{s}" for s in range(6)])
def test_pallas_interpret_within_the_bound(params, jparams, case, name, flags):
    """The JAX package's ``_kernel`` at ``BF16X1`` with the pair pack, in
    Pallas interpret mode and its halo mode (the ring from the plane's own
    halo where a flag is 0), against the plain version at every pixel."""
    y, h, w, ref, bounds = case(name, flags)
    p = {k: jnp.asarray(v) for k, v in jparams.items()}
    got = jfused._fused(
        jnp.asarray(y.numpy()), p["w1"].reshape(81, 64), p["b1"],
        p["w2"].reshape(64, 32), p["b2"],
        p["w3"][:, :, :, 0].transpose(1, 0, 2).reshape(25, 32),
        p["b3"].reshape(1), jnp.asarray(fused_conv._flags(flags), jnp.int32),
        th=jfused.BF16_TH, interpret=True, pad_mode="halo",
        precision=jfused.BF16X1, pack_im2col=True)
    v = gate.judge(torch.from_numpy(np.asarray(got)), ref, bounds)
    assert v.ok, f"{name} {h}x{w} flags={flags}: {v}"


# --- faults fail it ----------------------------------------------------------


def _ulp_up(t: torch.Tensor, index) -> torch.Tensor:
    """``t`` with entry ``index`` moved to the next bf16 above its bf16
    value, so that the plain version sees that weight one bf16 ulp off."""
    t = srcnn.round_bf16(t.clone())
    v = t[index].reshape(1).to(torch.bfloat16)
    nxt = (v.view(torch.int16) + (1 if float(v) > 0 else -1)).view(torch.bfloat16)
    t[index] = float(nxt)
    return t


def _largest(t: torch.Tensor):
    return np.unravel_index(int(t.abs().argmax()), t.shape)


CONTROLS = ["corner+1", "0.05%+0.3", "all+0.02", "b3+0.01", "gain1e-4", "w3_ulp", "w2_ulp"]


def _control(params, y, h, w, ref, control):
    """``ref`` (the plain version) with the fault ``control`` put in: on
    the output, or in a weight that the plain version then runs with
    (``w3`` / ``w2``: the entry of largest magnitude, one bf16 ulp up in
    magnitude)."""
    out = ref.clone()
    if control == "corner+1":
        out[0, 0] += 1.0
    elif control == "0.05%+0.3":
        n = max(1, round(0.0005 * h * w))
        idx = torch.from_numpy(np.random.default_rng(7).choice(h * w, n, replace=False))
        out.view(-1)[idx] += 0.3
    elif control == "all+0.02":
        out += 0.02
    elif control == "gain1e-4":
        out *= 1 + 1e-4
    else:
        p = dict(params)
        if control == "b3+0.01":
            p["b3"] = p["b3"] + 0.01
        else:
            key = control[:2]
            p[key] = _ulp_up(p[key], _largest(p[key]))
        out = fused_conv.forward_y_reference(p, y, h, w, precision="bf16x1")
    return out


@pytest.mark.parametrize("name", PLANES)
@pytest.mark.parametrize("control", CONTROLS)
def test_fault_fails_the_gate(params, case, control, name):
    y, h, w, ref, bounds = case(name, None)
    bad = _control(params, y, h, w, ref, control)
    assert not torch.equal(bad, ref)
    v = gate.judge(bad, ref, bounds)
    assert not v.ok and v.n_over > 0, f"{control} on {name} {h}x{w} passed: {v}"


# --- the cut bounds, the bands, the report ---------------------------------


def emulator_cut(params, y, h, w, stage):
    """What K3's cut ``stage`` writes per output pixel, in the k16
    emulator's sums: the rounded centre tap (``load``), or the sum of the
    64 h1 channels, the 32 c2 channels or the 25 taps at the pixel's own
    ring position."""
    if stage == "load":
        return bf16(y[6:h + 6, 6:w + 6])
    wk = kernel_weights(params)
    cols = im2col(bf16(y[None, 2:h + 10, 2:w + 10]))[0]
    h1 = torch.relu(_dot_k16(cols, wk["w1"]) + wk["b1"])
    if stage == "conv1":
        return h1.sum(-1).reshape(h, w)
    c2 = torch.relu(_dot_k16(bf16(h1), wk["w2"]) + wk["b2"])
    if stage == "conv2":
        return c2.sum(-1).reshape(h, w)
    return _dot_k16(bf16(c2), wk["w3"])[:, :25].sum(-1).reshape(h, w)


@pytest.mark.parametrize("name", [f"fuzz{s}" for s in range(6)] + ["noise0"])
@pytest.mark.parametrize("stage", ["load", "conv1", "conv2", "taps"])
def test_cut_bounds_hold_for_the_emulator(params, case, stage, name):
    """The emulator's cut sums against the cuts' plain versions
    (``ablation.forward_y_cut_reference``), scaled as the card's cut checks
    scale them, within each stage's bound at every pixel."""
    y, h, w, _, bounds = case(name, None)
    got = emulator_cut(params, y, h, w, stage)
    ref = ablation.forward_y_cut_reference("K3", stage, params, y[None], h, w)[0]
    v = gate.judge(got, ref, bounds, stage, 255.0 / max(255.0, float(ref.abs().max())))
    assert v.ok, f"{stage} on {name}: {v}"


@pytest.mark.parametrize("band_rows", [1, 5, 16])
def test_banded_bounds_equal_the_whole_plane(params, band_rows):
    """Bounds computed in bands of 1, 5 or 16 output rows equal those of
    the whole plane, bit for bit, on a batch of two planes with the
    interior-ring flags."""
    ys = torch.stack([plane("fuzz3")[0][:, :34], plane("fuzz1")[0][:32, :34]])
    h, w, flags = 20, 22, (0, 1, 1, 0)
    whole = gate.flip_bound(params, ys, h, w, flags, band_rows=h)
    banded = gate.flip_bound(params, ys, h, w, flags, band_rows=band_rows)
    for field in ("out", "conv1", "conv2", "taps", "amb_h1", "amb_c2"):
        assert torch.equal(getattr(banded, field), getattr(whole, field)), field
    assert torch.equal(whole.out[1], gate.flip_bound(params, ys[1], h, w, flags).out)


def test_bound_is_tight_where_no_rounding_is_ambiguous(case):
    """A pixel with no ambiguous h1 or c2 entry under its window is held to
    the sums' own slack (below 1e-3); the pixels where flips can happen
    take the rest, and most of noise's bounds lie below 0.05."""
    _, _, _, _, b = case("noise0", None)
    quiet = (b.amb_h1 == 0) & (b.amb_c2 == 0)
    assert quiet.any() and float(b.out[quiet].max()) < 1e-3
    assert float(b.out.median()) < gate.WIDE < float(b.out.max())
    assert float(b.stage("load").abs().max()) == 0


def test_judge_reports_the_worst_pixel(case):
    y, h, w, ref, b = case("fuzz3", None)
    bad = ref.clone()
    bad[4, 7] += 1.0
    v = gate.judge(bad, ref, b)
    assert not v.ok and v.n_over == 1 and v.where == (4, 7) and v.gap == pytest.approx(1.0)
    assert v.bound == float(b.out[4, 7]) and v.amb_h1 == int(b.amb_h1[4, 7])
    assert "MISSED: 1 of" in str(v)
    # the max-abs limit holds whatever a pixel's bound
    wide = gate.Bounds(**{k: torch.full_like(getattr(b, k), 10.0) if k == "out" else
                          getattr(b, k) for k in ("out", "conv1", "conv2", "taps",
                                                  "amb_h1", "amb_c2")})
    bad[0, 0] += 2.5
    v = gate.judge(bad, ref, wide)
    assert not v.ok and v.n_over == 0 and v.max_abs > gate.MAX_ABS
    with pytest.raises(ValueError, match="stage"):
        b.stage("conv3")


if __name__ == "__main__":
    # The window's measurement and the bound's size, on the CPU (minutes):
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bf16x1_gate.py
    # each plane's largest sum-order gap at h1, c2 and the output (larger
    # planes of chip_smoke.py's recipe too); the bound's median, p90 and
    # p99 on the noise planes; both emulators against the plain version
    # on a smooth plane of each card check.
    torch.set_num_threads(4)
    shipped = srcnn.load_params()
    for n in MARGIN_PLANES + ["card512", "card1024"]:
        print(n, {k: round(v, 3) for k, v in sum_order_gaps(shipped, *plane(n)).items()},
              flush=True)
    for n in PLANES:
        b = gate.flip_bound(shipped, *plane(n)).out.flatten()
        q = torch.quantile(b, torch.tensor([0.5, 0.9, 0.99], dtype=b.dtype))
        print(n, "bound median, p90, p99:", [round(float(v), 4) for v in q])
    import chip_smoke

    for what, y, h, w in (
            ("test_torch_cuda.py 500x1000", smooth_plane(512, 1012, 70, "cpu"), 500, 1000),
            ("chip_smoke 130x250", torch.from_numpy(chip_smoke.smooth_plane(
                np.random.default_rng(0), 142, 262)), 130, 250)):
        b = gate.flip_bound(shipped, y, h, w)
        ref = fused_conv.forward_y_reference(shipped, y, h, w, precision="bf16x1")
        for ordered in (False, True):
            got = forward_y_bf16x1(shipped, y, h, w, ordered=ordered).float()
            print(what, "f64" if ordered else "k16", gate.judge(got, ref, b))
