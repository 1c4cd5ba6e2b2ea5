"""Deterministic training, and the float64 forwards that training's card
gradients are held to.

* ``srcnn.edge_pad``, the replicate padding of the 9-1-5 and of every
  ``ops.conv.conv_same``, equals ``F.pad(mode="replicate")`` bit for bit
  in f32 and f64, forward and gradient, on planes wider and narrower than
  the pad.  Its backward sums the same terms as ``F.pad``'s in another
  order, so the upstream gradient is integer-valued (every order sums it
  exactly); a float upstream gradient is held within the dtype's default
  ``assert_close`` tolerance.
* ``models.srcnn.exact_f32`` on a CUDA device turns cuDNN's deterministic
  algorithms on and its autotuner and TF32 off, and restores them on exit
  (setting the flags needs no card); ``ops.conv``'s context does the same
  with TF32 allowed when ``BF16_TF32`` is.
* Two trainers built from one seed and fed the same batches end on equal
  weights (``torch.equal`` on every leaf): on the CPU after 3 steps, for
  the 9-1-5 and fsrcnn; on the card (``cuda``) for the 9-1-5, each
  family at full width and the 2x2x2 mesh step.
* Each family's forward keeps a float64 input's dtype: with float64
  parameters it is within 1e-3 u8 of the f32 forward, and the gradient of
  its float64 loss passes ``torch.autograd.gradcheck``.
* Each family's first-step f32 gradient passes ``tests/grad_gate.py``'s
  gate: the float64 gradient on the CPU along the f32 run's own ReLU /
  PReLU branches, each leaf within a limit set by how far its sum cancels
  (shipped weights, batch 16 x 32^2 of the butterfly, seed 0): the CPU's
  own gradient here, the card's (``cuda``) on a card.  The gate fails a
  leaf with a batch sample left out or scaled by 1 + 2e-3, and its guard
  fails a mask with one channel inverted; pinned to f64's own branches
  the reference is the plain f64 gradient.
* One training step of each case runs under
  ``torch.use_deterministic_algorithms(True)`` without raising, in a child
  process (``CUBLAS_WORKSPACE_CONFIG=:4096:8``; the global flag must not
  reach the other tests): on the CPU at small widths, and on the card
  (``cuda``) at full width -- the 9-1-5 at 16 x 32^2, vdsr, srcnn955,
  fsrcnn x2 and espcn x2 with their shipped weights, and the 2x2x2 mesh
  step over ``["cuda:0"] * 8`` for the 9-1-5 and vdsr.

This file imports no jax.  The card's tests skip without one; on a card:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_determinism.py -q -m cuda
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from libsrcnn_tpu_torch.models import espcn, fsrcnn, srcnn, srcnn_generic, vdsr
from libsrcnn_tpu_torch.models.srcnn import edge_pad, exact_f32
from libsrcnn_tpu_torch.ops import conv
from libsrcnn_tpu_torch.parallel import make_mesh
from libsrcnn_tpu_torch.train import Trainer, loss_fn, make_patch_batch, trainer

import grad_gate

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "goldens", "goldens.npz")
#: the f64 forward against the f32 one, in u8 (f32 sums of a few layers)
F64_ATOL = 1e-3
STEPS_CPU, STEPS_CARD, MESH_STEPS = 3, 10, 3
CHILD_TIMEOUT = 600
MESH_AXES = {"data": 2, "row": 2, "col": 2}

#: family -> (module, a small spec for the CPU, LR patches?)
FAMILIES = {
    "srcnn": (srcnn, None, False),
    "vdsr": (vdsr, vdsr.VDSRSpec(4, 8), False),
    "srcnn955": (srcnn_generic, srcnn_generic.ModelSpec(n1=8, f2=5, n2=4), False),
    "fsrcnn": (fsrcnn, fsrcnn.FSRCNNSpec(2, 8, 4, 2), True),
    "espcn": (espcn, espcn.ESPCNSpec(2, 8, 4), True),
}


@pytest.fixture(scope="module")
def butterfly():
    with np.load(GOLDENS) as z:
        return np.ascontiguousarray(z["in_butterfly_full"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's algorithms are what this holds")
    return torch.device("cuda")


def family_case(name: str, img, full: bool, batch: int, patch: int):
    """(params, loss forward, one batch) of a family: its shipped weights
    (``full``; the 9-1-5's shipped weights) or a seeded init at the small
    spec; ``batch`` x ``patch``^2 pairs of ``img`` (LR patches for an LR
    head, its HR ones ``scale`` times larger), made on the CPU."""
    module, spec, lr_head = FAMILIES[name]
    if name == "srcnn":
        params = srcnn.load_params() if full else srcnn.init_params(
            torch.Generator().manual_seed(0))
        forward, spec = None, None
    else:
        if full:
            params, spec = module.load_params(2)
        else:
            params = module.init_params(torch.Generator().manual_seed(0), spec)
        forward = module.make_loss_forward(spec)
    if lr_head:
        data = fsrcnn.make_lr_patch_batch([img], batch, patch, spec, seed=0, device="cpu")
    else:
        data = make_patch_batch([img], batch, patch, 2.0, seed=0, device="cpu")
    return params, forward, data


def deterministic_cases(device: str, img) -> dict:
    """The cases of the deterministic-algorithms run: name -> (params,
    forward, batch, mesh axes or None).  Full widths on the card, small
    ones on the CPU."""
    full = device == "cuda"
    patch, lr_patch = (32, 16) if full else (16, 8)
    batch = 16 if full else 4
    cases = {}
    for name, (_, _, lr_head) in FAMILIES.items():
        cases[name] = (*family_case(name, img, full, batch, lr_patch if lr_head else patch),
                       None)
    for name in ("srcnn", "vdsr"):
        cases[f"{name} 2x2x2"] = (*cases[name][:3], MESH_AXES)
    return cases


def trainer_for(case, device: str, lr: float = 1e-4) -> Trainer:
    params, forward, _, axes = case
    mesh = None if axes is None else make_mesh(axes, [device] * int(np.prod(list(axes.values()))))
    return Trainer(params=params, learning_rate=lr, forward=forward, mesh=mesh, device=device)


def child(device: str) -> None:
    """In a process of its own: one step of every case under
    ``torch.use_deterministic_algorithms(True)``; prints one JSON line,
    case -> "ok" or the error the step raised."""
    torch.use_deterministic_algorithms(True)
    with np.load(GOLDENS) as z:
        img = np.ascontiguousarray(z["in_butterfly_full"])
    got = {}
    for name, case in deterministic_cases(device, img).items():
        try:
            loss = trainer_for(case, device).fit([case[2]])[0]
            got[name] = "ok" if np.isfinite(loss) else f"loss {loss}"
        except RuntimeError as e:
            got[name] = f"{type(e).__name__}: {e}"[:2000]
    print("DETERMINISTIC " + json.dumps(got), flush=True)


@pytest.fixture(scope="module")
def deterministic_run():
    """device -> the child's result for that device, run once each."""
    runs = {}

    def run(device: str) -> dict:
        if device not in runs:
            env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
            env["PYTHONPATH"] = os.pathsep.join([HERE, os.path.dirname(HERE),
                                                 env.get("PYTHONPATH", "")])
            code = f"import test_torch_determinism as t; t.child({device!r})"
            out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                                 text=True, timeout=CHILD_TIMEOUT)
            lines = [ln for ln in out.stdout.splitlines() if ln.startswith("DETERMINISTIC ")]
            assert out.returncode == 0 and len(lines) == 1, out.stdout[-2000:] + out.stderr[-4000:]
            runs[device] = json.loads(lines[0][len("DETERMINISTIC "):])
        return runs[device]
    return run


# -- the pad ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,p", [((2, 3, 5, 7), 1), ((2, 3, 5, 7), 2), ((1, 2, 9, 6), 4),
                                     ((1, 2, 1, 3), 2), ((2, 1, 3, 1), 4), ((1, 1, 1, 1), 4),
                                     ((1, 2, 2, 5), 3)])
def test_edge_pad_equals_replicate_pad(shape, p, dtype):
    rng = np.random.default_rng(sum(shape) + p)
    x = torch.from_numpy(rng.uniform(-3, 3, shape)).to(dtype)
    out_shape = (*shape[:2], shape[2] + 2 * p, shape[3] + 2 * p)
    whole = torch.from_numpy(rng.integers(-64, 65, out_shape)).to(dtype)
    frac = torch.from_numpy(rng.normal(size=out_shape)).to(dtype)
    grads = {}
    for name, pad in (("helper", lambda t: edge_pad(t, p)),
                      ("F.pad", lambda t: F.pad(t, (p, p, p, p), mode="replicate"))):
        leaf = x.clone().requires_grad_()
        out = pad(leaf)
        grads[name] = [out.detach(), *torch.autograd.grad(out, leaf, whole, retain_graph=True),
                       *torch.autograd.grad(out, leaf, frac)]
    (y, g, gf), (y_ref, g_ref, gf_ref) = grads["helper"], grads["F.pad"]
    assert y.dtype == dtype and y.is_contiguous()
    assert torch.equal(y, y_ref)
    assert torch.equal(g, g_ref)
    torch.testing.assert_close(gf, gf_ref)


def test_edge_pad_zero_is_the_input():
    x = torch.arange(12.0).reshape(1, 1, 3, 4)
    assert edge_pad(x, 0) is x


# -- the flags --------------------------------------------------------------

@pytest.mark.parametrize("which", ["exact_f32", "conv exact", "conv bf16", "conv bf16 tf32"])
def test_training_context_sets_deterministic_cudnn(which, monkeypatch):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    dev = torch.device("cuda")
    if which == "exact_f32":
        ctx, tf32 = (lambda: exact_f32(dev)), False
    else:
        precision = which.split()[1]
        tf32 = which.endswith("tf32")
        monkeypatch.setattr(conv, "BF16_TF32", tf32)
        ctx = lambda: conv._context(dev, precision)  # noqa: E731
    prev_matmul = matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=True, deterministic=False,
                     allow_tf32=not tf32):
        matmul.allow_tf32 = not tf32
        try:
            with ctx():
                inside = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
                          matmul.allow_tf32)
            after = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
                     matmul.allow_tf32)
        finally:
            matmul.allow_tf32 = prev_matmul
    assert inside == (True, False, tf32, tf32)
    assert after == (False, True, not tf32, not tf32)


def test_exact_f32_on_the_cpu_sets_nothing():
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    with exact_f32(torch.device("cpu")):
        assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32) == before


# -- two runs from one seed ----------------------------------------------------

def two_runs_equal(case, device: str, steps: int, lr: float = 1e-4):
    """Two trainers of ``case`` from the same parameters over the same
    ``steps`` batches: (losses equal, every weight equal bit for bit)."""
    params, forward, (lr_y, hr_y), axes = case
    batches = [(np.roll(lr_y, s, axis=0), np.roll(hr_y, s, axis=0)) for s in range(steps)]
    runs = []
    for _ in range(2):
        t = trainer_for(case, device, lr)
        losses = t.fit(batches)
        weights = ([dict(r) for r in t.replicas] if axes else [dict(t.params)])
        runs.append((losses, [{k: v.detach().cpu() for k, v in w.items()} for w in weights]))
    (la, wa), (lb, wb) = runs
    return la == lb, all(torch.equal(a[k], b[k]) for a, b in zip(wa, wb) for k in a)


@pytest.mark.parametrize("name", ["srcnn", "fsrcnn"])
def test_two_cpu_trainers_from_one_seed_agree(butterfly, name):
    lr_head = FAMILIES[name][2]
    case = (*family_case(name, butterfly, False, 4, 8 if lr_head else 16), None)
    assert two_runs_equal(case, "cpu", STEPS_CPU) == (True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*FAMILIES, "srcnn 2x2x2", "vdsr 2x2x2"])
def test_two_card_trainers_from_one_seed_agree(cuda, butterfly, name):
    case = deterministic_cases("cuda", butterfly)[name]
    steps = MESH_STEPS if case[3] else STEPS_CARD
    # vdsr at its recipe's rate, whose trajectory parts from another sum
    # order within a dozen steps: two runs must still agree exactly
    lr = 1e-3 if name == "vdsr" else 1e-4
    assert two_runs_equal(case, "cuda", steps, lr) == (True, True)


# -- the float64 forwards --------------------------------------------------------

def forward_of(name: str):
    module, spec, _ = FAMILIES[name]
    return srcnn.forward_y if name == "srcnn" else module.make_loss_forward(spec)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_float64_forward_agrees_with_f32(butterfly, name):
    params, forward, (lr_y, _) = family_case(name, butterfly, False, 2, 12)
    forward = forward or srcnn.forward_y
    x = torch.from_numpy(lr_y)
    out32 = forward(params, x, clamp=False)
    out64 = forward({k: v.double() for k, v in params.items()}, x.double(), clamp=False)
    assert out32.dtype == torch.float32 and out64.dtype == torch.float64
    assert out64.shape == out32.shape
    assert float((out64 - out32.double()).abs().max()) <= F64_ATOL
    # an integer plane computes in f32, as before
    assert forward(params, x.round().to(torch.uint8), clamp=False).dtype == torch.float32


@pytest.mark.parametrize("name", list(FAMILIES))
def test_float64_plane_with_f32_weights_computes_in_f32(butterfly, name):
    """A float64 plane (``torch.from_numpy`` of a default numpy array)
    meets f32 weights in f32: the output is the f32 plane's bit for bit,
    through the whole-plane forward and the halo form."""
    params, forward, (lr_y, _) = family_case(name, butterfly, False, 2, 12)
    x64 = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, lr_y.shape))
    pairs = [((forward or srcnn.forward_y)(params, x, clamp=False) for x in (x64, x64.float()))]
    if forward is not None:
        halo = forward.halo_width(params)
        ext, edges = trainer._rows_with_halo(x64, slice(0, lr_y.shape[1] // 2), halo)
        pairs.append(forward.forward_halo(params, e, edges) for e in (ext, ext.float()))
    for got, want in map(tuple, pairs):
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_float64_loss_gradient_passes_gradcheck(butterfly, name):
    """The f64 gradient against central differences.  The seeded init's
    biases are 0 and its weights small, so many ReLU / PReLU
    pre-activations lie within a difference's step of their kink, where a
    finite difference is not the derivative: the biases are moved to 0.5
    first."""
    params, forward, (lr_y, hr_y) = family_case(name, butterfly, False, 2, 8)
    keys = list(params)
    lr64, hr64 = torch.from_numpy(lr_y).double(), torch.from_numpy(hr_y).double()

    def loss(*leaves):
        return loss_fn(dict(zip(keys, leaves)), lr64, hr64, forward)

    leaves = tuple((params[k].double() + (0.5 if re.fullmatch(r"b\d|.*_b", k) else 0.0))
                   .requires_grad_() for k in keys)
    assert torch.autograd.gradcheck(loss, leaves, fast_mode=True, eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


# -- the float32 gradient against float64 (tests/grad_gate.py) -----------------------

@pytest.fixture(scope="module")
def cpu_gate(butterfly):
    """name -> (the card case's inputs, the CPU's f32 gradient, its
    branches, the f64 reference along them), each computed once."""
    done = {}

    def get(name):
        if name not in done:
            case = family_case(name, butterfly, True, 16, 32)
            grads, masks = grad_gate.gradient(*case, "cpu")
            done[name] = (case, grads, masks, grad_gate.reference(*case, masks))
        return done[name]
    return get


@pytest.mark.parametrize("name", list(FAMILIES))
def test_cpu_gradient_within_gate(cpu_gate, name):
    """The CPU's own f32 gradient (its branches pinned) passes the gate on
    the card case's inputs, with a kappa recorded for every leaf."""
    _, grads, _, ref = cpu_gate(name)
    assert None not in ref.kappa.values(), ref.kappa
    assert grad_gate.misses(grads, ref) == [], grad_gate.describe(grads, ref)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_reference_on_own_branches_is_plain_gradient(butterfly, name):
    """Pinned to the f64 forward's own branches, the reference is the plain
    f64 gradient bit for bit: the tape's masked ReLU, its PReLU and
    its recorded convs compute what the library's forward does."""
    lr_head = FAMILIES[name][2]
    case = family_case(name, butterfly, False, 4, 8 if lr_head else 16)
    grads, masks = grad_gate.gradient(*case, "cpu", torch.float64)
    ref = grad_gate.reference(*case, masks)
    assert ref.flips == 0 and (len(masks) > 0) == (name != "espcn")
    for k, g in grads.items():
        assert torch.equal(ref.plain[k], g) and torch.equal(ref.grad[k], g), k


@pytest.mark.parametrize("control", ["sample dropped", "scaled by 1 + 2e-3"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_gate_catches_a_wrong_leaf(cpu_gate, name, control):
    """Negative controls: one leaf at a time of the CPU's f32 gradient made
    wrong, by leaving batch sample 0 out of it (the batch mean's gradient
    less that sample's share) or by scaling it by 1 + 2e-3; the gate
    fails on that leaf and the guard still passes."""
    (params, forward, (lr_y, hr_y)), grads, _, ref = cpu_gate(name)
    if control == "sample dropped":
        part, _ = grad_gate.gradient(params, forward, (lr_y[1:], hr_y[1:]), "cpu")
        wrong = {k: v * ((len(lr_y) - 1) / len(lr_y)) for k, v in part.items()}
    else:
        wrong = {k: v * (1 + 2e-3) for k, v in grads.items()}
    for k in grads:
        got = grad_gate.misses({**grads, k: wrong[k]}, ref)
        assert [m.split(":")[0] for m in got] == [k], (k, got)


@pytest.mark.parametrize("name", [n for n in FAMILIES if n != "espcn"])
def test_guard_rejects_an_inverted_mask(cpu_gate, name):
    """Negative control: the first activation's channel 0 takes the other
    branch everywhere; the guard fails on it."""
    case, grads, masks, _ = cpu_gate(name)
    bad = [m.clone() for m in masks]
    bad[0][:, 0] = ~bad[0][:, 0]
    ref = grad_gate.reference(*case, bad)
    assert ref.worst_flip > grad_gate.FLIP_RTOL and ref.where_worst[:3:2] == (0, 0)
    assert grad_gate.misses(grads, ref)[0].startswith("guard:")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILIES))
def test_card_gradient_within_f64_gradient(cuda, butterfly, name):
    """The first step's card gradient of every leaf against the same loss's
    float64 gradient on the CPU along the card's own ReLU / PReLU branches
    (shipped weights, batch 16 x 32^2 of butterfly, 32^2 LR patches for the
    LR heads, seed 0), within ``min(1e-3, max(1e-4, 256 * 2**-24 *
    kappa))`` of the reference leaf's largest entry, kappa being how far the
    leaf's sum cancels (tests/grad_gate.py).  That is the size of f32
    rounding in such a sum; a branch the card takes where f64 takes the
    other must lie within 1e-4 of its activation's largest magnitude.  A
    lost batch sample or a gradient scaled by 1 + 2e-3 passes 1e-3, so
    both stay caught (``test_gate_catches_a_wrong_leaf``)."""
    case = family_case(name, butterfly, True, 16, 32)
    grads, masks = grad_gate.gradient(*case, cuda)
    ref = grad_gate.reference(*case, masks)
    assert grad_gate.misses(grads, ref) == [], grad_gate.describe(grads, ref)


# -- under torch.use_deterministic_algorithms(True) ----------------------------------

CASES = [*FAMILIES, "srcnn 2x2x2", "vdsr 2x2x2"]


@pytest.mark.parametrize("name", CASES)
def test_step_under_deterministic_algorithms_cpu(deterministic_run, name):
    assert deterministic_run("cpu")[name] == "ok"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_step_under_deterministic_algorithms_card(cuda, deterministic_run, name):
    assert deterministic_run("cuda")[name] == "ok"
