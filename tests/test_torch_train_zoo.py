"""The training halves of the port's model zoo (``init_params``,
``make_loss_forward``, ``params_to_jax``, srcnn_generic's
``from_pretrained``, fsrcnn's ``make_lr_patch_batch``) and the trainer's
loss, gradients and checkpoints for every family, against the JAX
package's on the CPU.

Sizes are small: vdsr depth 4 x 8 channels, a 9-5-5 spec at 8 / 4
channels, fsrcnn d 8 / s 4 / m 2 at x2 and x3, espcn 8 / 4 at x2 and x3,
batches of 3 patches (24^2 HR).  Both packages start from the same numpy
parameters (the JAX package's ``init_params`` at a fixed key, carried
across with ``params_from_jax``); a JAX key's draws cannot be reproduced
in torch, so the port's ``init_params`` is held by its form.

Tolerances: the loss within 1e-5 relative and each parameter's gradient
within 1e-4 of that parameter's largest gradient (measured: 1e-6 and
2.3e-6; the two packages sum each conv in another f32 order, and autograd
differentiates the port's own formulations: conv2 as a channels-last
matmul, fsrcnn's deconv as a sub-pixel plan scattered from ``deconv_w``,
vdsr's residual as a loop over ``mid_w``); planes within 1e-4
(``test_torch_zoo_models.py``'s TOL); pair synthesis bit for bit; init
stds within 5% of their rule at a fixed seed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libsrcnn_tpu.models.espcn as jespcn
import libsrcnn_tpu.models.fsrcnn as jfsrcnn
import libsrcnn_tpu.models.srcnn as jsrcnn
import libsrcnn_tpu.models.srcnn_generic as jgeneric
import libsrcnn_tpu.models.vdsr as jvdsr
from libsrcnn_tpu.config import FilterType as JFilter
from libsrcnn_tpu.train import trainer as jtrainer
from libsrcnn_tpu_torch.config import FilterType
from libsrcnn_tpu_torch.models import espcn, fsrcnn, srcnn, srcnn_generic, vdsr
from libsrcnn_tpu_torch.models.srcnn import weights_path
from libsrcnn_tpu_torch.train import (Trainer, load_checkpoint, loss_fn,
                                      make_patch_batch, save_checkpoint)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
# the JAX package's own shipped weights, read by path (the port reads its copy)
JAX_WEIGHTS = os.path.join(os.path.dirname(jsrcnn.__file__), "weights")
TOL = 1e-4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
STD_RTOL, STD_SEEDS = 0.05, 8
# the trainer against the JAX trainer: test_torch_train.py's rule
TRAIN_LOSS_RTOL, PARAM_FRAC, PARAM_LR = 1e-4, 0.999, 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (as in
    test_torch_zoo_models.py): many small convs, and the test workers'
    threads spinning on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def butterfly():
    with np.load(GOLDENS) as z:
        return z["in_butterfly_full"]


# name -> (port module, port spec, JAX module, JAX spec, LR-domain head?)
FAMILIES = {
    "srcnn": (srcnn, None, jsrcnn, None, False),
    "srcnn955": (srcnn_generic, srcnn_generic.ModelSpec(n1=8, f2=5, n2=4),
                 jgeneric, jgeneric.ModelSpec(n1=8, f2=5, n2=4), False),
    "vdsr": (vdsr, vdsr.VDSRSpec(4, 8), jvdsr, jvdsr.VDSRSpec(4, 8), False),
    "fsrcnn_x2": (fsrcnn, fsrcnn.FSRCNNSpec(2, 8, 4, 2), jfsrcnn,
                  jfsrcnn.FSRCNNSpec(2, 8, 4, 2), True),
    "fsrcnn_x3": (fsrcnn, fsrcnn.FSRCNNSpec(3, 8, 4, 2), jfsrcnn,
                  jfsrcnn.FSRCNNSpec(3, 8, 4, 2), True),
    "espcn_x2": (espcn, espcn.ESPCNSpec(2, 8, 4), jespcn, jespcn.ESPCNSpec(2, 8, 4), True),
    "espcn_x3": (espcn, espcn.ESPCNSpec(3, 8, 4), jespcn, jespcn.ESPCNSpec(3, 8, 4), True),
}


def _np_params(name, seed=0):
    _, _, jmod, jspec, _ = FAMILIES[name]
    key = jax.random.key(seed)
    p = jmod.init_params(key) if jspec is None else jmod.init_params(key, jspec)
    return {k: np.asarray(v) for k, v in p.items()}


def _forwards(name):
    """(port loss forward, JAX loss forward); None is the 9-1-5 default."""
    mod, spec, jmod, jspec, _ = FAMILIES[name]
    if spec is None:
        return None, None
    return mod.make_loss_forward(spec), jmod.make_loss_forward(jspec)


def _batch(name, butterfly, seed=2, batch=3):
    mod, spec, _, _, lr_domain = FAMILIES[name]
    if lr_domain:
        return fsrcnn.make_lr_patch_batch([butterfly], batch, 24 // spec.scale,
                                          spec, seed=seed, device="cpu")
    return make_patch_batch([butterfly], batch, 24, 2.0, seed=seed, device="cpu")


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


# --- loss and gradients ------------------------------------------------------------


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_and_gradients_match_jax(name, butterfly):
    mod = FAMILIES[name][0]
    np_params = _np_params(name)
    fwd, jfwd = _forwards(name)
    lr_y, hr_y = _batch(name, butterfly)
    jloss, jgrads = jax.value_and_grad(jtrainer.loss_fn)(
        _j(np_params), jnp.asarray(lr_y), jnp.asarray(hr_y), jfwd)
    params = {k: v.requires_grad_() for k, v in mod.params_from_jax(np_params).items()}
    loss = loss_fn(params, torch.tensor(lr_y), torch.tensor(hr_y), fwd)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    grads = mod.params_to_jax({k: v.grad for k, v in params.items()})
    assert set(grads) == set(np_params)
    for k, g in grads.items():
        ref = np.asarray(jgrads[k])
        assert g.shape == ref.shape, k
        scale = float(np.abs(ref).max())
        assert scale > 0, k
        assert float(np.abs(g - ref).max()) <= GRAD_RTOL * scale, k


def test_deconv_gradient_lands_on_the_true_parameter(butterfly):
    """fsrcnn's deconv runs as a sub-pixel plan built from deconv_w: the
    gradient reaches deconv_w itself, in its [1, d, 9, 9] shape."""
    np_params = _np_params("fsrcnn_x3")
    params = {k: v.requires_grad_() for k, v in fsrcnn.params_from_jax(np_params).items()}
    fwd, _ = _forwards("fsrcnn_x3")
    lr_y, hr_y = _batch("fsrcnn_x3", butterfly)
    loss_fn(params, torch.tensor(lr_y), torch.tensor(hr_y), fwd).backward()
    g = params["deconv_w"].grad
    assert g is not None and g.shape == (1, 8, 9, 9) and bool((g != 0).all())


@pytest.mark.parametrize("name", ["vdsr", "fsrcnn_x2"])
def test_family_trainer_matches_jax_trainer(name, butterfly):
    lr, steps = 1e-3, 5
    mod = FAMILIES[name][0]
    np_params = _np_params(name, seed=1)
    fwd, jfwd = _forwards(name)
    batches = [_batch(name, butterfly, seed=s, batch=2) for s in range(steps)]
    jt = jtrainer.Trainer(params=_j(np_params), learning_rate=lr, forward=jfwd)
    jlosses = jt.fit(batches)
    tt = Trainer(params=mod.params_from_jax(np_params), learning_rate=lr, forward=fwd,
                 device="cpu")
    np.testing.assert_allclose(tt.fit(batches), jlosses, rtol=TRAIN_LOSS_RTOL)
    got = mod.params_to_jax(tt.params)
    diff = np.concatenate([np.abs(got[k] - np.asarray(jt.params[k])).ravel() for k in got])
    assert (diff <= PARAM_LR * lr).mean() >= PARAM_FRAC, float(diff.max())
    assert float(diff.max()) <= 2 * lr * steps


# --- init_params, from_pretrained -----------------------------------------------------


def _he(shape, gain=1.0):
    kh, kw, cin, _ = shape[-4:]
    return gain * np.sqrt(2.0 / (kh * kw * cin))


def _glorot(shape, gain=1.0):
    kh, kw, cin, cout = shape[-4:]
    return gain * np.sqrt(2.0 / (kh * kw * (cin + cout)))


# name -> (init(generator), JAX init(key), weight std rule, fills)
INITS = {
    "srcnn": (lambda g: srcnn.init_params(g), jsrcnn.init_params,
              lambda k, s: 1e-3, {}),
    "srcnn955": (lambda g: srcnn_generic.init_params(g, srcnn_generic.SRCNN_955),
                 lambda key: jgeneric.init_params(key, jgeneric.SRCNN_955),
                 lambda k, s: 1e-3, {}),
    "vdsr": (lambda g: vdsr.init_params(g), jvdsr.init_params,
             lambda k, s: _he(s, 0.1 if k == "out_w" else 1.0), {}),
    "fsrcnn_x2": (lambda g: fsrcnn.init_params(g), jfsrcnn.init_params,
                  lambda k, s: _he(s, 0.1 if k == "deconv_w" else 1.0), {"_a": 0.25}),
    "fsrcnn_x3": (lambda g: fsrcnn.init_params(g, fsrcnn.FSRCNNSpec(scale=3)),
                  lambda key: jfsrcnn.init_params(key, jfsrcnn.FSRCNNSpec(scale=3)),
                  lambda k, s: _he(s, 0.1 if k == "deconv_w" else 1.0), {"_a": 0.25}),
    "espcn_x2": (lambda g: espcn.init_params(g), jespcn.init_params,
                 lambda k, s: _glorot(s, 127.5 if k == "c3_w" else 1.0), {"c3_b": 127.5}),
    "espcn_x3": (lambda g: espcn.init_params(g, espcn.ESPCNSpec(scale=3)),
                 lambda key: jespcn.init_params(key, jespcn.ESPCNSpec(scale=3)),
                 lambda k, s: _glorot(s, 127.5 if k == "c3_w" else 1.0), {"c3_b": 127.5}),
}


@pytest.mark.parametrize("name", list(INITS))
def test_init_params_form(name):
    """The JAX init's keys and shapes (HWIO after params_to_jax), each
    weight's std within 5% of its rule, biases zero, the fills (PReLU
    alphas, espcn's mid-gray head bias) as the JAX init's; a seed gives the
    same draws.  The std is taken over the draws of the fixed seeds
    0..STD_SEEDS-1 together: one draw of a small leaf (vdsr's 288-weight
    in_w) has a sampling error of 1 / sqrt(2 n) = 4.2%, too near the 5%
    bound to test the rule."""
    init, jinit, std_rule, fills = INITS[name]
    mod = FAMILIES[name][0]
    ref = {k: np.asarray(v) for k, v in jinit(jax.random.key(0)).items()}
    draws = [mod.params_to_jax(init(torch.Generator().manual_seed(s)))
             for s in range(STD_SEEDS)]
    got = draws[0]
    again = mod.params_to_jax(init(torch.Generator().manual_seed(0)))
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.shape == ref[k].shape and v.dtype == np.float32, k
        np.testing.assert_array_equal(v, again[k])
        fill = next((f for suffix, f in fills.items() if k.endswith(suffix)), None)
        if fill is not None or v.ndim == 1 or k == "mid_b":
            want = 0.0 if fill is None else fill
            assert (v == want).all() and (ref[k] == want).all(), k
        else:
            rule = std_rule(k, v.shape)
            std = float(np.concatenate([d[k].ravel() for d in draws]).std())
            assert abs(std / rule - 1.0) <= STD_RTOL, (k, std, rule)
            assert not np.array_equal(v, draws[1][k]), k


def test_init_params_device_and_seed():
    a = vdsr.init_params(torch.Generator().manual_seed(3), device="cpu")
    b = vdsr.init_params(torch.Generator().manual_seed(4))
    assert all(t.device.type == "cpu" for t in a.values())
    assert not torch.equal(a["mid_w"], b["mid_w"])


@pytest.mark.parametrize("depth", [1, 2])
def test_vdsr_shallow_depth_raises_as_jax(depth):
    with pytest.raises(ValueError) as jerr:
        jvdsr.init_params(jax.random.key(0), jvdsr.VDSRSpec(depth=depth))
    with pytest.raises(ValueError) as err:
        vdsr.init_params(torch.Generator(), vdsr.VDSRSpec(depth=depth))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("spec", ["SRCNN_955", "SRCNN_935"])
def test_from_pretrained_raises_as_jax_for_other_specs(spec):
    with pytest.raises(ValueError) as jerr:
        jgeneric.from_pretrained(getattr(jgeneric, spec))
    with pytest.raises(ValueError) as err:
        srcnn_generic.from_pretrained(getattr(srcnn_generic, spec))
    assert str(err.value) == str(jerr.value)


def test_from_pretrained_915_is_the_shipped_weights():
    got = srcnn_generic.from_pretrained(device="cpu")
    for k, v in srcnn.load_params().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["srcnn955", "vdsr"])
def test_lane_pack_is_taken_and_ignored(name, butterfly):
    mod, spec = FAMILIES[name][:2]
    params = mod.params_from_jax(_np_params(name))
    y = torch.tensor(_batch(name, butterfly)[0])
    np.testing.assert_array_equal(mod.make_loss_forward(spec, lane_pack=4)(params, y).numpy(),
                                  mod.make_loss_forward(spec)(params, y).numpy())


# --- fsrcnn's LR patch batches -------------------------------------------------------


@pytest.mark.parametrize("scale,patch,filt", [(2, 12, 2), (3, 10, 2), (4, 8, 3)])
def test_make_lr_patch_batch_bit_equal(butterfly, scale, patch, filt):
    images = [butterfly[:90, :100], butterfly[100:, 120:]]
    lr, hr = fsrcnn.make_lr_patch_batch(images, 4, patch, fsrcnn.FSRCNNSpec(scale), seed=7,
                                        filter_type=FilterType(filt), device="cpu")
    jlr, jhr = jfsrcnn.make_lr_patch_batch(images, 4, patch, jfsrcnn.FSRCNNSpec(scale),
                                           seed=7, filter_type=JFilter(filt))
    assert lr.shape == (4, patch, patch) and hr.shape == (4, scale * patch, scale * patch)
    np.testing.assert_array_equal(lr, jlr)
    np.testing.assert_array_equal(hr, jhr)


def test_make_lr_patch_batch_too_small_raises(butterfly):
    img = butterfly[:20, :20]
    with pytest.raises(ValueError, match="smaller than HR patch"):
        jfsrcnn.make_lr_patch_batch([img], 2, 12, jfsrcnn.FSRCNNSpec(2))
    with pytest.raises(ValueError, match="smaller than HR patch"):
        fsrcnn.make_lr_patch_batch([img], 2, 12, fsrcnn.FSRCNNSpec(2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fsrcnn.make_lr_patch_batch([butterfly], 2, 12)


# --- checkpoints, both ways ---------------------------------------------------------------


def _plane_forwards(name):
    """(port forward, JAX forward) of ``name``'s serving plane, clamped."""
    mod, spec, jmod, jspec, lr_domain = FAMILIES[name]
    if spec is None:
        return (lambda p, y: srcnn.forward_y(p, y),
                lambda p, y: jsrcnn.forward_y(p, y))
    if lr_domain:
        return (lambda p, y: mod.forward_lr(p, y, spec),
                lambda p, y: jmod.forward_lr(p, y, jspec))
    return (lambda p, y: mod.forward_hr(p, y, spec),
            lambda p, y: jmod.forward_hr(p, y, jspec))


@pytest.mark.parametrize("name", ["srcnn955", "vdsr", "fsrcnn_x3", "espcn_x2"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_moves_both_ways(tmp_path, name, direction):
    mod = FAMILIES[name][0]
    np_params = _np_params(name, seed=2)
    path = str(tmp_path / f"{name}.npz")
    if direction == "port_to_jax":
        save_checkpoint(path, mod.params_from_jax(np_params), 9)
        jparams, step = jtrainer.load_checkpoint(path)
        params = mod.params_from_jax(np_params)
    else:
        jtrainer.save_checkpoint(path, _j(np_params), 9)
        params, step = load_checkpoint(path, device="cpu")
        jparams = _j(np_params)
        for k, v in mod.params_from_jax(np_params).items():
            torch.testing.assert_close(params[k], v, rtol=0, atol=0)
    assert step == 9 and set(jparams) == set(np_params) == set(params)
    plane = np.random.default_rng(11).uniform(0, 255, (2, 19, 23)).astype(np.float32)
    fwd, jfwd = _plane_forwards(name)
    with torch.no_grad():
        got = fwd(params, torch.tensor(plane)).numpy()
    ref = np.asarray(jfwd(jparams, jnp.asarray(plane)))
    assert got.shape == ref.shape and float(np.abs(got - ref).max()) <= TOL


SHIPPED = {"srcnn955.npz": (srcnn_generic, jgeneric), "vdsr.npz": (vdsr, jvdsr),
           **{f"fsrcnn_x{s}.npz": (fsrcnn, jfsrcnn) for s in (2, 3, 4)},
           **{f"espcn_x{s}.npz": (espcn, jespcn) for s in (2, 3, 4)}}


@pytest.mark.parametrize("fname", list(SHIPPED))
def test_shipped_meta_survives_a_round_trip(tmp_path, fname):
    """A shipped checkpoint through the port (its weights as tensors, its
    meta_* entries as they are) and save_checkpoint: the JAX family's
    load_params reads the spec back from the meta, and the weights equal
    the shipped ones; the port's load_checkpoint gives both back too."""
    mod, jmod = SHIPPED[fname]
    with np.load(weights_path(fname)) as z:
        shipped = {k: z[k] for k in z.files}
    meta = {k: v for k, v in shipped.items() if k.startswith("meta_")}
    assert meta
    path = str(tmp_path / fname)
    save_checkpoint(path, {**mod.params_from_jax(shipped), **meta}, 3)
    jparams, jspec = jmod.load_params(path=path)
    _, want_spec = jmod.load_params(path=os.path.join(JAX_WEIGHTS, fname))
    assert jspec == want_spec
    params, step = load_checkpoint(path, device="cpu")
    assert step == 3 and set(params) == set(shipped) - {"step"}
    for k, v in meta.items():
        np.testing.assert_array_equal(params[k], v)
    for k, v in mod.params_to_jax(params).items():
        np.testing.assert_array_equal(v, shipped[k])
        np.testing.assert_array_equal(np.asarray(jparams[k]), shipped[k])


def test_checkpoint_of_no_family_raises(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, step=np.int64(0), foo=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="no model family"):
        load_checkpoint(path, device="cpu")
