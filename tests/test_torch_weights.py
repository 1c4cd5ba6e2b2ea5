"""The port's shipped weights (``libsrcnn_tpu_torch/models/weights/``):
byte-for-byte copies of the JAX package's ``libsrcnn_tpu/models/weights/``,
read from the port's own directory, so that the port loads every shipped
model and serves with the JAX package neither found nor imported."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import libsrcnn_tpu.models.srcnn as jsrcnn
import libsrcnn_tpu.models.srcnn_int8 as jsrcnn_int8
from libsrcnn_tpu_torch.models import espcn, fsrcnn, srcnn, srcnn_int8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "libsrcnn_tpu_torch", "models", "weights")
JAX_DIR = os.path.join(ROOT, "libsrcnn_tpu", "models", "weights")
NAMES = ["srcnn_915.npz", "srcnn_915_int8.npz", "srcnn955.npz", "vdsr.npz",
         *(f"{family}_x{s}.npz" for family in ("fsrcnn", "espcn") for s in (2, 3, 4))]


@pytest.mark.parametrize("name", NAMES)
def test_weights_are_a_copy_of_the_jax_side(name):
    """Each of the port's files is byte-equal to its twin in the JAX
    package, both read by path."""
    with open(os.path.join(PORT_DIR, name), "rb") as a, \
            open(os.path.join(JAX_DIR, name), "rb") as b:
        assert a.read() == b.read()


def test_same_files_on_both_sides():
    assert sorted(os.listdir(PORT_DIR)) == sorted(os.listdir(JAX_DIR)) == sorted(NAMES)


def test_weights_path_is_the_port_own():
    assert srcnn.weights_path("srcnn_915.npz") == os.path.join(PORT_DIR, "srcnn_915.npz")


@pytest.mark.parametrize("mod,family", [(fsrcnn, "FSRCNN"), (espcn, "ESPCN")],
                         ids=["fsrcnn", "espcn"])
def test_missing_head_raises_naming_the_port_path(mod, family):
    """A factor with no shipped head raises; the port never looks for it
    in the JAX package."""
    with pytest.raises(FileNotFoundError, match=f"no shipped {family} weights for x5") as e:
        mod.load_params(scale=5)
    assert os.path.join(PORT_DIR, f"{family.lower()}_x5.npz") in str(e.value)


# a Python process in which neither jax nor the JAX package can be found or
# imported: the port loads every shipped model and serves on the CPU
STANDALONE = r"""
import importlib.util, os, sys
sys.modules["libsrcnn_tpu"] = None
sys.modules["jax"] = None
import numpy as np, torch
torch.set_num_threads(1)
assert importlib.util.find_spec("libsrcnn_tpu") is None
import libsrcnn_tpu_torch as lt
from libsrcnn_tpu_torch.models import espcn, fsrcnn, srcnn, srcnn_generic, srcnn_int8, vdsr
from libsrcnn_tpu_torch.tools import gen_eval_report

port = os.path.dirname(os.path.abspath(lt.__file__))
path = srcnn.weights_path("srcnn_915.npz")
assert os.path.commonpath([path, port]) == port, path
assert len(srcnn.load_params(device="cpu")) == 6
assert len(srcnn_int8.load_params(device="cpu")) == len(srcnn_int8.INT8_KEYS)
for mod in (srcnn_generic, vdsr):
    params, spec = mod.load_params(device="cpu")
    assert params and spec
for mod in (fsrcnn, espcn):
    for s in (2, 3, 4):
        params, spec = mod.load_params(scale=s, device="cpu")
        assert params and spec
img = np.random.default_rng(0).integers(0, 256, (16, 20, 3), dtype=np.uint8)
for cfg in (lt.SRCNNConfig(), lt.SRCNNConfig(model="fsrcnn")):
    out = lt.upscale(img, 2.0, cfg, device="cpu")
    assert out.shape == (32, 40, 3) and out.dtype == np.uint8, out.shape
assert gen_eval_report.shipped_scales("fsrcnn") == [2, 3, 4]
assert gen_eval_report.shipped_scales("espcn") == [2, 3, 4]
print("standalone ok")
"""


def test_port_stands_alone_without_the_jax_package():
    res = subprocess.run([sys.executable, "-c", STANDALONE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "standalone ok" in res.stdout


@pytest.mark.parametrize("mod,jmod", [(srcnn, jsrcnn), (srcnn_int8, jsrcnn_int8)],
                         ids=["srcnn", "srcnn_int8"])
def test_same_parameters_as_the_jax_loaders(mod, jmod):
    """The port's loader gives the JAX loader's arrays bit for bit."""
    got = mod.load_params(device="cpu")
    want = mod.params_from_jax({k: np.asarray(v) for k, v in jmod.load_params().items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
