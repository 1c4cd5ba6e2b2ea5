"""SRCNN 9-1-5 weights from an ``.npz`` beside this file, in the JAX
layout (HWIO), as f32 OIHW tensors on the device.  The config's
``weights`` gives the file's name under ``file``."""

import os

import numpy as np
import torch

KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def load(config, seed, device):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        config["weights"]["file"])
    with np.load(path) as z:
        hwio = {k: z[k] for k in KEYS}
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v).astype(np.float32)).to(device)
        for k, v in hwio.items()}
