"""Weight bridge: a flax param tree of the reference package -> the port.

The port's modules carry the reference package's parameter names and
layouts (Dense kernels stay [in, out]; LSTM gates (i, f, g, o); GRU
gates (r, z, n); weight-norm {v, g}; norm scale/bias), so the bridge is
a rename of nested-dict paths to `state_dict()` keys joined by '.'. The
one change of layout: convolution kernels, the 4-D leaves, go from
flax's HWIO to torch's OIHW (the detector's stem keeps its [7, 7, C, 64]
parameter as a 7x7 conv). Every leaf is consumed exactly once; a leaf
the model lacks, a parameter the tree lacks, or a shape mismatch raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {'a.b.c': array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def load_flax_params(model: torch.nn.Module, tree: Mapping
                     ) -> torch.nn.Module:
    """Copy a flax param tree (nested dicts of numpy arrays, with or
    without the outer 'params' collection) into `model`, in place."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    leaves = flatten(tree)
    params = dict(model.named_parameters())
    extra = sorted(set(leaves) - set(params))
    missing = sorted(set(params) - set(leaves))
    if extra or missing:
        raise KeyError(f"param tree does not match the model: unknown "
                       f"leaves {extra}, missing leaves {missing}")
    with torch.no_grad():
        for name, p in params.items():
            value = leaves[name]
            if value.ndim == 4:                       # HWIO -> OIHW
                value = value.transpose(3, 2, 0, 1)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree shape {value.shape}, model "
                                 f"shape {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(value), dtype=p.dtype))
    return model
