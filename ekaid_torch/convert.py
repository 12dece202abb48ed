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


def _leaves(tree: Mapping, names) -> Dict[str, np.ndarray]:
    """A param-shaped tree flattened to `names`; raises on any leaf the
    names lack or any name the tree lacks."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    leaves = flatten(tree)
    extra = sorted(set(leaves) - set(names))
    missing = sorted(set(names) - set(leaves))
    if extra or missing:
        raise KeyError(f"param tree does not match the model: unknown "
                       f"leaves {extra}, missing leaves {missing}")
    return leaves


def _copy(dst: torch.Tensor, value: np.ndarray, name: str) -> None:
    if value.ndim == 4:                               # HWIO -> OIHW
        value = value.transpose(3, 2, 0, 1)
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: tree shape {value.shape}, model "
                         f"shape {tuple(dst.shape)}")
    dst.copy_(torch.as_tensor(np.array(value), dtype=dst.dtype))


def load_optax_adam_state(opt, mu: Mapping, nu: Mapping, count: int):
    """Set the port's adam optimizer `opt` to an optax adam state: mu and
    nu are the moment trees (nested dicts of numpy, shaped like the flax
    params), count the updates applied, which is also the position of
    the learning-rate schedule. Returns opt."""
    if "mu" not in opt.slots:
        raise ValueError(f"optimizer kind {opt.cfg.type!r} has no adam "
                         "moments")
    with torch.no_grad():
        for key, tree in (("mu", mu), ("nu", nu)):
            leaves = _leaves(tree, opt.names)
            for name, t in zip(opt.names, opt.slots[key]):
                _copy(t, leaves[name], f"{key}.{name}")
    opt.count = int(count)
    return opt


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
