"""Weight bridge: a flax param tree of the reference package -> the port.

The port's modules carry the reference package's parameter names and
layouts (Dense kernels stay [in, out]; LSTM gates (i, f, g, o); GRU
gates (r, z, n); weight-norm {v, g}; norm scale/bias), so the bridge is
a rename of nested-dict paths to `state_dict()` keys joined by '.'. The
one change of layout: convolution kernels, the 4-D leaves, go from
flax's HWIO to torch's OIHW (the detector's stem keeps its [7, 7, C, 64]
parameter as a 7x7 conv). The mode0 encoder's subtrees map the same way:
`change_detector/extractor/trunk/...` (the R101's convs and GroupNorms,
named as the detector's ResNet's), `extractor/fc_reshape` and
`SSRE/{query,key,value,LayerNorm_0}`. Every leaf is consumed exactly
once; a leaf the model lacks, a parameter the tree lacks, or a shape
mismatch raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dicts of arrays -> {'a.b.c': array}. Torch tensors stay
    tensors (a bf16 leaf has no numpy dtype); other leaves become numpy
    arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _leaves(tree: Mapping, names) -> Dict[str, object]:
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


def as_torch(value) -> torch.Tensor:
    """A leaf (numpy array or tensor) as a tensor in the torch layout:
    4-D leaves go from HWIO to OIHW."""
    t = value if isinstance(value, torch.Tensor) \
        else torch.as_tensor(np.array(value))
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def _copy(dst: torch.Tensor, value, name: str) -> None:
    value = as_torch(value)
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: tree shape {tuple(value.shape)}, model "
                         f"shape {tuple(dst.shape)}")
    dst.copy_(value.to(dst.dtype))


#: optax's name of each optimizer slot -> the port's (`train/step.py`)
OPTAX_SLOTS = {"mu": "mu", "nu": "nu", "trace": "trace",
               "sum_of_squares": "acc"}


def load_optax_state(opt, slots: Mapping, count: int):
    """Set the port's optimizer `opt` to an optax state: `slots` maps
    optax's slot names (mu and nu of adam/adamw, trace of sgd with
    momentum, nu of rmsprop, sum_of_squares of adagrad; none for sgd) to
    trees shaped like the flax params, and `count` is the updates
    applied, which is also the position of the learning-rate schedule.
    The slots must be exactly the ones `opt`'s kind keeps. Returns
    opt."""
    want = sorted(opt.slots)
    got = sorted(OPTAX_SLOTS.get(k, k) for k in slots)
    if got != want:
        raise ValueError(f"optimizer kind {opt.cfg.type!r} keeps slots "
                         f"{want}; the state holds {got}")
    with torch.no_grad():
        for key, tree in slots.items():
            port_key = OPTAX_SLOTS[key]
            leaves = _leaves(tree, opt.names)
            for name, t in zip(opt.names, opt.slots[port_key]):
                _copy(t, leaves[name], f"{key}.{name}")
    opt.count = int(count)
    return opt


def load_flax_params(model: torch.nn.Module, tree: Mapping
                     ) -> torch.nn.Module:
    """Copy a flax param tree (nested dicts of numpy arrays or tensors,
    with or without the outer 'params' collection) into `model`, in
    place."""
    params = dict(model.named_parameters())
    leaves = _leaves(tree, params)
    with torch.no_grad():
        for name, p in params.items():
            _copy(p, leaves[name], name)
    return model
