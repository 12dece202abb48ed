"""Read the reference package's orbax checkpoints without JAX.

A checkpoint directory that orbax's `StandardCheckpointer` wrote holds
`_METADATA`, a JSON file whose `tree_metadata` lists every leaf by its
key path (key_type 1: a sequence index, 2: a dict key or field name),
and the arrays in an OCDBT key-value store, one zarr array per leaf at
the key path joined by '.'. This module reads that map and the arrays
with `tensorstore` alone, and builds the port's objects from them:

  * a VQA snapshot (`ekaid_tpu/train/step.py::TrainState`: step, flax
    params, optax state; mode2 or the pixels-in mode0) into the port's
    `train/step.py::TrainState`:
    the params through `convert.load_flax_params`, the optimizer slots
    of each of the seven kinds of `make_optimizer` through
    `convert.load_optax_state`;
  * a detector checkpoint (the params that `train_detector.py` saves)
    into a `FasterRCNN` state dict (conv kernels HWIO -> OIHW).

bf16 leaves come back from tensorstore as `ml_dtypes.bfloat16` and
become torch bf16 through a 16-bit integer view. A `_METADATA` layout
or an optimizer chain that is not one of those listed here raises.

tensorstore is imported only when a checkpoint is read. Where it is not
installed (the H100 machine has none), convert the checkpoint where it
is and carry the `.pt` over:

    python -m ekaid_torch.utils.orbax_import vqa <orbax_dir> <out.pt>
    python -m ekaid_torch.utils.orbax_import detector <orbax_dir> <out.pt>

A VQA `.pt` is what `utils/checkpoint.py` writes (name it `<step>.pt`
in a snapshots directory); a detector `.pt` is a state dict that the
extraction runner's `--ana_ckpt`/`--dis_ckpt` take.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ekaid_torch.convert import (OPTAX_SLOTS, as_torch, flatten,
                                 load_flax_params, load_optax_state)

CONVERTER = ("python -m ekaid_torch.utils.orbax_import {vqa,detector} "
             "<orbax_dir> <out.pt>")
#: value types of `tree_metadata` entries that hold an array
_ARRAY_TYPES = ("jax.Array", "np.ndarray")
#: key types of `key_metadata`: a sequence index, a dict key or field
_INDEX, _NAME = 1, 2


class UnsupportedCheckpoint(ValueError):
    """The checkpoint's layout is not one this reader handles."""


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading an orbax checkpoint needs the tensorstore package, "
            "which is not installed here; convert the checkpoint where it "
            f"is with `{CONVERTER}` and load the .pt") from e
    return tensorstore


def is_orbax_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "_METADATA"))


def _metadata(path: str) -> Tuple[list, str]:
    """[(key path, value metadata)] of every entry, and the zarr driver."""
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        md = json.load(f)
    if not isinstance(md, dict) or "tree_metadata" not in md:
        raise UnsupportedCheckpoint(f"{meta_path}: no tree_metadata")
    if not md.get("use_ocdbt", False):
        raise UnsupportedCheckpoint(f"{meta_path}: use_ocdbt is not set; "
                                    "only OCDBT checkpoints are read")
    entries = []
    for name, entry in md["tree_metadata"].items():
        keys = entry.get("key_metadata")
        value = entry.get("value_metadata", {})
        if not keys or any(k.get("key_type") not in (_INDEX, _NAME)
                           for k in keys):
            raise UnsupportedCheckpoint(f"{meta_path}: entry {name} has "
                                        f"key metadata {keys}")
        if value.get("value_type") not in _ARRAY_TYPES + ("None",):
            raise UnsupportedCheckpoint(f"{meta_path}: entry {name} has "
                                        f"value type {value.get('value_type')}")
        entries.append(([(k["key"], k["key_type"]) for k in keys], value))
    return entries, ("zarr3" if md.get("use_zarr3") else "zarr")


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _sequences(node):
    """Dicts whose keys were all sequence indices become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _sequences(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise UnsupportedCheckpoint(f"sequence indices {sorted(out)}")
        return [out[i] for i in range(len(out))]
    return out


def read_tree(path: str):
    """The checkpoint's tree: dicts for named keys, lists for sequences,
    torch tensors at the array leaves (0-d ones too) and None where the
    saved value was empty (optax's EmptyState)."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    entries, driver = _metadata(path)
    ctx = ts.Context()
    root: dict = {}
    for keys, value in entries:
        leaf = None
        if value.get("value_type") in _ARRAY_TYPES:
            spec = {"driver": driver,
                    "kvstore": {"driver": "ocdbt", "base": f"file://{path}"},
                    "path": ".".join(str(k) for k, _ in keys)}
            leaf = _to_torch(ts.open(spec, open=True, context=ctx)
                             .result().read().result())
        node = root
        for i, (key, kind) in enumerate(keys):
            key = int(key) if kind == _INDEX else key
            if i == len(keys) - 1:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})
                if not isinstance(node, dict):
                    raise UnsupportedCheckpoint(f"{path}: a leaf and a "
                                                f"subtree at {keys[:i + 1]}")
    return _sequences(root)


# ---------------------------------------------------------------- optax ---

#: each optimizer kind's optax state, one entry per transform of its
#: chain: the field names of the transform's state, or None for an empty
#: one. The learning-rate transform keeps a count under a schedule and
#: nothing for a constant rate. clip_by_global_norm wraps the chain as
#: (its empty state, the chain).
_SCHED = ("count",)
_CHAINS = {
    "adam": [(("count", "mu", "nu"), _SCHED)],
    "adamw": [(("count", "mu", "nu"), None, _SCHED)],
    "sgd": [(None, _SCHED)],
    "sgdm/sgdmom": [(("trace",), _SCHED)],
    "rmsprop": [(("nu",), _SCHED, None)],
    "adagrad": [(("sum_of_squares",), _SCHED)],
}


def _chain_kinds(sig) -> List[str]:
    kinds = []
    for kind, forms in _CHAINS.items():
        for form in forms:
            if len(form) == len(sig) and all(
                    s == f or (f == _SCHED and s is None)
                    for s, f in zip(sig, form)):
                kinds.append(kind)
    return kinds


def optax_state(opt_state) -> Tuple[str, Dict[str, object], Optional[int]]:
    """(kind, slots, count) of a saved optax state: the optimizer kind
    (sgdm and sgdmom keep the same state), its slot trees by optax's
    names, and the update count (adam's, else the schedule's; None when
    the state keeps none)."""
    chain = opt_state
    if (isinstance(chain, list) and len(chain) == 2 and chain[0] is None
            and isinstance(chain[1], list)):
        chain = chain[1]                      # under clip_by_global_norm
    if not isinstance(chain, list) or not all(
            s is None or isinstance(s, dict) for s in chain):
        raise UnsupportedCheckpoint(f"optimizer state layout {_sig(chain)}")
    sig = tuple(None if s is None else tuple(sorted(s)) for s in chain)
    kinds = _chain_kinds(sig)
    if len(kinds) != 1:
        raise UnsupportedCheckpoint(
            f"optimizer state chain {sig} is none of the reference's "
            f"optimizer kinds ({', '.join(_CHAINS)})")
    slots, counts = {}, []
    for s in chain:
        for k, v in (s or {}).items():
            if k == "count":
                counts.append(int(v))
            elif k in OPTAX_SLOTS:
                slots[k] = v
    return kinds[0], slots, (counts[0] if counts else None)


def _sig(node):
    if isinstance(node, list):
        return [_sig(x) for x in node]
    if isinstance(node, dict):
        return sorted(node)
    return None if node is None else "leaf"


def _vqa_tree(path: str):
    tree = read_tree(path)
    if not isinstance(tree, dict) or set(tree) != {"step", "params",
                                                   "opt_state"}:
        raise UnsupportedCheckpoint(
            f"{path}: not a VQA TrainState (top-level keys "
            f"{_sig(tree)}, want step, params, opt_state)")
    kind, slots, count = optax_state(tree["opt_state"])
    step = int(tree["step"])
    return tree["params"], kind, slots, (step if count is None else count), \
        step


def restore_vqa(state, path: str):
    """Load the reference's VQA snapshot at `path` into the port's
    TrainState `state` (in place; the optimizer's kind must be the
    snapshot's) and return it."""
    params, kind, slots, count, step = _vqa_tree(path)
    load_flax_params(state.model, params)
    load_optax_state(state.opt, slots, count)
    state.step = step
    return state


def _torch_leaves(tree) -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict) and set(tree) == {"params"}:
        tree = tree["params"]
    return {k: as_torch(v).contiguous() for k, v in flatten(tree).items()}


def vqa_state_dict(path: str) -> dict:
    """The reference's VQA snapshot at `path` as the state dict that the
    port's `TrainState.load_state_dict` (and `utils/checkpoint.py`)
    reads."""
    params, kind, slots, count, step = _vqa_tree(path)
    return {"step": step, "params": _torch_leaves(params),
            "opt": {"count": count, "slots": {
                OPTAX_SLOTS[k]: _torch_leaves(v) for k, v in slots.items()}}}


def detector_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A detector checkpoint (the flax params of a FasterRCNN) as a
    `FasterRCNN` state dict."""
    return _torch_leaves(read_tree(path))


def load_detector(path: str) -> Dict[str, torch.Tensor]:
    """A detector state dict from a `.pt` this module wrote, or from an
    orbax directory (which needs tensorstore)."""
    if os.path.isdir(path):
        if not is_orbax_dir(path):
            raise FileNotFoundError(f"{path}: no _METADATA (not an orbax "
                                    "checkpoint)")
        return detector_state_dict(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a reference orbax checkpoint to a torch file")
    p.add_argument("kind", choices=["vqa", "detector"])
    p.add_argument("orbax_dir", help="the checkpoint's directory (the one "
                                     "holding _METADATA)")
    p.add_argument("out", help="the .pt file to write")
    a = p.parse_args(argv)
    if a.kind == "vqa":
        sd = vqa_state_dict(a.orbax_dir)
        n = len(sd["params"])
        what = (f"step {sd['step']}, {n} parameters, optimizer slots "
                f"{sorted(sd['opt']['slots'])}, count {sd['opt']['count']}")
    else:
        sd = detector_state_dict(a.orbax_dir)
        what = f"{len(sd)} parameters"
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    torch.save(sd, a.out)
    print(f"wrote {a.out}: {what}")


if __name__ == "__main__":
    main()
