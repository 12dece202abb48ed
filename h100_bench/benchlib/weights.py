"""Seeded weights, made on the device in a few large calls.

Every parameter of the reference model is drawn by its module's
`init_rules` (the initialisers the model documents: torch Linear's
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for dense and recurrent weights,
N(0, 1) tables with the padding row zeroed, N(0, 1)/sqrt(fan_in) conv
kernels, unit norms, and a weight norm's g set to ||v||): one uniform
and one normal draw over all parameters from a generator on the device,
then sliced and scaled per parameter. The same state dict is loaded
into the program and into the reference.
"""

from __future__ import annotations

from typing import Dict

import torch


def _rules(model):
    """(full name, rule, argument, shape) for every parameter, in
    `named_parameters` order."""
    by_name = {}
    for prefix, mod in model.named_modules():
        if hasattr(mod, "init_rules"):
            for pname, rule, arg in mod.init_rules():
                full = f"{prefix}.{pname}" if prefix else pname
                by_name[full] = (rule, arg)
    out = []
    for name, p in model.named_parameters():
        if name not in by_name:
            raise KeyError(f"no init rule for {name}")
        out.append((name, *by_name[name], tuple(p.shape)))
    return out


def make_weights(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded f32 state dict of `model`'s parameters on `device`."""
    rules = _rules(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    n_uni = sum(_numel(s) for _, r, _, s in rules if r == "uniform")
    n_norm = sum(_numel(s) for _, r, _, s in rules
                 if r in ("normal", "scaled_normal"))
    uni = torch.rand(n_uni, generator=gen, device=device)
    nrm = torch.randn(n_norm, generator=gen, device=device)
    out, iu, ino = {}, 0, 0
    for name, rule, arg, shape in rules:
        n = _numel(shape)
        if rule == "uniform":
            t = (uni[iu:iu + n] * 2.0 - 1.0) * arg
            iu += n
        elif rule in ("normal", "scaled_normal"):
            t = nrm[ino:ino + n].clone()
            ino += n
            if rule == "scaled_normal":
                t = t * arg
        elif rule == "const":
            t = torch.full((n,), float(arg), device=device)
        elif rule == "norm_of":
            t = None
        else:
            raise ValueError(f"unknown init rule {rule!r} for {name}")
        if t is not None:
            t = t.reshape(shape)
            if rule == "normal" and arg is not None:
                t[arg] = 0.0
        out[name] = t
    for name, rule, arg, shape in rules:
        if rule == "norm_of":
            v = out[name.rsplit(".", 1)[0] + "." + arg]
            out[name] = torch.sqrt(torch.sum(v * v)).reshape(shape)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
