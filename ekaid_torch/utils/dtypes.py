"""Mixed-precision policy: f32 params, bf16 compute, f32 softmax; the
LM decoder's parameters in the compute dtype (`lm_param_dtype`).

`Policy.mm` is the one matrix product of the port: operands in the
compute dtype, f32 accumulation, one rounding to the compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def canonical(name_or_dtype):
    if isinstance(name_or_dtype, str):
        return _NAMES[name_or_dtype]
    return name_or_dtype


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    softmax_dtype: torch.dtype = torch.float32

    @classmethod
    def from_config(cls, dtype_cfg) -> "Policy":
        return cls(param_dtype=canonical(dtype_cfg.param_dtype),
                   compute_dtype=canonical(dtype_cfg.compute_dtype),
                   softmax_dtype=canonical(dtype_cfg.softmax_dtype))

    def cast_compute(self, x):
        return x.to(self.compute_dtype)

    def cast_softmax(self, x):
        return x.to(self.softmax_dtype)

    def mm(self, a, b):
        """a @ b accumulated in f32 and rounded once to the compute
        dtype (the reference's `preferred_element_type` dot)."""
        return torch.matmul(a.float(), b.float()).to(self.compute_dtype)


def cast_params_for_inference(module: torch.nn.Module,
                              policy: Policy) -> torch.nn.Module:
    """Cast a module's f32 params to the compute dtype once, in place.

    Weight-norm modules ({v, g} + optional bias) are skipped: WNDense
    takes ||v|| of the raw f32 param, and a pre-rounded v would change
    the norm. Use on an inference copy only.
    """
    if policy.compute_dtype == torch.float32:
        return module
    from ekaid_torch.models.layers import WNDense
    skip = {id(p) for m in module.modules() if isinstance(m, WNDense)
            for p in m.parameters(recurse=False)}
    with torch.no_grad():
        for p in module.parameters():
            if id(p) not in skip and p.dtype == torch.float32:
                p.data = p.data.to(policy.compute_dtype)
    return module


def lm_param_dtype(policy: Policy) -> torch.dtype:
    """The dtype of the LM decoder's parameters: the compute dtype, as
    the checkpoint ships them (bf16), never f32 masters: 15.7 B f32
    parameters (63 GB) could not sit beside anything else on one card.
    `cast_params_for_inference` finds nothing of the LM to cast."""
    return policy.compute_dtype


F32 = Policy(compute_dtype=torch.float32)
BF16 = Policy()
