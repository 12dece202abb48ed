"""Int8 core weights for the free-running decode (counterpart of
`ekaid_tpu/models/quant.py`; `speaker.weight_quant='int8'`).

The large `DynamicCore` matrices (at least QUANT_MIN_ELEMS elements) are
stored as per-output-channel symmetric int8 with an f32 scale a column:
w ~= q * scale, half a level (scale / 2) at most off. Biases and the
small heads (weight_fc, weight_pos, pos2) stay in the compute dtype.
Eval only: teacher forcing never sees quantized weights, and the greedy
kernel K1 refuses the knob (`models/greedy_decode.py`), so int8 decodes
run in the torch step loop (`DynamicSpeaker._sample_loop`).

The reference dequantizes (`q.astype(f32) * s -> compute dtype`) at each
use inside its XLA scan and pins the int8 buffers there with an
`optimization_barrier`, so that each step reads int8 from device memory.
That barrier changes no value. Eager torch has no loop to hoist out of,
so `make_quant_core_step` dequantizes once per decode call, into the
same values; the memory-traffic saving the reference was after is left
to later performance work.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from ekaid_torch.utils.dtypes import Policy

#: a 2-D core parameter of at least this many elements is stored int8
QUANT_MIN_ELEMS = 65536


def quantize_matrix(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (q int8 [I, O], scale f32 [O])
    with w ~= q * scale; a column of zeros gets scale 1. Both quotients
    are correctly rounded f32 divisions and the rounding is half to
    even, as the reference's, on either device: the 127 is a 0-d tensor
    because CUDA divides by a Python scalar as a product with its
    reciprocal, which moves ties."""
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_core_params(core: torch.nn.Module, policy: Policy
                         ) -> Dict[str, Union[Tuple[torch.Tensor,
                                                    torch.Tensor],
                                              torch.Tensor]]:
    """A DynamicCore's parameters keyed 'module.param' (e.g.
    'gate1x.kernel'): (q, scale) for the large matrices, the compute-dtype
    tensor for the rest."""
    out = {}
    for name, w in core.named_parameters():
        if w.dim() == 2 and w.numel() >= QUANT_MIN_ELEMS:
            out[name] = quantize_matrix(w)
        else:
            out[name] = policy.cast_compute(w.detach())
    return out


def make_quant_core_step(core: torch.nn.Module, policy: Policy):
    """The eval-mode DynamicCore step over int8 weights: the core's own
    forward (`torch.func.functional_call`) on the large matrices
    dequantized, (q.float() * s) in the compute dtype, and the other
    parameters cast to it. The weights are dequantized here, once."""
    dt = policy.compute_dtype
    w = {k: (v[0].float() * v[1]).to(dt) if isinstance(v, tuple) else v
         for k, v in quantize_core_params(core, policy).items()}
    return lambda *args: torch.func.functional_call(core, w, args)
