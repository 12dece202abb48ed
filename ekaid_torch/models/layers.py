"""Building-block layers of the port, with torch-Linear-style init.

Counterpart of `ekaid_tpu/models/layers.py`. Parameters keep the
reference package's names and layouts (kernels are [in, out], LSTM
gates (i, f, g, o), GRU gates (r, z, n)), so a flax param tree maps
onto `state_dict()` keys one to one (`ekaid_torch/convert.py`).

Every product goes through `Policy.mm`: operands in the compute dtype,
f32 accumulation, one rounding to the compute dtype.

Dropout is inverted dropout (`dropout`): a module drops only when its
forward is given a `torch.Generator` on the tensor's device, and is the
identity without one (eval, decode, and the deterministic train step).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ekaid_torch.utils.dtypes import F32, Policy


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The identity when `gen` is None
    or rate <= 0. The mask is drawn from `gen`, which must live on x's
    device (`F.dropout` takes no generator)."""
    if gen is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return apply_mask(x, mask, keep)


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor],
               keep: float) -> torch.Tensor:
    """x / keep where mask, else 0; the identity for mask None."""
    if mask is None:
        return x
    return torch.where(mask, x / keep, torch.zeros_like(x))


def frobenius(x: torch.Tensor) -> torch.Tensor:
    """The Frobenius norm of x, sqrt(sum(x * x)), on either device (on
    the CPU, `torch.linalg.norm` of an f32 tensor of millions of
    elements strays far past f32 rounding)."""
    return torch.sqrt(torch.sum(x * x))


def _uniform(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): torch Linear's default."""
    bound = 1.0 / (fan_in ** 0.5)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_params(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `gen`, each atom by its own
    rule (the reference package's initializers, in module order)."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "_reset"):
                m._reset(gen)
    return module


class DenseT(nn.Module):
    """Dense layer: y = x @ kernel (+ bias), kernel [in, out]."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)

    def _reset(self, gen):
        fan_in = self.kernel.shape[0]
        self.kernel.copy_(_uniform(self.kernel.shape, fan_in, gen))
        if self.bias is not None:
            self.bias.copy_(_uniform(self.bias.shape, fan_in, gen))

    def forward(self, x):
        p = self.policy
        y = p.mm(p.cast_compute(x), p.cast_compute(self.kernel))
        if self.bias is not None:
            y = y + p.cast_compute(self.bias)
        return y


class WNDense(nn.Module):
    """Weight-normalized dense: kernel = g * v / ||v||_F (scalar g),
    the norm taken in f32 on the raw parameter."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.v = nn.Parameter(torch.empty(in_features, features))
        self.g = nn.Parameter(torch.empty(()))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)

    def _reset(self, gen):
        fan_in = self.v.shape[0]
        self.v.copy_(_uniform(self.v.shape, fan_in, gen))
        # g starts at torch.linalg.norm(v) on the CPU, where init runs:
        # up to ~7e-5 off `frobenius` on kernels of millions of elements,
        # so kernel = v only to that. It is the draw K1's gates in
        # chip_smoke.py are held on; g from `frobenius` re-draws the
        # weights and trips one of them (ROADMAP section 3, open).
        self.g.copy_(torch.linalg.norm(self.v.float()))
        if self.bias is not None:
            self.bias.copy_(_uniform(self.bias.shape, fan_in, gen))

    def forward(self, x):
        p = self.policy
        v = self.v.float()
        kernel = (self.g.float() / frobenius(v)) * v
        y = p.mm(p.cast_compute(x), p.cast_compute(kernel))
        if self.bias is not None:
            y = y + p.cast_compute(self.bias)
        return y


_ACTS = {"relu": torch.relu}


class FCNet(nn.Module):
    """Dropout -> WNDense (-> act) stack over dims [in, h1, ..., out]; the
    submodules are named WNDense_0, WNDense_1, ... as in flax."""

    def __init__(self, dims: Sequence[int], act: Optional[str] = "relu",
                 dropout: float = 0.0, use_bias: bool = True,
                 policy: Policy = F32):
        super().__init__()
        self.act = _ACTS[act.lower()] if act else None
        self.dropout = dropout
        dims = list(dims)
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"WNDense_{i}", WNDense(
                dims[i], dims[i + 1], use_bias=use_bias, policy=policy))

    def forward(self, x, gen: Optional[torch.Generator] = None):
        for i in range(self.n):
            x = dropout(x, self.dropout, gen)
            x = getattr(self, f"WNDense_{i}")(x)
            if self.act is not None:
                x = self.act(x)
        return x


def lstm_gates(z, c_prev):
    """(i, f, g, o) gate math of torch.nn.LSTMCell, in z's dtype."""
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


class LSTMCell(nn.Module):
    """torch.nn.LSTMCell math on one [x, h] @ w_ih / h @ w_hh pair with
    the two biases folded into `b`."""

    def __init__(self, in_dim: int, hidden: int, policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.hidden = hidden
        self.w_ih = nn.Parameter(torch.empty(in_dim, 4 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))

    def _reset(self, gen):
        for p in (self.w_ih, self.w_hh, self.b):
            p.copy_(_uniform(p.shape, self.hidden, gen))

    def pre_product(self, x):
        """The contribution of w_ih's first x.shape[-1] rows, for
        `forward`'s `pre`, rounded to the compute dtype."""
        p = self.policy
        return p.mm(p.cast_compute(x),
                    p.cast_compute(self.w_ih)[:x.shape[-1]])

    def forward(self, x, h, c, pre=None, pre_width: int = 0):
        """pre [B, 4H]: the first `pre_width` rows' contribution from
        `pre_product`; x then carries the remaining rows' features
        only."""
        p = self.policy
        xw = p.mm(p.cast_compute(x), p.cast_compute(self.w_ih)[pre_width:])
        if pre is not None:
            xw = xw + pre
        z = (xw + p.mm(p.cast_compute(h), p.cast_compute(self.w_hh))
             + p.cast_compute(self.b))
        return lstm_gates(z, p.cast_compute(c))


class GRU(nn.Module):
    """Full-sequence GRU (torch.nn.GRU, batch_first, h0 = 0).

    x [B, L, D] -> [B, L, H]; the input projection runs once over the
    whole sequence, the recurrent product once per step."""

    def __init__(self, in_dim: int, hidden: int, policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.hidden = hidden
        self.w_ih = nn.Parameter(torch.empty(in_dim, 3 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden))

    def _reset(self, gen):
        for p in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            p.copy_(_uniform(p.shape, self.hidden, gen))

    def forward(self, x):
        p = self.policy
        x_proj = p.mm(p.cast_compute(x), p.cast_compute(self.w_ih))
        x_proj = x_proj + p.cast_compute(self.b_ih)
        w_hh = p.cast_compute(self.w_hh)
        b_hh = p.cast_compute(self.b_hh)
        h = torch.zeros(x.shape[0], self.hidden, dtype=p.compute_dtype,
                        device=x.device)
        ys = []
        for t in range(x.shape[1]):
            hp = p.mm(h, w_hh) + b_hh
            xr, xz, xn = x_proj[:, t].chunk(3, dim=-1)
            hr, hz, hn = hp.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            ys.append(h)
        return torch.stack(ys, dim=1)


def normal_table(shape, gen: torch.Generator,
                 padding_idx: Optional[int] = None) -> torch.Tensor:
    """An embedding table drawn N(0, 1) with an optional zeroed padding
    row (torch nn.Embedding's default init)."""
    table = torch.randn(shape, generator=gen)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table
