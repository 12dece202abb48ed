"""The train and eval steps and the optimizer (counterpart of
`ekaid_tpu/train/step.py`).

The optimizer kinds of the reference's `make_optimizer` are written out
here with optax's update rules, not taken from `torch.optim`, whose
classes of the same names differ: optax keeps one step count for the
whole parameter set, updates every parameter (a parameter without a
gradient takes a zero one: the frozen embedding copy `emb_fixed` then
stays put, except under adamw's weight decay, which optax applies to it
too), puts rmsprop's eps inside the square root, starts adagrad's
accumulator at 0.1 with eps 1e-7, and clips by the global norm only
when that norm reaches the limit. The learning rate follows
`optax.exponential_decay(staircase=True)` over the update count, one
transition every `step_size` epochs, or a schedule given to the
optimizer (the detector trainer's `warmup_cosine`). A schedule's count
starts at 0, as optax's does: with a warmup from 0, the first update
moves nothing. Updates are in place, with
`torch._foreach_*` ops, so every parameter's version counter moves with
each step (the decode weight caches key on it).

Random draws are a function of (seed, step, microbatch, and the index
on a data axis of several processes): a resumed run draws what the
uninterrupted run drew, and no generator state is saved.

Data parallel (`train_step(..., ddp=...)`, `parallel/mesh.py`): each
data rank's batch is its part of the global batch. The loss is the
reference's global-batch quantity: the answer NLL divided by the
answer tokens of the whole global batch and the attention term by
twice its pairs (both all-reduced over the data group), so each rank's
term is its share of the global loss. DDP averages the gradients over
the data group, so each rank's term is scaled by the data axis's size
first: the all-reduced gradient is then the global loss's, on every
rank, whatever the ranks' answer lengths. (Averaging per-rank mean
losses would weight each rank's tokens by the inverse of its own token
count.) Every rank holds the whole model and optimizer state, so a
state dict (`TrainState.state_dict`) is the same on every rank and
restores at any data axis.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ekaid_torch.models.ekaid import total_loss
from ekaid_torch.models.layers import WNDense, frobenius
from ekaid_torch.parallel.mesh import all_reduce_sum

KINDS = ("adam", "sgd", "sgdm", "sgdmom", "rmsprop", "adagrad")
ADAGRAD_INIT = 0.1
ADAGRAD_EPS = 1e-7
#: the random streams of a step
DROPOUT, SAMPLE = 0, 1


def exponential_decay(lr: float, transition_steps: int, gamma: float,
                      count: int) -> float:
    """optax.exponential_decay(staircase=True) at `count`, in f32."""
    if transition_steps <= 0 or gamma == 0 or count <= 0:
        return float(np.float32(lr))
    p = np.float32(math.floor(count / transition_steps))
    return float(np.float32(lr) * np.power(np.float32(gamma), p))


def warmup_cosine(lr: float, warmup: int, total_steps: int
                  ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total_steps) in
    its f32 arithmetic: linear from 0 to lr over `warmup` updates, then
    a cosine to 0 at `total_steps`. The cosine is rounded once from
    double (XLA's f32 cosine is within an ulp of it)."""
    if not total_steps - warmup > 0:
        raise ValueError(f"warmup_cosine needs total_steps > warmup, got "
                         f"{total_steps} and {warmup}")
    f32 = np.float32
    peak, decay = f32(lr), f32(total_steps - warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            c = f32(min(max(count, 0), warmup))
            frac = f32(1) - c / f32(warmup)
            return float(f32(-peak * frac) + peak)
        c = min(f32(count - warmup), decay)
        x = f32(np.pi) * c / decay
        cosine = f32(0.5) * (f32(1) + f32(np.cos(np.float64(x))))
        return float(peak * cosine)

    return schedule


class Optimizer:
    """One of `KINDS` with optax's update rule, grad clipping by global
    norm and the step-decay schedule (or `schedule`: the learning rate of
    each update count), over every parameter of `model`.

    State: `count` (updates applied) and, by kind, mu/nu (adam), trace
    (sgdm, sgdmom), nu (rmsprop), acc (adagrad), one tensor a parameter,
    in `model.named_parameters()` order."""

    def __init__(self, optim_cfg, model: nn.Module,
                 steps_per_epoch: Optional[int] = None,
                 schedule: Optional[Callable[[int], float]] = None):
        if optim_cfg.type not in KINDS:
            raise ValueError(f"bad option for optimizer: {optim_cfg.type}")
        self.cfg = optim_cfg
        self.schedule = schedule
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.transition = (optim_cfg.step_size * steps_per_epoch
                           if steps_per_epoch else 0)
        self.count = 0
        self.slots = {k: [torch.full_like(p, v) for p in self.params]
                      for k, v in self._slot_inits().items()}

    def _slot_inits(self) -> Dict[str, float]:
        kind = self.cfg.type
        return {"adam": {"mu": 0.0, "nu": 0.0}, "sgd": {},
                "sgdm": {"trace": 0.0}, "sgdmom": {"trace": 0.0},
                "rmsprop": {"nu": 0.0},
                "adagrad": {"acc": ADAGRAD_INIT}}[kind]

    def lr(self, count: Optional[int] = None) -> float:
        """The learning rate of update `count` (default: the next)."""
        c = self.count if count is None else count
        if self.schedule is not None:
            return self.schedule(c)
        return exponential_decay(self.cfg.lr, self.transition,
                                 self.cfg.gamma, c)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             grad_norm: Optional[torch.Tensor] = None) -> None:
        """Apply one update from `grads` (one a parameter, in order).
        grad_norm: their global norm, when the caller has it."""
        c = self.cfg
        if c.grad_clip > 0:
            if grad_norm is None:
                grad_norm = global_norm(grads)
            under = grad_norm < c.grad_clip
            denom = torch.where(under, torch.ones_like(grad_norm), grad_norm)
            mult = torch.where(under, torch.ones_like(grad_norm),
                               torch.full_like(grad_norm, c.grad_clip))
            grads = torch._foreach_mul(torch._foreach_div(grads, denom), mult)
        lr = self.lr()
        self.count += 1
        kind, s = c.type, self.slots
        if kind == "adam":
            b1, b2 = c.alpha, c.beta
            torch._foreach_mul_(s["mu"], b1)
            torch._foreach_add_(s["mu"], torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(s["nu"], b2)
            torch._foreach_add_(s["nu"], torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            n = np.float32(self.count)
            bc1 = float(1 - np.power(np.float32(b1), n))
            bc2 = float(1 - np.power(np.float32(b2), n))
            root = torch._foreach_sqrt(torch._foreach_div(s["nu"], bc2))
            torch._foreach_add_(root, c.epsilon)
            u = torch._foreach_div(torch._foreach_div(s["mu"], bc1), root)
            if c.weight_decay > 0:
                torch._foreach_add_(u, self.params, alpha=c.weight_decay)
        elif kind == "sgd":
            u = grads
        elif kind in ("sgdm", "sgdmom"):
            torch._foreach_mul_(s["trace"], c.alpha)
            torch._foreach_add_(s["trace"], grads)
            u = s["trace"]
            if kind == "sgdmom":
                u = [g + c.alpha * t for g, t in zip(grads, u)]
        elif kind == "rmsprop":
            torch._foreach_mul_(s["nu"], c.alpha)
            torch._foreach_add_(s["nu"], torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - c.alpha))
            u = [torch.rsqrt(v + c.epsilon) * g
                 for v, g in zip(s["nu"], grads)]
        else:                                               # adagrad
            torch._foreach_add_(s["acc"], torch._foreach_mul(grads, grads))
            u = [torch.where(a > 0, torch.rsqrt(a + ADAGRAD_EPS),
                             torch.zeros_like(a)) * g
                 for a, g in zip(s["acc"], grads)]
        torch._foreach_add_(self.params, u, alpha=-lr)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "slots": {k: dict(zip(self.names, v))
                          for k, v in self.slots.items()}}

    def load_state_dict(self, sd: dict) -> None:
        if set(sd["slots"]) != set(self.slots):
            raise ValueError(f"optimizer kind {self.cfg.type!r} keeps slots "
                             f"{sorted(self.slots)}; the state holds "
                             f"{sorted(sd['slots'])}")
        self.count = int(sd["count"])
        with torch.no_grad():
            for k, held in self.slots.items():
                for name, t in zip(self.names, held):
                    t.copy_(sd["slots"][k][name])


def make_optimizer(optim_cfg, model: nn.Module,
                   steps_per_epoch: Optional[int] = None) -> Optimizer:
    """The reference's optimizer choice: adam (adamw when weight_decay >
    0), sgd, sgdm, sgdmom (Nesterov), rmsprop or adagrad, with grad_clip
    > 0 clipping by global norm and the step decay when steps_per_epoch
    is given."""
    return Optimizer(optim_cfg, model, steps_per_epoch)


@dataclass
class TrainState:
    """The step count, the model (its parameters are the f32 masters)
    and the optimizer with its state."""
    step: int
    model: nn.Module
    opt: Optimizer

    def state_dict(self) -> dict:
        """The step, the parameters and the optimizer state."""
        return {"step": self.step, "params": self.model.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """A file without "opt" holds parameters only (a converted
        reference checkpoint, `tools/torch_convert.py --kind model`):
        the optimizer keeps the state it has."""
        self.step = int(sd["step"])
        if "opt" not in sd:
            from ekaid_torch.tools.torch_convert import load_params
            load_params(self.model, sd["params"])
            return
        self.model.load_state_dict(sd["params"])
        self.opt.load_state_dict(sd["opt"])


def init_state(model: nn.Module, optim_cfg,
               steps_per_epoch: Optional[int] = None) -> TrainState:
    return TrainState(0, model, make_optimizer(optim_cfg, model,
                                               steps_per_epoch))


def generator(seed: int, step: int, micro: int, stream: int,
              device, rank: int = 0) -> torch.Generator:
    """A generator on `device` seeded from (seed, step, microbatch,
    stream) and, past index 0 of a data axis, that index `rank` (index
    0 draws what one process draws)."""
    entropy = [seed & 0xFFFFFFFF, step, micro, stream] + (
        [rank] if rank else [])
    words = np.random.SeedSequence(entropy).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)
    return g


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor."""
    return frobenius(torch.stack([frobenius(t.float()) for t in tensors]))


def _cast_params(model: nn.Module, policy) -> Dict[str, torch.Tensor]:
    """The f32 masters cast to the compute dtype (weight-norm pairs
    stay f32: their norm is taken on the raw parameter), with autograd
    through the cast."""
    skip = {id(p) for m in model.modules() if isinstance(m, WNDense)
            for p in m.parameters(recurse=False)}
    return {n: (p.to(policy.compute_dtype)
                if id(p) not in skip and p.dtype == torch.float32 else p)
            for n, p in model.named_parameters()}


class Forward(nn.Module):
    """The model's training forward as one module, the one DDP wraps:
    with `params`, the model runs on them (`functional_call`, for
    train_step's param_cast)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, params=None, **kwargs):
        if params is None:
            return self.model(batch, **kwargs)
        return functional_call(self.model, params, (batch,), kwargs)


def train_step(state: TrainState, batch, seed: int,
               att_reg_weight: float, ss_prob: float = 0.0,
               param_cast: bool = False, accum_steps: int = 1,
               entropy_weight: float = 0.0,
               train: bool = True,
               ddp: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on `batch`, in place; returns total_loss,
    speaker_loss, att_reg (entropy with an entropy weight) and grad_norm
    as 0-d tensors on the model's device (no host sync).

    param_cast: cast the f32 masters to the compute dtype inside the
    gradient (the products then read compute-dtype weights, and the
    weight gradients accumulate in that dtype). accum_steps: microbatch
    i is samples i::accum_steps, each normalised by the whole batch's
    mask sum and size, so the microbatch losses and gradients sum to the
    full batch's; one update. train=False: no dropout and no scheduled
    sampling. Each parameter's `.grad` holds this step's gradient (before
    clipping) until the next step.

    ddp: `Forward(state.model)` wrapped by `parallel.mesh.wrap` on the
    model's mesh; `batch` is then this data rank's part of the global
    batch, and the returned losses and the gradients are the global
    batch's, equal on every rank of the data group (see the module
    docstring)."""
    model, opt = state.model, state.opt
    policy = model.policy
    b = model.tensors(batch, train=True)
    dev = model.device
    mesh = model.mesh
    if ddp is not None and mesh is None:
        raise ValueError("a DDP step needs the model's mesh: build it "
                         "with EkaidModel(..., mesh=parallel.mesh."
                         "make_mesh(...))")
    data, d = (mesh.data, mesh.rank) if ddp is not None else (1, 0)

    def loss_fn(mb, micro, lang_denom=None, batch_denom=None):
        gens = {}
        if train:
            gens = {"gen": generator(seed, state.step, micro, DROPOUT, dev,
                                     d),
                    "ss_gen": generator(seed, state.step, micro, SAMPLE,
                                        dev, d)}
        params = (_cast_params(model, policy) if param_cast
                  and policy.compute_dtype != torch.float32 else None)
        fwd = ddp if ddp is not None else Forward(model)
        out = fwd(mb, params, ss_prob=ss_prob, **gens)
        return total_loss(out, mb, att_reg_weight,
                          entropy_weight=entropy_weight,
                          lang_denom=lang_denom, batch_denom=batch_denom)

    model.zero_grad(set_to_none=True)
    B = b["labels"].shape[0]
    if B % accum_steps:
        raise ValueError(f"batch size {B} not divisible by "
                         f"train.accum_steps={accum_steps}")
    lang_denom = batch_denom = None
    if accum_steps > 1 or ddp is not None:
        # the whole (global) batch's answer tokens and pairs
        sums = torch.stack([b["masks"][:, 1:].float().sum(),
                            torch.tensor(float(B), device=dev)])
        if ddp is not None:
            sums = all_reduce_sum(sums)
        lang_denom = torch.clamp(sums[0], min=1.0)
        batch_denom = sums[1] if ddp is not None else B
    loss, aux = 0.0, {}
    for i in range(accum_steps):
        mb = ({k: v[i::accum_steps] for k, v in b.items()}
              if accum_steps > 1 else b)
        last = i == accum_steps - 1
        with (ddp.no_sync() if ddp is not None and not last
              else contextlib.nullcontext()):
            li, ai = loss_fn(mb, i, lang_denom, batch_denom)
            # DDP averages over the data group: scale back to its sum
            (li * data if data > 1 else li).backward()
        loss = loss + li.detach()
        for k, v in ai.items():
            aux[k] = aux.get(k, 0.0) + v.detach()
    if ddp is not None:
        keys = list(aux)
        sums = all_reduce_sum(torch.stack([loss] + [aux[k] for k in keys]))
        loss, aux = sums[0], dict(zip(keys, sums[1:]))
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in opt.params]
    gn = global_norm(grads)
    opt.step(grads, gn)
    state.step += 1
    return {"total_loss": loss, **aux, "grad_norm": gn}


@torch.no_grad()
def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
    """Greedy decode (K1 on a CUDA model)."""
    return state.model.decode(batch)
