"""Reference VQA snapshots for the orbax-import tests (shared setup;
not a test module).

For one optimizer kind: `ekaid_tpu.train.step.init_state` (its model's
init replaced by one jitted init shared by every case), 2 steps of the
reference's jitted `train_step` (dropout off), a save by the
reference's `CheckpointManager`, then 3 more steps on the next batches.
The port reads the snapshot in a fresh interpreter that must not load
JAX, takes the same 3 steps through `train/step.py`, and is held per
tensor to ||port - jax|| / ||jax|| <= PARAM_RTOL.
"""

import json
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.train import step as jstep
from ekaid_tpu.utils.checkpoint import CheckpointManager as JaxManager
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import OPTAX_SLOTS, flatten
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.train import step as pstep

ROOT = Path(__file__).resolve().parent.parent
ATT_REG = 2.5e-3
SAVED, MORE = 2, 3
#: the bar of tests/test_torch_train_step.py against optax
PARAM_RTOL = 1e-5
#: parameters a softmax is invariant to (tests/test_torch_train_step.py):
#: their gradient is rounding noise, which adam, rmsprop and adagrad
#: scale to a full step of either sign, so they are not held to the bar
SHIFT_INVARIANT = re.compile(r"key\.WNDense_0\.bias$|FCNet_1\.WNDense_0\."
                             r"bias$|imp_relation\.gat\.bias\.")


def cfg():
    c = tiny_cfg()
    return c.replace(dtypes=c.dtypes.replace(compute_dtype="float32"))


def optim(c, kind, wd, clip):
    # a step size of 1 epoch of 1 step: the schedule moves every update
    return c.train.optim.replace(type=kind, weight_decay=wd,
                                 grad_clip=clip, step_size=1, gamma=0.5)


class _Init:
    """A model whose init returns given params (init_state's one use of
    its model)."""

    def __init__(self, params):
        self.params = params

    def init(self, *args, **kwargs):
        return self.params


def reference():
    """(cfg, flax model, params, numpy batches, jnp batches)."""
    c = cfg()
    batches = [synthetic_batch(c, 4, seed=s) for s in range(SAVED + MORE)]
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    flax = JaxModel(c, ntoken=NTOKEN, policy=JF32)
    params = jax.tree.map(jnp.asarray, init_flax(flax, jbs[0], train=True))
    return c, flax, params, batches, jbs


def snapshot(ref, directory, kind, wd, clip):
    """The saved state (numpy) and the params after MORE more steps."""
    c, flax, params, _, jbs = ref
    tx = jstep.make_optimizer(optim(c, kind, wd, clip), steps_per_epoch=1)
    state = jstep.init_state(_Init(params), tx, jbs[0],
                             jax.random.PRNGKey(0))
    step = jax.jit(partial(jstep.train_step, flax, tx, ATT_REG,
                           train=False))
    rng = jax.random.PRNGKey(1)
    for b in jbs[:SAVED]:
        state, _ = step(state, b, rng)
    JaxManager(str(directory)).save(state)
    saved = jax.tree.map(np.asarray, state)
    for b in jbs[SAVED:]:
        state, _ = step(state, b, rng)
    return saved, jax.tree.map(np.asarray, state.params)


def read_without_jax(pairs):
    """Convert each (orbax dir, out .pt) with
    `ekaid_torch.utils.orbax_import` in a fresh interpreter; returns the
    JAX-family modules it loaded."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from ekaid_torch.utils import orbax_import as oi\n"
        "for kind, src, out in json.loads(sys.argv[1]):\n"
        "    oi.main([kind, src, out])\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ekaid_tpu'))))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code,
         json.dumps([[k, str(s), str(o)] for k, s, o in pairs])],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def optax_slots(node, slots=None, counts=None):
    """The slot trees (by optax's names) and counts of an optax state."""
    slots = {} if slots is None else slots
    counts = [] if counts is None else counts
    if hasattr(node, "_fields"):
        for f in node._fields:
            if f == "count":
                counts.append(int(getattr(node, f)))
            elif f in OPTAX_SLOTS:
                slots[f] = getattr(node, f)
    elif isinstance(node, tuple):
        for x in node:
            optax_slots(x, slots, counts)
    return slots, counts


def assert_bit_equal(sd, saved):
    """The converted state dict against the saved numpy state."""
    assert sd["step"] == int(saved.step) == SAVED
    want = flatten(saved.params["params"])
    assert sorted(sd["params"]) == sorted(want)
    for n, w in want.items():
        got = sd["params"][n].numpy()
        assert got.dtype == w.dtype and np.array_equal(got, w), n
    slots, counts = optax_slots(saved.opt_state)
    assert sorted(sd["opt"]["slots"]) == sorted(OPTAX_SLOTS[k]
                                                for k in slots)
    assert sd["opt"]["count"] == (counts[0] if counts else SAVED) == SAVED
    for k, tree in slots.items():
        held = sd["opt"]["slots"][OPTAX_SLOTS[k]]
        for n, w in flatten(tree["params"]).items():
            assert np.array_equal(held[n].numpy(), w), (k, n)


def port_steps(ref, sd, kind, wd, clip):
    """The port's model and optimizer from `sd`, after MORE steps."""
    c, _, _, batches, _ = ref
    model = EkaidModel(port_cfg(c), NTOKEN, device="cpu", seed=None)
    state = pstep.init_state(model, port_cfg(c).train.optim.replace(
        **optim(c, kind, wd, clip).__dict__), steps_per_epoch=1)
    state.load_state_dict(sd)
    for b in batches[SAVED:]:
        pstep.train_step(state, b, 0, ATT_REG, train=False)
    assert state.step == SAVED + MORE and state.opt.count == SAVED + MORE
    return model


def assert_params_close(model, params):
    want = flatten(params["params"])
    for n, p in model.named_parameters():
        if SHIFT_INVARIANT.search(n):
            continue
        w = want[n]
        err = np.linalg.norm(p.detach().numpy() - w) / max(
            np.linalg.norm(w), 1e-30)
        assert err <= PARAM_RTOL, f"{n}: {err}"


def load(path):
    return torch.load(path, weights_only=True)
