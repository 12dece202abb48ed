"""The greedy decode (K1's path) reads the weights of the current training
step: after an optimizer step (in place, with `torch._foreach_*` ops), an
in-place add to each parameter in turn, and an in-place copy, both of its
weight caches (the speaker's `decode_weights` and the kernel's packed
weights) are rebuilt; a set left untouched is not."""

import pytest
import torch

from _torch_port import NTOKEN, port_cfg, tiny_cfg
from ekaid_torch.data.synthetic import synthetic_batch
from ekaid_torch.models import greedy_decode as gd
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.train.step import init_state, train_step
from ekaid_torch.utils.dtypes import Policy


def _model(dtype):
    cfg = port_cfg(tiny_cfg())
    cfg = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype=dtype))
    return cfg, EkaidModel(cfg, NTOKEN, policy=Policy.from_config(
        cfg.dtypes), device="cpu", seed=0)


def _plan(cfg, itemsize):
    sp = cfg.speaker
    return gd.decode_plan(4, sp.embed_dim, sp.rnn_size, sp.input_dim,
                          sp.word_embed_size, sp.vocab_size, sp.pos_classes,
                          sms=132, itemsize=itemsize)


def _fresh(model):
    """The decode weights built now from the parameters, bypassing the
    speaker's cache."""
    return gd.decode_weights(model.speaker, model.cfg.speaker, model.policy)


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["foreach", "per_tensor", "copy_"])
def test_caches_follow_the_parameters(dtype, how):
    cfg, model = _model(dtype)
    sp = model.speaker
    plan = _plan(cfg, 4 if dtype == "float32" else 2)
    w0 = sp.decode_weights()
    p0 = gd._packed_weights(w0, plan)
    # untouched: neither cache is rebuilt
    assert sp.decode_weights() is w0
    assert gd._packed_weights(sp.decode_weights(), plan) is p0
    old = {k: v.clone() for k, v in w0.items()}
    if how == "copy_":
        with torch.no_grad():
            sp.core.gate1x.kernel.copy_(sp.core.gate1x.kernel * 1.5)
            sp.logit.kernel.copy_(sp.logit.kernel.flip(0))
    elif how == "per_tensor":
        with torch.no_grad():
            for i, p in enumerate(model.parameters()):
                p.add_(torch.full_like(p, 1e-2 * (i % 3 + 1)))
    else:
        state = init_state(model, cfg.train.optim.replace(lr=1e-2))
        train_step(state, synthetic_batch(cfg, 4, seed=1), 0,
                   cfg.train.att_reg_weight)
    w1 = sp.decode_weights()
    assert w1 is not w0
    assert _same(w1, _fresh(model))
    assert not torch.equal(w1["wg1"], old["wg1"])
    assert not torch.equal(w1["wlogit"], old["wlogit"])
    p1 = gd._packed_weights(w1, plan)
    assert p1 is not p0
    jobs = {j.kind: j for js in plan.phases for j in js}
    for kind, names in gd.PRODUCT_WEIGHTS.items():
        for n in names:
            assert torch.equal(p1[n], gd.pack_weight(w1[n], jobs[kind])), n
    # and the set stays cached until the next change
    assert sp.decode_weights() is w1
    assert gd._packed_weights(w1, plan) is p1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_after_a_step_uses_that_steps_weights(dtype):
    """decode() after train steps equals the plain decode on weights
    built fresh from the updated parameters, and differs from the decode
    before the steps."""
    cfg, model = _model(dtype)
    batch = synthetic_batch(cfg, 4, seed=2)
    before = model.decode(batch)
    state = init_state(model, cfg.train.optim.replace(lr=3e-2))
    for s in range(2):
        train_step(state, synthetic_batch(cfg, 4, seed=10 + s), 0,
                   cfg.train.att_reg_weight)
    after = model.decode(batch)
    enc = model.encode(batch)
    fused, feats = model.speaker._fused(enc["feat_bef"], enc["feat_diff"],
                                        enc["feat_aft"])
    want = gd.greedy_decode_plain(_fresh(model), cfg.speaker, model.policy,
                                  fused, feats)
    for k in ("seq", "logprobs", "module_weights"):
        assert torch.equal(after[k], want[k]), k
    assert not torch.equal(after["logprobs"], before["logprobs"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_weights_keep_no_set_alive(dtype):
    """The packed cache holds its sets by weak reference: once the
    speaker's decode weights are rebuilt (as after a step, or a fresh
    gather of sharded weights), the old set and its packed copies go;
    the new set packs anew."""
    import gc
    import weakref
    cfg, model = _model(dtype)
    sp = model.speaker
    plan = _plan(cfg, 4 if dtype == "float32" else 2)
    gd._packed.clear()
    w0 = gd.decode_weights(sp, cfg.speaker, model.policy)
    p0 = gd._packed_weights(w0, plan)
    gone = weakref.ref(p0["wlogit"])
    del p0
    assert len(gd._packed) == 1 and gone() is not None
    w1 = gd.decode_weights(sp, cfg.speaker, model.policy)
    p1 = gd._packed_weights(w1, plan)
    assert len(gd._packed) == 2
    del w0
    gc.collect()
    assert gone() is None
    assert len(gd._packed) == 1
    assert gd._packed_weights(w1, plan) is p1
    gd._packed.clear()
