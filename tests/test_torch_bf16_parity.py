"""The port's bf16 greedy decode against the JAX package's, on the CPU.

At the bf16 policy, exact agreement is not a contract: the two
frameworks round to bf16 at other places and sum in another order, and
with random weights argmax ties then pick other tokens. What is held is
a gate that the reference's own two decode paths (the XLA while_loop and
the Pallas kernel in interpret mode) meet against each other: the step-0
logprobs within BF16_STEP0_GAP, and at least BF16_AGREEMENT of all
tokens equal. Each test asserts the gate for the reference's pair and
for the port against each reference path, at the smoke dims, B=8, with
the parameter and batch seed of the case. The measured numbers are in
the assertion messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.utils.dtypes import BF16 as JBF16
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import load_flax_params
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.utils.dtypes import BF16

B = 8
BF16_STEP0_GAP = 5e-3
BF16_AGREEMENT = 0.80


def _gap_and_agreement(a, b):
    gap = float(np.abs(a["logprobs"][:, 0] - b["logprobs"][:, 0]).max())
    agree = float((a["seq"] == b["seq"]).mean())
    return gap, agree


@pytest.mark.parametrize("seed", range(4))
def test_bf16_decode_gate_met_by_reference_and_port(seed):
    cfg = tiny_cfg()
    batch = synthetic_batch(cfg, B, seed=seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = init_flax(JaxModel(cfg, ntoken=NTOKEN, policy=JF32), jb,
                     train=True, seed=seed)
    jtree = jax.tree.map(jnp.asarray, tree)
    outs = {}
    for path in ("xla", "pallas_interpret"):
        c = cfg.replace(speaker=cfg.speaker.replace(decode_kernel=path))
        out = JaxModel(c, ntoken=NTOKEN, policy=JBF16).apply(
            jtree, jb, method="decode", sample_max=True)
        outs[path] = {k: np.asarray(out[k], np.float32)
                      for k in ("seq", "logprobs")}
    model = load_flax_params(EkaidModel(port_cfg(cfg), NTOKEN, policy=BF16,
                                        device="cpu", seed=None), tree)
    out = model.decode(batch)
    outs["port"] = {k: to_np(out[k]) for k in ("seq", "logprobs")}
    for k in ("seq", "logprobs"):
        assert outs["port"][k].shape == outs["xla"][k].shape
    assert np.isfinite(outs["port"]["logprobs"]).all()

    pairs = (("xla", "pallas_interpret"), ("port", "xla"),
             ("port", "pallas_interpret"))
    measured = {f"{a} vs {b}": _gap_and_agreement(outs[a], outs[b])
                for a, b in pairs}
    msg = "; ".join(f"{k}: step-0 gap {g:.3g}, tokens equal {t:.3f}"
                    for k, (g, t) in measured.items())
    for gap, agree in measured.values():
        assert gap <= BF16_STEP0_GAP, msg
        assert agree >= BF16_AGREEMENT, msg
