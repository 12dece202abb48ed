"""A JAX trainer and a port trainer on one reference checkpoint (shared
setup of the eval-driver, beam and serving tests; not a test module).

Both trainers are built by their package's `build_synthetic_trainer` at
`tiny_cfg` widths and f32, with an eval batch of 8 over the 8 test pairs of 80. The
JAX trainer's initial state, with the answer head's bias on token 0
raised so that answers end at varying lengths as trained ones do, is
written by the reference's `CheckpointManager` as step 3; the port's
trainer restores it through its own `CheckpointManager` (orbax, read
with tensorstore).
"""

import jax
import jax.numpy as jnp

from _torch_port import port_cfg, tiny_cfg
from ekaid_tpu.train.train import build_synthetic_trainer as jax_trainer
from ekaid_tpu.utils.checkpoint import CheckpointManager as JaxManager
from ekaid_torch.train.train import build_synthetic_trainer
from ekaid_torch.utils.checkpoint import CheckpointManager

N_PAIRS = 80
EOS_BIAS = 0.2
STEP = 3


def small_cfg():
    cfg = tiny_cfg()
    return cfg.replace(
        dtypes=cfg.dtypes.replace(compute_dtype="float32"),
        data=cfg.data.replace(
            num_workers=2, test=cfg.data.test.replace(batch_size=8)))


def paired_trainers(tmp_path, cfg=None):
    """(jax trainer, port trainer, snapshots dir), both on the
    checkpoint."""
    cfg = cfg or small_cfg()
    jtr = jax_trainer(cfg, str(tmp_path / "jax"), n_pairs=N_PAIRS)
    params = jax.tree.map(lambda x: x, jtr.state.params)
    bias = params["params"]["speaker"]["logit"]["bias"]
    params["params"]["speaker"]["logit"]["bias"] = bias.at[0].add(EOS_BIAS)
    jtr.state = jtr.state.replace(params=params,
                                  step=jnp.asarray(STEP, jnp.int32))
    snaps = tmp_path / "snapshots"
    JaxManager(str(snaps)).save(jtr.state)
    ptr = build_synthetic_trainer(port_cfg(cfg), str(tmp_path / "port"),
                                  n_pairs=N_PAIRS, device="cpu")
    CheckpointManager(str(snaps)).restore(ptr.state)
    assert ptr.state.step == STEP
    return jtr, ptr, snaps
