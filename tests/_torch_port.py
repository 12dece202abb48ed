"""Shared setup of the ekaid_torch parity tests (not a test module).

The JAX package is the reference: a flax module is initialised with a
fixed PRNGKey, its param tree is exported as numpy and loaded into the
port through `ekaid_torch.convert`, and both get the same numpy inputs.
"""

import jax
import numpy as np
import torch

from ekaid_tpu.config import default_config
from ekaid_torch.config import load_config

# the xdist workers share the machine: keep torch's CPU pool small
torch.set_num_threads(2)

NTOKEN = 147


def tiny_cfg():
    """The smoke dims of tests/test_pallas_decode.py (reference Config)."""
    cfg = default_config()
    return cfg.replace(
        change_detector=cfg.change_detector.replace(
            att_dim=64, att_head=4, dim=16, pos_emb_dim=16),
        speaker=cfg.speaker.replace(
            input_dim=64, rnn_size=32, embed_input_dim=192, embed_dim=64,
            word_embed_size=24, seq_length=12),
        data=cfg.data.replace(num_nodes=8, feature_dim=48, adj_pad=20),
        question=cfg.question.replace(hidden_dim=64))


def port_cfg(jax_cfg):
    """The port's own Config with the same values as a reference one."""
    return load_config(overrides=jax_cfg.to_dict())


def np_tree(params):
    """A flax variable tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, params)


def init_flax(module, *args, seed=0, **kwargs):
    """Init a flax module (jitted: one compile instead of eager op-by-op
    dispatch) and return its numpy param tree."""
    rngs = {"params": jax.random.PRNGKey(seed),
            "dropout": jax.random.PRNGKey(seed + 1)}
    variables = jax.jit(lambda r, *a: module.init(r, *a, **kwargs))(
        rngs, *args)
    return np_tree(variables)


def to_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
