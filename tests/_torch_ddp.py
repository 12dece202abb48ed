"""One rank of the data-parallel step of tests/test_torch_parallel.py
(run as a process of its own; not a test module). It imports the port
only.

    python _torch_ddp.py RANK WORLD INIT_FILE INPUTS OUT

joins a gloo group through the `file://` rendezvous INIT_FILE, loads
the pickled inputs (config dict, flax param tree, global batch,
ntoken), takes one `train_step` in DDP on rows RANK::WORLD of the
batch (the Loader's shard of a global batch) with dropout off, and
saves the metrics and the all-reduced gradients to OUT.
"""

import datetime
import pickle
import sys

import torch
import torch.distributed as dist

TIMEOUT_S = 60
ATT_REG = 2.5e-3


def rank_step(rank: int, world: int, init_file: str, inputs: str,
              out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        from ekaid_torch.config import load_config
        from ekaid_torch.convert import load_flax_params
        from ekaid_torch.models.ekaid import EkaidModel
        from ekaid_torch.parallel import mesh
        from ekaid_torch.train.step import Forward, init_state, train_step
        from ekaid_torch.utils.dtypes import F32

        with open(inputs, "rb") as f:
            d = pickle.load(f)
        cfg = load_config(overrides=d["cfg"])
        grid = mesh.make_mesh(cfg.mesh, "cpu")
        model = load_flax_params(EkaidModel(cfg, d["ntoken"], policy=F32,
                                            device="cpu", seed=None,
                                            mesh=grid), d["tree"])
        state = init_state(model, cfg.train.optim)
        ddp = mesh.wrap(Forward(model), grid)
        part = {k: v[rank::world] for k, v in d["batch"].items()}
        m = train_step(state, part, 0, ATT_REG, train=False, ddp=ddp)
        torch.save({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": {n: (p.grad if p.grad is not None
                                  else torch.zeros_like(p)).clone()
                              for n, p in model.named_parameters()}}, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init_file, inputs, out = sys.argv[1:6]
    rank_step(int(r), int(w), init_file, inputs, out)
