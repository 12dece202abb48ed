"""One rank of tests/test_torch_tensor_parallel.py (run as a process of
its own; not a test module). It imports the port only.

    python _torch_tp.py RANK WORLD INIT_FILE INPUTS OUT

joins a gloo group of WORLD processes through the `file://` rendezvous
INIT_FILE, places itself on the mesh that the pickled config names
(`parallel.mesh.make_mesh`), runs the tasks that INPUTS lists and saves
their results to OUT:

  * "ops": the conjugate ops of `parallel/tensor.py` over the model
    group on seeded f64 tensors, forward and backward;
  * "step": one `train_step` with dropout off on rows d::data of the
    global batch (the Loader's shard), from the pickled flax params:
    the metrics, each rank's parameter shapes, and the full gradients,
    parameters and Adam slots after it, gathered over the model group;
  * "snapshot": restore the snapshot INPUTS names, hold this rank's
    blocks against the file's full tensors, and write it again from
    the restored state under another name;
  * "eval": `Trainer.evaluate` of a synthetic trainer: the predictions
    (rank 0) and the rows of each greedy decode this rank ran; then its
    model's greedy decode of the global batch.
"""

import datetime
import pickle
import sys

import torch
import torch.distributed as dist

TIMEOUT_S = 60
ATT_REG = 2.5e-3


def ops(grid) -> dict:
    """Forward and backward of each conjugate op on seeded f64 tensors:
    x is replicated, parts[i] is rank i's block and u[i] weighs rank
    i's output in the loss. Returns the draws and each op's (output,
    input gradient) on this rank."""
    from ekaid_torch.parallel import tensor
    g, m, parts_n = grid.model_group, grid.m, grid.model
    gen = torch.Generator().manual_seed(7)
    f64 = torch.float64
    x = torch.randn(3, 8, generator=gen, dtype=f64)
    parts = torch.randn(parts_n, 3, 8, generator=gen, dtype=f64)
    u = torch.randn(parts_n, 3, 8 * parts_n, generator=gen, dtype=f64)
    spans = [(0, 3), (3, 8)] + [(8, 8)] * (parts_n - 2)
    out = {"x": x, "parts": parts, "u": u, "spans": spans}

    def run(name, leaf, fn, weight):
        leaf = leaf.clone().requires_grad_()
        y = fn(leaf)
        (y * weight).sum().backward()
        out[name] = (y.detach(), leaf.grad)

    run("copy_in", x, lambda t: tensor.copy_in(t, g), u[m, :, :8])
    run("reduce_out", parts[m], lambda t: tensor.reduce_out(t, g),
        u[0, :, :8])
    run("gather_last", parts[m], lambda t: tensor.gather_last(t, g), u[0])
    a, b = spans[m]
    run("take_slice", x, lambda t: tensor.take_slice(t, spans, m, g),
        u[m, :, a:b])
    return out


def step(d, cfg, grid) -> dict:
    from ekaid_torch.convert import load_flax_params
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.parallel import mesh
    from ekaid_torch.parallel.tensor import full_state
    from ekaid_torch.train.step import Forward, init_state, train_step
    from ekaid_torch.utils.dtypes import F32
    model = load_flax_params(EkaidModel(cfg, d["ntoken"], policy=F32,
                                        device="cpu", seed=None, mesh=grid),
                             d["tree"])
    state = init_state(model, cfg.train.optim)
    ddp = mesh.wrap(Forward(model), grid)
    part = {k: v[grid.d::grid.data] for k, v in d["batch"].items()}
    m = train_step(state, part, 0, ATT_REG, train=False, ddp=ddp,
                   accum_steps=cfg.train.accum_steps)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    sd = state.state_dict()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "shapes": {n: tuple(p.shape) for n, p in
                       model.named_parameters()},
            "grads": full_state(grads, state.opt.shards),
            "params": sd["params"], "slots": sd["opt"]["slots"]}


def snapshot(d, cfg, grid) -> dict:
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.train.step import init_state
    from ekaid_torch.utils.checkpoint import CheckpointManager
    from ekaid_torch.utils.dtypes import F32
    model = EkaidModel(cfg, d["ntoken"], policy=F32, device="cpu", seed=1,
                       mesh=grid)
    state = init_state(model, cfg.train.optim)
    ckpt = CheckpointManager(d["snapshot_dir"])
    ckpt.restore(state, name=d["snapshot_in"])
    held = torch.load(ckpt._path(d["snapshot_in"]), weights_only=True)
    blocks_equal = all(
        torch.equal(p, shard.take(held["params"][n]))
        for n, p in model.named_parameters()
        for shard in [state.opt.shards.get(n)] if shard is not None)
    slots_equal = all(
        torch.equal(t, state.opt.shards[n].take(held["opt"]["slots"][k][n]))
        for k, ts in state.opt.slots.items()
        for n, t in zip(state.opt.names, ts) if n in state.opt.shards)
    sd = state.state_dict()
    if grid.rank == 0:
        ckpt.save(sd, name=d["snapshot_out"])
    return {"blocks_equal": blocks_equal, "slots_equal": slots_equal,
            "sharded": sorted(state.opt.shards),
            "count": state.opt.count, "step": state.step}


def evaluate(d, cfg, grid) -> dict:
    from ekaid_torch.models import decoder
    from ekaid_torch.train.train import build_synthetic_trainer
    rows = []
    plain = decoder.greedy_decode

    def counted(w, c, policy, fused, feats, *a, **k):
        rows.append(fused.shape[0])
        return plain(w, c, policy, fused, feats, *a, **k)

    decoder.greedy_decode = counted
    tr = build_synthetic_trainer(cfg, d["workdir"] + f"/r{grid.rank}",
                                 n_pairs=d["eval_pairs"], device="cpu")
    scores, predictions = tr.evaluate(max_batches=d["eval_batches"])
    out = tr.model.decode(d["batch"])
    return {"predictions": predictions, "rows": rows,
            "sharded": sorted(tr.state.opt.shards),
            "decode": {k: out[k] for k in ("seq", "logprobs",
                                           "module_weights", "feat_diff")}}


def main(rank: int, world: int, init_file: str, inputs: str,
         out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        from ekaid_torch.config import load_config
        from ekaid_torch.parallel import mesh
        with open(inputs, "rb") as f:
            d = pickle.load(f)
        cfg = load_config(overrides=d["cfg"])
        grid = mesh.make_mesh(cfg.mesh, "cpu")
        res = {"grid": (grid.data, grid.model, grid.d, grid.m)}
        tasks = {"ops": lambda: ops(grid), "step": lambda: step(d, cfg, grid),
                 "snapshot": lambda: snapshot(d, cfg, grid),
                 "eval": lambda: evaluate(d, cfg, grid)}
        for name in d["tasks"]:
            res[name] = tasks[name]()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init_file, inputs, out = sys.argv[1:6]
    main(int(r), int(w), init_file, inputs, out)
