"""The ranks of the data-axis tests (tests/test_torch_parallel.py,
tests/test_torch_data_parallel.py) and their launcher; not a test
module. A rank runs as a process of its own and imports the port only.

    python _torch_ddp.py RANK WORLD INIT_FILE INPUTS OUT

joins a gloo group of WORLD processes through the `file://` rendezvous
INIT_FILE, places itself on the data axis (`parallel.mesh.make_mesh`),
runs the tasks that INPUTS lists and saves their results to OUT:

  * "step": one `train_step` in DDP with dropout off on rows
    rank::WORLD of the global batch (the Loader's shard), from the
    pickled flax params: the metrics, and the gradients, parameters and
    Adam slots after it;
  * "snapshot": after the step, rank 0 writes the state as the snapshot
    INPUTS names, and every rank returns its data-sharded greedy decode
    of the global batch;
  * "axis": after the step, `make_mesh` under the group with mesh.data
    -1 and with another size, and the step's model decoding a batch
    that the ranks do not divide (each refusal's message);
  * "eval": `Trainer.evaluate` of a synthetic trainer: the predictions
    (rank 0) and the rows of each greedy decode this rank ran; then its
    model's greedy decode of the global batch.

`launch` runs WORLD ranks on INPUTS from a test, and `one_process_step`
is the step in one process that the ranks' step is held against.
"""

import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

HERE = Path(__file__).resolve().parent
TIMEOUT_S = 60
RANK_TIMEOUT_S = 120
ATT_REG = 2.5e-3
DECODED = ("seq", "logprobs", "module_weights", "feat_diff")


def one_process_step(pcfg, tree, ntoken, batch) -> dict:
    """The port's step on `batch` in one process, from the flax params
    `tree`, dropout off: metrics, gradients, parameters and Adam slots
    after it."""
    from ekaid_torch.convert import load_flax_params
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.train.step import init_state, train_step
    from ekaid_torch.utils.dtypes import F32
    model = load_flax_params(EkaidModel(pcfg, ntoken, policy=F32,
                                        device="cpu", seed=None), tree)
    state = init_state(model, pcfg.train.optim)
    m = train_step(state, batch, 0, ATT_REG, train=False,
                   accum_steps=pcfg.train.accum_steps)
    return _results(state, m)


def launch(tmp: Path, world: int, inputs: dict) -> list:
    """Run `world` ranks of this script on `inputs` (joined through a
    rendezvous file in `tmp`, each waited for RANK_TIMEOUT_S); their
    results."""
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE), str(HERE.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_ddp.py"), str(r), str(world),
         str(tmp / "rendezvous"), str(tmp / "inputs.pkl"),
         str(tmp / f"rank{r}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _results(state, m) -> dict:
    sd = state.state_dict()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).detach().clone()
                      for n, p in state.model.named_parameters()},
            "params": sd["params"], "slots": sd["opt"]["slots"]}


def step(d, cfg, grid) -> tuple:
    from ekaid_torch.convert import load_flax_params
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.parallel import mesh
    from ekaid_torch.train.step import Forward, init_state, train_step
    from ekaid_torch.utils.dtypes import F32
    model = load_flax_params(EkaidModel(cfg, d["ntoken"], policy=F32,
                                        device="cpu", seed=None, mesh=grid),
                             d["tree"])
    state = init_state(model, cfg.train.optim)
    ddp = mesh.wrap(Forward(model), grid)
    part = {k: v[grid.rank::grid.data] for k, v in d["batch"].items()}
    m = train_step(state, part, 0, ATT_REG, train=False, ddp=ddp,
                   accum_steps=cfg.train.accum_steps)
    return state, _results(state, m)


def snapshot(d, state, grid) -> dict:
    from ekaid_torch.utils.checkpoint import CheckpointManager
    if grid.rank == 0:
        CheckpointManager(d["snapshot_dir"]).save(state,
                                                  name=d["snapshot_out"])
    out = state.model.decode(d["batch"])
    return {"decode": {k: out[k] for k in DECODED}}


def axis(d, model, grid) -> dict:
    from ekaid_torch.config import MeshConfig
    from ekaid_torch.parallel import mesh
    auto = mesh.make_mesh(MeshConfig(data=-1), "cpu")
    out = {"auto": (auto.rank, auto.data)}
    try:
        mesh.make_mesh(MeshConfig(data=2 * grid.data), "cpu")
    except ValueError as e:
        out["other_size"] = str(e)
    try:
        model.decode({k: v[:grid.data + 1] for k, v in d["batch"].items()})
    except ValueError as e:
        out["undivided"] = str(e)
    return out


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
            "decode": {k: out[k] for k in DECODED}}


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
        res = {"grid": (grid.rank, grid.data)}
        if "step" in d["tasks"]:
            state, res["step"] = step(d, cfg, grid)
            if "snapshot" in d["tasks"]:
                res["snapshot"] = snapshot(d, state, grid)
            if "axis" in d["tasks"]:
                res["axis"] = axis(d, state.model, grid)
        if "eval" in d["tasks"]:
            res["eval"] = evaluate(d, cfg, grid)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init_file, inputs, out = sys.argv[1:6]
    main(int(r), int(w), init_file, inputs, out)
