"""ekaid_torch's reference-checkpoint converter (`tools/torch_convert.py`)
against the JAX package's.

The reference's torch checkpoints are built here, with nothing
downloaded: a VQA state dict with the reference's key names and dropout
slots from a flax tree at smoke dims, and the Detectron2 R50-FPN dict of
tests/test_detector_convert.py. Each goes through the port's converter
and through `ekaid_tpu.tools.torch_convert` followed by
`ekaid_torch.convert`; the two port state dicts must be bit-equal. One
decode of the converted VQA model and the converted detector's heads
must match the JAX model's within 1e-5."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port import NTOKEN, init_flax, np_tree, port_cfg, tiny_cfg, \
    to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models.detector.rpn import RPNHead as JaxRPNHead
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.tools import torch_convert as jconv
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.config import default_config
from ekaid_torch.convert import as_torch, flatten
from ekaid_torch.models.detector import FasterRCNN
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.tools import torch_convert as conv
from ekaid_torch.utils.checkpoint import CheckpointManager
from ekaid_torch.utils.orbax_import import load_detector
from test_detector_convert import NUM_CLASSES, make_d2_state

TOL = 1e-5


# ------------------------------------------------- the reference's layout

class RefLayout:
    """A flax EkaidModel tree -> the reference's two torch state dicts
    (numpy): Linear weights [out, in], LSTM/GRU in torch's layout with
    the LSTM bias split into bias_ih + bias_hh, FCNet Linears at their
    Sequential slot (1 behind a dropout, else 0), and random GAT
    direction-0 weights, which the reference's checkpoints carry."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def lin(self, p, dst):
        self.sd[f"{dst}.weight"] = np.ascontiguousarray(p["kernel"].T)
        if "bias" in p:
            self.sd[f"{dst}.bias"] = p["bias"]

    def fcnet(self, p, dst, slot):
        wn = p["WNDense_0"]
        self.sd[f"{dst}.main.{slot}.weight_v"] = np.ascontiguousarray(
            wn["v"].T)
        self.sd[f"{dst}.main.{slot}.weight_g"] = np.asarray(wn["g"])
        if "bias" in wn:
            self.sd[f"{dst}.main.{slot}.bias"] = wn["bias"]

    def lstm(self, p, dst):
        self.sd[f"{dst}.weight_ih"] = np.ascontiguousarray(p["w_ih"].T)
        self.sd[f"{dst}.weight_hh"] = np.ascontiguousarray(p["w_hh"].T)
        half = self.rng.standard_normal(p["b"].shape).astype(np.float32)
        self.sd[f"{dst}.bias_ih"] = half
        self.sd[f"{dst}.bias_hh"] = p["b"] - half

    def gat(self, p, dst):
        self.fcnet(p["self_weights"], f"{dst}.self_weights", 1)
        self.fcnet(p["bias"], f"{dst}.bias", 0)
        net1 = p["neighbor_net_1"]
        net0 = jax.tree.map(lambda a: (self.rng.standard_normal(a.shape)
                                       * 0.1).astype(np.float32), net1)
        for d, net in ((0, net0), (1, net1)):
            n = f"{dst}.neighbor_net.{d}"
            self.fcnet(net["query"], f"{n}.query", 1)
            self.fcnet(net["key"], f"{n}.key", 0)
            self.lin(net["linear_out_2"], f"{n}.linear_out_2")
            if "pair_pos_fc1" in net:
                self.fcnet(net["pair_pos_fc1"], f"{n}.pair_pos_fc1", 1)

    def change_detector(self, p):
        self.sd = {}
        for name in ("img", "context1", "context2", "gate1", "gate2",
                     "att", "fc1"):
            self.lin(p[name], name)
        self.lin(p["embed"], "embed.0")
        q = p["question"]
        self.sd["w_emb.emb.weight"] = q["WordEmbedding_0"]["emb"]
        self.sd["w_emb.emb_.weight"] = q["WordEmbedding_0"]["emb_fixed"]
        g = q["GRU_0"]
        for k, t in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0")):
            self.sd[f"q_emb.rnn.{t}"] = np.ascontiguousarray(g[k].T)
        self.sd["q_emb.rnn.bias_ih_l0"] = g["b_ih"]
        self.sd["q_emb.rnn.bias_hh_l0"] = g["b_hh"]
        att = q["QuestionSelfAttention_0"]
        self.fcnet(att["FCNet_0"], "q_att.W1_self_att_q", 1)
        self.fcnet(att["FCNet_1"], "q_att.W2_self_att_q", 0)
        for name, kind in (("semantic_relation", "explicit_relation"),
                           ("spatial_relation", "explicit_relation"),
                           ("imp_relation", "implicit_relation")):
            self.gat(p[name]["gat"], f"{name}.{kind}")
        return self.sd

    def speaker(self, p):
        self.sd = {"embed.0.weight": p["word_emb"]}
        self.lin(p["embed"], "core.embed.0")
        self.lin(p["logit"], "logit")
        c = p["core"]
        self.lstm(c["module_att_lstm"], "core.module_att_lstm")
        self.lstm(c["lang_lstm"], "core.lang_lstm")
        for name, dst in (("weight_fc", "core.weight_fc.0"),
                          ("pos1", "core.pos1.0"),
                          ("weight_pos", "core.weight_pos"),
                          ("pos2", "core.pos2"), ("gate1x", "core.gate1x.0"),
                          ("gate2x", "core.gate2x")):
            self.lin(c[name], dst)
        return self.sd


def _cfg():
    cfg = tiny_cfg()
    return cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))


@pytest.fixture(scope="module")
def vqa():
    cfg = _cfg()
    batch = synthetic_batch(cfg, 5, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = init_flax(JaxModel(cfg, ntoken=NTOKEN, policy=JF32), jb,
                     train=False)["params"]
    lay = RefLayout()
    return (cfg, batch, jb, lay.change_detector(tree["change_detector"]),
            lay.speaker(tree["speaker"]))


def bit_equal(got, want):
    """Two flat dicts of tensors: the same keys, dtypes, shapes, bits."""
    assert sorted(got) == sorted(want)
    for k in got:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.contiguous().view(-1).view(torch.int32),
                           w.contiguous().view(-1).view(torch.int32)), k


def _via_reference(tree):
    return {k: as_torch(v) for k, v in flatten(tree).items()}


def test_vqa_state_dicts_bit_equal(vqa):
    """The port's converter = the reference's converter + the weight
    bridge, bit for bit, GAT direction 0 included."""
    _, _, _, sd_cd, sd_sp = vqa
    got = conv._tensors({**conv.convert_change_detector(sd_cd),
                         **conv.convert_speaker(sd_sp)})
    want = _via_reference({
        "change_detector": jconv.convert_change_detector(sd_cd),
        "speaker": jconv.convert_speaker(sd_sp)})
    bit_equal(got, want)
    dir0 = [k for k in got if ".neighbor_net_0." in k]
    assert len(dir0) == 3 * 8 + 3       # query, key, out (+ pair_pos)


def test_converted_vqa_model_matches_jax(vqa):
    """The converted weights decode as the JAX model does on the
    reference converter's tree: tokens exact, logprobs, module weights
    and encoder outputs within 1e-5; only direction 0 is left out of a
    dir_reduce='reference' model."""
    cfg, batch, jb, sd_cd, sd_sp = vqa
    params = conv._tensors({**conv.convert_change_detector(sd_cd),
                            **conv.convert_speaker(sd_sp)})
    port = conv.load_params(
        EkaidModel(port_cfg(cfg), NTOKEN, device="cpu", seed=None), params)
    jtree = {"change_detector": jconv.convert_change_detector(sd_cd),
             "speaker": jconv.convert_speaker(sd_sp)}
    for name in ("semantic_relation", "spatial_relation", "imp_relation"):
        del jtree["change_detector"][name]["gat"]["neighbor_net_0"]
    jtree = jax.tree.map(jnp.asarray, {"params": jtree})
    want = JaxModel(cfg, ntoken=NTOKEN, policy=JF32).apply(
        jtree, jb, method="decode", sample_max=True)
    got = port.decode(batch)
    np.testing.assert_array_equal(to_np(got["seq"]), np.asarray(want["seq"]))
    for k in ("logprobs", "module_weights", "feat_bef", "feat_aft",
              "feat_diff", "pred"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                   atol=TOL, rtol=0, err_msg=k)
    bad = dict(params, **{"speaker.extra": torch.zeros(1)})
    with pytest.raises(KeyError, match="speaker.extra"):
        conv.load_params(port, bad)


def test_model_kind_cli_serves_the_eval_driver_and_ask(vqa, tmp_path,
                                                       monkeypatch):
    """`--kind model` writes a params-only `<name>.pt` that the port's
    CheckpointManager restores (the optimizer keeps its fresh state),
    and that `train.test -p` and `viz.ask --checkpoint_dir` load."""
    cfg, _, _, sd_cd, sd_sp = vqa
    ref = tmp_path / "checkpoint_best.pt"
    torch.save({"change_detector_state": {k: torch.from_numpy(np.array(v))
                                          for k, v in sd_cd.items()},
                "speaker_state": {k: torch.from_numpy(np.array(v))
                                  for k, v in sd_sp.items()},
                "model_cfg": {}}, ref)
    snaps = tmp_path / "snaps"
    conv.main([str(ref), str(snaps / "conv.pt"), "--kind", "model"])

    from ekaid_torch.train import test as tst
    from ekaid_torch.train.train import build_synthetic_trainer
    from ekaid_torch.viz import ask
    tr = build_synthetic_trainer(port_cfg(cfg), str(tmp_path / "tr"),
                                 n_pairs=16, device="cpu")
    slots = {k: [t.clone() for t in v] for k, v in tr.state.opt.slots.items()}
    tr.state.step = 7
    CheckpointManager(str(snaps)).restore(tr.state, name="conv")
    assert tr.state.step == 0 and tr.state.opt.count == 0
    for k, v in tr.state.opt.slots.items():
        assert all(torch.equal(a, b) for a, b in zip(v, slots[k]))
    want = conv.convert_checkpoint(str(ref))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k

    monkeypatch.chdir(tmp_path)
    c = cfg.to_dict()
    (tmp_path / "c.yaml").write_text(yaml.safe_dump({k: c[k] for k in (
        "change_detector", "speaker", "data", "question", "dtypes")}))
    common = ["--synthetic", "--device", "cpu", "--cfg",
              str(tmp_path / "c.yaml")]
    tst.main(["-p", str(snaps), "--checkpoint", "conv", "--max_batches",
              "1", "--out", str(tmp_path / "res.json")] + common)
    assert (tmp_path / "res.json").exists()
    res = ask.main(["--checkpoint_dir", str(snaps), "--checkpoint", "conv",
                    "--question", "what", "--n_samples", "4"] + common)
    assert sum(res["counts"].values()) == 4


# ------------------------------------------------------------ Detectron2

@pytest.fixture(scope="module")
def d2():
    return make_d2_state(seed=4)


def test_detector_state_dicts_bit_equal(d2):
    """The frozen-BN fold (f64, then cast), the fc1 input permutation,
    every conv in OIHW: bit-equal to the reference's tree through the
    weight bridge, and loadable strictly into the frozen_bn /
    stride_in_1x1 FasterRCNN."""
    got = conv._tensors(conv.convert_detectron2_rcnn(d2))
    bit_equal(got, _via_reference(jconv.convert_detectron2_rcnn(d2)))
    FasterRCNN(default_config().detector, num_classes=NUM_CLASSES,
               norm="frozen_bn", stride_in_1x1=True).load_state_dict(got)


def test_converted_detector_heads_match_jax(d2):
    """The RPN head on a pyramid level and the box head's layers on
    pooled [R, 7, 7, C] features, against the JAX model's modules on
    the reference converter's tree: within 1e-5 of the largest value."""
    cfg = default_config().detector
    det = FasterRCNN(cfg, num_classes=NUM_CLASSES, norm="frozen_bn",
                     stride_in_1x1=True)
    det.load_state_dict(conv._tensors(conv.convert_detectron2_rcnn(d2)))
    jtree = jconv.convert_detectron2_rcnn(d2)
    rng = np.random.default_rng(5)
    level = rng.standard_normal((1, 16, 16, 256)).astype(np.float32)
    jl, jd = JaxRPNHead(policy=JF32).apply(
        {"params": jax.tree.map(jnp.asarray, jtree["rpn"])},
        [jnp.asarray(level)])
    with torch.no_grad():
        tl, td = det.rpn([torch.from_numpy(level)])
    for got, want in ((tl[0], jl[0]), (td[0], jd[0])):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(got), want, rtol=0,
                                   atol=TOL * np.abs(want).max())

    pooled = rng.standard_normal((6, 7, 7, 256)).astype(np.float32)
    bh = jax.tree.map(jnp.asarray, jtree["box_head"])

    def dense(name, x):
        return fnn.Dense(bh[name]["kernel"].shape[1]).apply(
            {"params": bh[name]}, x)

    x = jax.nn.relu(dense("fc1", jnp.asarray(pooled.reshape(6, -1))))
    feat = jax.nn.relu(dense("fc2", x))
    want = (feat, dense("cls_score", feat), dense("bbox_pred", feat))
    with torch.no_grad():
        got = det.box_head.head(torch.from_numpy(pooled))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(to_np(g), w, rtol=0,
                                   atol=TOL * np.abs(w).max())


def test_detectron2_preprocess_equal():
    x = np.random.default_rng(6).random((2, 9, 7, 3)).astype(np.float32)
    for kw in ({}, {"pixel_mean": (1.0, 2.0, 3.0),
                    "pixel_std": (57.4, 57.1, 58.4)}):
        np.testing.assert_array_equal(conv.detectron2_preprocess(x, **kw),
                                      jconv.detectron2_preprocess(x, **kw))


@pytest.mark.parametrize("wrapped", [True, False])
def test_detector_kind_cli(d2, tmp_path, capsys, wrapped):
    """A `.pth`, raw or under {'model': ...}, with its pixel mean/std ->
    the `.pt` that the runner's and trainer's loaders read."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in d2.items()}
    sd["pixel_mean"] = torch.tensor([103.53, 116.28, 123.675]).view(3, 1, 1)
    sd["pixel_std"] = torch.ones(3, 1, 1)
    pth = tmp_path / "model_final.pth"
    torch.save({"model": sd, "iteration": 9} if wrapped else sd, pth)
    out = tmp_path / "det.pt"
    conv.main([str(pth), str(out), "--kind", "detector"])
    assert "pixel_mean [103.5" in capsys.readouterr().out
    bit_equal(load_detector(str(out)),
              conv._tensors(conv.convert_detectron2_rcnn(d2)))
