"""Convert the reference's torch checkpoints into the port's state dicts
(counterpart of `ekaid_tpu/tools/torch_convert.py`).

Two kinds:
  * `--kind model`: the VQA checkpoint the reference trains
    ({change_detector_state, speaker_state, model_cfg}) ->
    `{"step": 0, "params": EkaidModel state dict}`. Put it in a
    snapshots directory as `<name>.pt`; `utils/checkpoint.py::
    CheckpointManager.restore` loads it, and through it `train/test.py
    -p`, `serving/server.py --checkpoint_dir` and `viz/ask.py
    --checkpoint_dir`. The file holds no optimizer state: a params-only
    file leaves the `TrainState`'s optimizer as the trainer built it
    (empty slots, update count 0, so the learning-rate schedule starts
    over), which is all inference reads.
  * `--kind detector`: a Detectron2 R50-FPN `.pth` (a raw state dict or
    DetectionCheckpointer's {'model': ...}) -> the `FasterRCNN` state
    dict that `train/train_detector.py --ckpt_out` writes, which
    `--init_ckpt`, `--ana_ckpt` and `--dis_ckpt` read. Build the model
    it loads into with `norm='frozen_bn', stride_in_1x1=True`
    (Detectron2's caffe R50 strides the 1x1 conv and carries frozen BN
    affines; the CLIs take `--norm frozen_bn --stride_in_1x1`), and feed
    it `detectron2_preprocess`'s input (`--preprocess detectron2`).

Layouts. The port's parameters carry the reference package's names, so
each torch tensor maps to one port key:
  * Linear weight [out, in] -> Dense kernel [in, out] (transposed);
  * weight-norm Linears: weight_g (one scalar) -> g, weight_v -> v
    transposed;
  * LSTMCell weight_ih/hh [4H, in] -> w_ih/w_hh transposed, with
    b = b_ih + b_hh, gates (i, f, g, o) as in `ekaid_torch/convert.py`;
  * GRU weight_ih_l0/hh_l0 [3H, in] -> w_ih/w_hh transposed and
    b_ih/b_hh, gates (r, z, n);
  * conv weights stay OIHW; embeddings copy as they are;
  * FrozenBatchNorm2d -> {scale, bias}, folded in f64 and then cast to
    f32, in the reference's order, so the result is bit-equal to it;
  * box_head.fc1, after the 7x7 pool: Detectron2 flattens [C, H, W] and
    the port's `BoxHead` flattens [H, W, C], so its input axis is
    permuted.

The FCNet weight-norm Linears sit at the even Sequential slots when the
net has dropout, so they are found by key. A relation encoder is
implicit or explicit by which keys it has. The GAT's direction-0
attention is mapped too, though the reference's executed path never
runs it; a model built with `dir_reduce='reference'` has no parameters
for it, and `load_params` drops those entries alone.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _linear(sd, src: str, dst: str, out: Dict) -> None:
    out[f"{dst}.kernel"] = _t(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = np.asarray(sd[f"{src}.bias"])


def _wn_linear(sd, src: str, dst: str, out: Dict) -> None:
    out[f"{dst}.v"] = _t(sd[f"{src}.weight_v"])
    out[f"{dst}.g"] = np.asarray(sd[f"{src}.weight_g"]).reshape(())
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = np.asarray(sd[f"{src}.bias"])


def _fcnet(sd, src: str, dst: str, out: Dict) -> None:
    li = 0
    for slot in range(8):
        if f"{src}.main.{slot}.weight_v" in sd:
            _wn_linear(sd, f"{src}.main.{slot}", f"{dst}.WNDense_{li}", out)
            li += 1
    if not li:
        raise KeyError(f"no weight-norm linears under {src}")


def _lstm_cell(sd, src: str, dst: str, out: Dict) -> None:
    out[f"{dst}.w_ih"] = _t(sd[f"{src}.weight_ih"])
    out[f"{dst}.w_hh"] = _t(sd[f"{src}.weight_hh"])
    out[f"{dst}.b"] = (np.asarray(sd[f"{src}.bias_ih"])
                       + np.asarray(sd[f"{src}.bias_hh"]))


def _gru(sd, src: str, dst: str, out: Dict) -> None:
    out[f"{dst}.w_ih"] = _t(sd[f"{src}.weight_ih_l0"])
    out[f"{dst}.w_hh"] = _t(sd[f"{src}.weight_hh_l0"])
    out[f"{dst}.b_ih"] = np.asarray(sd[f"{src}.bias_ih_l0"])
    out[f"{dst}.b_hh"] = np.asarray(sd[f"{src}.bias_hh_l0"])


def _gat(sd, src: str, dst: str, out: Dict) -> None:
    _fcnet(sd, f"{src}.self_weights", f"{dst}.self_weights", out)
    _fcnet(sd, f"{src}.bias", f"{dst}.bias", out)
    for d in (0, 1):
        s, t = f"{src}.neighbor_net.{d}", f"{dst}.neighbor_net_{d}"
        _fcnet(sd, f"{s}.query", f"{t}.query", out)
        _fcnet(sd, f"{s}.key", f"{t}.key", out)
        _linear(sd, f"{s}.linear_out_2", f"{t}.linear_out_2", out)
        if (f"{s}.pair_pos_fc1.main.1.weight_v" in sd
                or f"{s}.pair_pos_fc1.main.0.weight_v" in sd):
            _fcnet(sd, f"{s}.pair_pos_fc1", f"{t}.pair_pos_fc1", out)


def convert_change_detector(sd, prefix: str = "change_detector"
                            ) -> Dict[str, np.ndarray]:
    """change_detector_state -> the port's `ChangeDetector` keys under
    `prefix`."""
    out: Dict[str, np.ndarray] = {}
    for name, src in (("img", "img"), ("context1", "context1"),
                      ("context2", "context2"), ("gate1", "gate1"),
                      ("gate2", "gate2"), ("embed", "embed.0"),
                      ("att", "att"), ("fc1", "fc1")):
        _linear(sd, src, f"{prefix}.{name}", out)
    q = f"{prefix}.question"
    out[f"{q}.WordEmbedding_0.emb"] = np.asarray(sd["w_emb.emb.weight"])
    out[f"{q}.WordEmbedding_0.emb_fixed"] = np.asarray(
        sd["w_emb.emb_.weight"])
    _gru(sd, "q_emb.rnn", f"{q}.GRU_0", out)
    _fcnet(sd, "q_att.W1_self_att_q",
           f"{q}.QuestionSelfAttention_0.FCNet_0", out)
    _fcnet(sd, "q_att.W2_self_att_q",
           f"{q}.QuestionSelfAttention_0.FCNet_1", out)
    for name in ("semantic_relation", "spatial_relation", "imp_relation"):
        if any(k.startswith(name + ".") for k in sd):
            kind = ("implicit_relation"
                    if f"{name}.implicit_relation.self_weights.main.1."
                       "weight_v" in sd else "explicit_relation")
            _gat(sd, f"{name}.{kind}", f"{prefix}.{name}.gat", out)
    return out


def convert_speaker(sd, prefix: str = "speaker") -> Dict[str, np.ndarray]:
    """speaker_state -> the port's `DynamicSpeaker` keys under `prefix`."""
    out = {f"{prefix}.word_emb": np.asarray(sd["embed.0.weight"])}
    _linear(sd, "core.embed.0", f"{prefix}.embed", out)
    _linear(sd, "logit", f"{prefix}.logit", out)
    c = f"{prefix}.core"
    _lstm_cell(sd, "core.module_att_lstm", f"{c}.module_att_lstm", out)
    _lstm_cell(sd, "core.lang_lstm", f"{c}.lang_lstm", out)
    for name, src in (("weight_fc", "core.weight_fc.0"),
                      ("pos1", "core.pos1.0"),
                      ("weight_pos", "core.weight_pos"),
                      ("pos2", "core.pos2"), ("gate1x", "core.gate1x.0"),
                      ("gate2x", "core.gate2x")):
        _linear(sd, src, f"{c}.{name}", out)
    return out


# ---------------------------------------------------------------------
# Detectron2 R50-FPN (GeneralizedRCNN key layout)
# ---------------------------------------------------------------------

_D2_BN_EPS = 1e-5          # detectron2 FrozenBatchNorm2d eps
_D2_DEPTHS = (3, 4, 6, 3)  # R50


def _conv(sd, src: str, dst: str, out: Dict) -> None:
    out[f"{dst}.kernel"] = np.asarray(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = np.asarray(sd[f"{src}.bias"])


def _frozen_bn(sd, src: str, dst: str, out: Dict) -> None:
    """y = x * w / sqrt(var + eps) + (b - mean * w / sqrt(var + eps))."""
    w = np.asarray(sd[f"{src}.norm.weight"], np.float64)
    b = np.asarray(sd[f"{src}.norm.bias"], np.float64)
    mean = np.asarray(sd[f"{src}.norm.running_mean"], np.float64)
    var = np.asarray(sd[f"{src}.norm.running_var"], np.float64)
    scale = w / np.sqrt(var + _D2_BN_EPS)
    out[f"{dst}.scale"] = scale.astype(np.float32)
    out[f"{dst}.bias"] = (b - mean * scale).astype(np.float32)


def _fc_after_pool(sd, src: str, dst: str, out: Dict, pool: int,
                   channels: int) -> None:
    w = np.asarray(sd[f"{src}.weight"])                # [out, C*H*W]
    out_dim = w.shape[0]
    w = w.reshape(out_dim, channels, pool, pool)
    w = np.transpose(w, (2, 3, 1, 0)).reshape(pool * pool * channels,
                                              out_dim)
    out[f"{dst}.kernel"] = np.ascontiguousarray(w)
    out[f"{dst}.bias"] = np.asarray(sd[f"{src}.bias"])


def convert_detectron2_rcnn(sd, pool: int = 7, channels: int = 256
                            ) -> Dict[str, np.ndarray]:
    """Detectron2 GeneralizedRCNN state dict -> `FasterRCNN(...,
    norm='frozen_bn', stride_in_1x1=True)` keys."""
    out: Dict[str, np.ndarray] = {}
    bu, rn = "backbone.bottom_up", "backbone.resnet"
    _conv(sd, f"{bu}.stem.conv1", f"{rn}.stem_conv", out)
    _frozen_bn(sd, f"{bu}.stem.conv1", f"{rn}.stem_norm", out)
    for stage, depth in enumerate(_D2_DEPTHS):
        for block in range(depth):
            src = f"{bu}.res{stage + 2}.{block}"
            dst = f"{rn}.c{stage + 2}_b{block}"
            for i in (1, 2, 3):
                _conv(sd, f"{src}.conv{i}", f"{dst}.conv{i}", out)
                _frozen_bn(sd, f"{src}.conv{i}", f"{dst}.norm{i}", out)
            if f"{src}.shortcut.weight" in sd:
                _conv(sd, f"{src}.shortcut", f"{dst}.conv_sc", out)
                _frozen_bn(sd, f"{src}.shortcut", f"{dst}.norm_sc", out)
    for lvl in (2, 3, 4, 5):
        _conv(sd, f"backbone.fpn_lateral{lvl}", f"backbone.lateral{lvl}",
              out)
        _conv(sd, f"backbone.fpn_output{lvl}", f"backbone.out{lvl}", out)
    rp = "proposal_generator.rpn_head"
    _conv(sd, f"{rp}.conv", "rpn.conv", out)
    _conv(sd, f"{rp}.objectness_logits", "rpn.objectness", out)
    _conv(sd, f"{rp}.anchor_deltas", "rpn.deltas", out)
    _fc_after_pool(sd, "roi_heads.box_head.fc1", "box_head.fc1", out, pool,
                   channels)
    _linear(sd, "roi_heads.box_head.fc2", "box_head.fc2", out)
    _linear(sd, "roi_heads.box_predictor.cls_score", "box_head.cls_score",
            out)
    _linear(sd, "roi_heads.box_predictor.bbox_pred", "box_head.bbox_pred",
            out)
    return out


def detectron2_preprocess(images_rgb01: np.ndarray,
                          pixel_mean=(103.530, 116.280, 123.675),
                          pixel_std=(1.0, 1.0, 1.0)) -> np.ndarray:
    """[B, H, W, 3] RGB in [0, 1] -> caffe BGR, 0-255, mean-subtracted
    and divided by std: the reference predictor's input. The defaults
    are the zoo R50-FPN's `pixel_mean`/`pixel_std`."""
    bgr = images_rgb01[..., ::-1] * 255.0
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    return ((bgr - mean) / std).astype(np.float32)


def _numpy_dict(sd) -> Dict[str, np.ndarray]:
    return {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
            for k, v in sd.items()}


def _tensors(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def convert_detector_checkpoint(torch_ckpt_path: str) -> Dict:
    """A Detectron2 `.pth` -> {'params': FasterRCNN state dict, 'meta':
    its pixel_mean/pixel_std where the file has them}."""
    ck = torch.load(torch_ckpt_path, map_location="cpu", weights_only=False)
    sd = _numpy_dict(ck.get("model", ck))
    meta = {}
    if "pixel_mean" in sd:
        meta["pixel_mean"] = np.asarray(sd["pixel_mean"]).reshape(-1)
        meta["pixel_std"] = np.asarray(sd["pixel_std"]).reshape(-1)
    return {"params": _tensors(convert_detectron2_rcnn(sd)), "meta": meta}


def convert_checkpoint(torch_ckpt_path: str) -> Dict[str, torch.Tensor]:
    """The reference's VQA `.pt` -> the `EkaidModel` state dict (GAT
    direction 0 included)."""
    ck = torch.load(torch_ckpt_path, map_location="cpu", weights_only=False)
    return _tensors({
        **convert_change_detector(_numpy_dict(ck["change_detector_state"])),
        **convert_speaker(_numpy_dict(ck["speaker_state"]))})


def load_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]
                ) -> torch.nn.Module:
    """Load a converted VQA state dict into `model` strictly, except for
    GAT direction-0 entries that a `dir_reduce='reference'` model has no
    parameters for. Returns model."""
    own = model.state_dict()
    extra = [k for k in params if k not in own]
    unused = [k for k in extra if ".gat.neighbor_net_0." not in k]
    if unused:
        raise KeyError(f"converted parameters the model lacks: {unused}")
    model.load_state_dict({k: v for k, v in params.items() if k in own})
    return model


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint to ekaid_torch")
    p.add_argument("torch_ckpt")
    p.add_argument("out", help="the .pt file to write")
    p.add_argument("--kind", choices=("model", "detector"),
                   default="model",
                   help="'model' = ChangeDetector+speaker .pt; "
                        "'detector' = Detectron2 R50-FPN .pth")
    a = p.parse_args(argv)
    if a.kind == "detector":
        res = convert_detector_checkpoint(a.torch_ckpt)
        sd = res["params"]
        what = f"{len(sd)} detector parameters"
        if res["meta"]:
            what += (f"; pixel_mean {res['meta']['pixel_mean'].tolist()}, "
                     f"pixel_std {res['meta']['pixel_std'].tolist()}")
    else:
        sd = {"step": 0, "params": convert_checkpoint(a.torch_ckpt)}
        what = f"{len(sd['params'])} model parameters, no optimizer state"
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    torch.save(sd, a.out)
    print(f"converted -> {a.out}: {what}")


if __name__ == "__main__":
    main()
