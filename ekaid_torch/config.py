"""Two-tier config: dataclass defaults + strict YAML overlay.

The port's own copy of the reference package's config schema. Field
names and defaults are the same, so `configs/smoke.yaml` and
`configs/mimic.yaml` load unchanged. Unknown YAML keys raise; values are
coerced as the reference does (literal_eval, then type coercion).

`decoder` picks the answer decoder: 'speaker' (the default), the
`DynamicSpeaker` LSTM, or 'lm', the DeepSeek-V2 language model of the
`lm` section (`models/lm_decoder.py`) behind a projector. The `lm`
section takes the keys of the model's published `config.json`, and
refuses settings the port does not implement.

The mesh's `data` is the size of the data-parallel group (-1: the
group's size; `parallel/mesh.py`), and its `model` must be 1: the port
has no tensor-parallel axis, since the model fits one device. Of the
detector section, the TPU schedule knobs (`s2d_stem`, `roi_group`,
`roi_unroll`, `rpn_fused_preds`) are accepted and change nothing, since
each gives the same outputs as its default in the reference;
`rpn_topk='approx'` runs the exact sort, as the reference does off the
TPU.
"""

from __future__ import annotations

import dataclasses
import json
from ast import literal_eval
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import yaml

from ekaid_torch.utils.platform import DECODE_KERNELS


def _frozen(cls):
    cls = dataclass(frozen=True)(cls)
    if not hasattr(cls, "replace"):
        cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


@_frozen
class ChangeDetectorConfig:
    input_dim: int = 2052
    dim: int = 128               # pooled-attention embed dim
    feat_dim: int = 1026
    att_dim: int = 1024          # node feature dim after projection
    att_head: int = 4
    nongt_dim: int = 52          # attention width over the node axis
    spa_label_num: int = 11
    sem_label_num: int = 3
    dir_num: int = 2
    pos_emb_dim: int = 64
    coef_sem: float = 0.333
    coef_spa: float = 0.333
    # 'sequential': the three relation encoders run as cumulative
    # residuals (the reference as executed); 'parallel': independent
    # branches mixed with coef_sem/coef_spa.
    branch_mix: str = "sequential"
    # 'reference': 2x the direction-1 attention only (as executed);
    # 'sum': self + both directions.
    dir_reduce: str = "reference"
    # bef and aft through the encoder stack: 'off', two [B] passes; 'on',
    # one [2B] pass; 'train', the [2B] pass in training only. The legacy
    # True / False (also as the strings a YAML or JSON overlay coerces
    # them to) mean 'on' / 'off'.
    pair_batch: str = "off"

    def __post_init__(self):
        legacy = {True: "on", False: "off", "True": "on", "False": "off"}
        pb = self.pair_batch
        if isinstance(pb, (bool, str)) and pb in legacy:
            object.__setattr__(self, "pair_batch", legacy[pb])
        elif pb not in ("off", "on", "train"):
            raise ValueError(f"change_detector.pair_batch {pb!r}: one of "
                             "'off', 'on', 'train' (or True / False)")


@_frozen
class SpeakerConfig:
    input_dim: int = 1024        # == change_detector.att_dim
    rnn_size: int = 512
    embed_input_dim: int = 3072  # 3 * input_dim (bef, diff, aft)
    embed_dim: int = 1024
    drop_prob_lm: float = 0.5
    word_embed_size: int = 300
    vocab_size: int = 148
    seq_length: int = 90
    pos_classes: int = 16
    decoding_constraint: int = 0  # ban repeating the previous token
    beam_size: int = 1
    group_size: int = 1
    diversity_lambda: float = 0.5
    temperature: float = 1.0
    scan_unroll: int = 1
    # eval-only decode knobs of the torch step loop: merge the step's
    # independent products (fused_core) or store the large core matrices
    # as int8 ('none' | 'int8'; models/quant.py). The greedy kernel
    # refuses both, so they need decode_kernel 'xla'.
    fused_core: bool = False
    weight_quant: str = "none"
    # the greedy decode: 'auto' = 'pallas', the kernel K1 (its plain twin
    # for CPU tensors); 'xla', the torch step loop on either device;
    # 'pallas_interpret', K1's plain twin, CPU tensors only
    # (utils/platform.py::resolve_decode_kernel)
    decode_kernel: str = "auto"
    remat: str = "none"
    train_hoist: bool = False
    # BOS token fed at step 0 of free-running decode (the reference
    # primes with index 2 although '<start>' is 1; kept for parity)
    bos_token: int = 2

    def __post_init__(self):
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"speaker.weight_quant {self.weight_quant!r}: "
                             "'none' or 'int8'")
        if self.decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"speaker.decode_kernel {self.decode_kernel!r}:"
                             f" one of {DECODE_KERNELS}")


@_frozen
class QuestionConfig:
    max_len: int = 20
    word_emb_dim: int = 300      # doubled by the dual embedding
    hidden_dim: int = 1024       # == speaker.embed_dim
    dropout_word: float = 0.0
    dropout_att: float = 0.2
    # 'fixed': per-sample softmax over tokens; 'reference': the
    # reference's transposed-softmax batch scramble, bit for bit
    att_mode: str = "fixed"


@_frozen
class SplitDataConfig:
    batch_size: int = 64
    seq_per_img: int = 1
    max_samples: Optional[int] = None
    empty_image: bool = False


@_frozen
class DataConfig:
    dataset: str = "mimic_diff_vqa"
    num_nodes: int = 52
    node_one_num: int = 26
    feature_dim: int = 1024
    adj_pad: int = 100           # stored adjacency is 100x100
    vocab_json: str = "data/vocab_mimic_VQA.json"
    splits_json: str = "data/splits_mimic_VQA.json"
    h5_label_file: str = "data/VQA_mimic_dataset.h5"
    feature_h5: str = "data/cmb_bbox_di_feats.hdf5"
    gt_captions: str = "data/mimic_gt_captions_%s.json"
    feature_mode: str = "both"
    num_workers: int = -1
    prefetch: int = 2
    eval_wire: str = "compact"
    eval_device_cache: int = 1024
    train: SplitDataConfig = field(default_factory=SplitDataConfig)
    val: SplitDataConfig = field(
        default_factory=lambda: SplitDataConfig(batch_size=64))
    test: SplitDataConfig = field(
        default_factory=lambda: SplitDataConfig(batch_size=64))


@_frozen
class OptimConfig:
    type: str = "adam"
    lr: float = 1e-4
    alpha: float = 0.9
    beta: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    step_size: int = 15
    gamma: float = 0.1
    grad_clip: float = 0.0


@_frozen
class TrainConfig:
    max_iter: int = 40000
    max_epoch: int = 20
    snapshot_interval: int = 2000
    log_interval: int = 50
    scheduled_sampling_start: int = -1
    scheduled_sampling_increase_every: int = 5
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25
    graph: str = "all"           # all | semantic | spatial | implicit | i+s
    setting: str = "mode2"
    att_reg_weight: float = 2.5e-3
    entropy_weight: float = 0.0
    length_buckets: Tuple[int, ...] = ()
    accum_steps: int = 1
    seed: int = 1238
    optim: OptimConfig = field(default_factory=OptimConfig)


@_frozen
class MeshConfig:
    data: int = -1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@_frozen
class DtypeConfig:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    softmax_dtype: str = "float32"
    train_param_cast: bool = False


@_frozen
class DetectorConfig:
    image_size: int = 1024
    num_anatomy_classes: int = 26
    num_disease_classes: int = 22
    fpn_channels: int = 256
    roi_feat_dim: int = 1024
    pre_nms_topk: int = 1000
    post_nms_topk: int = 1000
    extract_topk: int = 0
    select_impl: str = "topk"
    nms_thresh: float = 0.5
    score_thresh: float = 0.0
    proposals_per_image: int = 1000
    roi_pool_size: int = 7
    batch_size: int = 8
    extract_batch_size: int = 8
    norm: str = "gn"
    stride_in_1x1: bool = False
    s2d_stem: bool = True
    preprocess: str = "unit"
    pixel_mean: tuple = (103.530, 116.280, 123.675)
    pixel_std: tuple = (1.0, 1.0, 1.0)
    roi_backend: str = "auto"
    roi_group: int = 8
    roi_unroll: int = 0
    rpn_topk: str = "exact"
    rpn_fused_preds: bool = False


@_frozen
class RopeScalingConfig:
    """YaRN RoPE scaling (the published `rope_scaling` group)."""
    type: str = "yarn"
    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707

    def __post_init__(self):
        if self.type != "yarn":
            raise ValueError(f"lm.rope_scaling.type {self.type!r}: the port "
                             "implements 'yarn'")


@_frozen
class LMConfig:
    """The answer decoder's language model, under the names of its
    published config.json; the defaults are DeepSeek-V2-Lite's
    (huggingface.co/deepseek-ai/DeepSeek-V2-Lite). `seq_aux` and
    `max_position_embeddings` are kept as published and change nothing
    at inference."""
    model_type: str = "deepseek_v2"
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = False
    seq_aux: bool = True
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    hidden_act: str = "silu"
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: RopeScalingConfig = field(
        default_factory=RopeScalingConfig)
    max_position_embeddings: int = 163840
    bos_token_id: int = 100000
    eos_token_id: int = 100001

    def __post_init__(self):
        want = {"model_type": "deepseek_v2", "q_lora_rank": None,
                "scoring_func": "softmax", "topk_method": "greedy",
                "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
                "hidden_act": "silu", "attention_bias": False,
                "tie_word_embeddings": False,
                "num_key_value_heads": self.num_attention_heads}
        for key, value in want.items():
            if getattr(self, key) != value:
                raise ValueError(f"lm.{key} {getattr(self, key)!r}: the port "
                                 f"implements {value!r}")


@_frozen
class Config:
    exp_dir: str = "./experiments"
    exp_name: str = ""
    model_type: str = ""
    change_detector: ChangeDetectorConfig = field(
        default_factory=ChangeDetectorConfig)
    speaker: SpeakerConfig = field(default_factory=SpeakerConfig)
    question: QuestionConfig = field(default_factory=QuestionConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dtypes: DtypeConfig = field(default_factory=DtypeConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    decoder: str = "speaker"
    lm: LMConfig = field(default_factory=LMConfig)

    def __post_init__(self):
        if self.decoder not in ("speaker", "lm"):
            raise ValueError(f"decoder {self.decoder!r}: 'speaker' or 'lm'")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def default_config() -> Config:
    return Config()


def _decode_value(v: Any) -> Any:
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce(value: Any, old: Any, full_key: str) -> Any:
    if old is None or value is None:
        return value
    t_old, t_new = type(old), type(value)
    if t_old is t_new:
        return value
    if isinstance(old, bool) and isinstance(value, int):
        return bool(value)
    if (isinstance(old, bool) and isinstance(value, str)
            and value.lower() in ("true", "false")):
        return value.lower() == "true"
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, str):
        return str(value)
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    raise ValueError(
        f"Type mismatch ({t_old} vs {t_new}) with values ({old} vs {value}) "
        f"for config key: {full_key}")


def _merge_into(obj: Any, overrides: dict, stack: str = "") -> Any:
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot merge into non-dataclass at {stack!r}")
    names = {f.name for f in dataclasses.fields(obj)}
    updates = {}
    for k, v in overrides.items():
        full_key = f"{stack}.{k}" if stack else k
        if k not in names:
            raise KeyError(f"Non-existent config key: {full_key}")
        cur = getattr(obj, k)
        if isinstance(v, dict):
            updates[k] = _merge_into(cur, v, full_key)
        else:
            updates[k] = _coerce(_decode_value(v), cur, full_key)
    return dataclasses.replace(obj, **updates)


def merge_overrides(cfg: Config, overrides: dict) -> Config:
    return _merge_into(cfg, overrides)


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Config:
    """Defaults + optional YAML overlay + dict overrides."""
    cfg = default_config()
    if yaml_path is not None:
        with open(yaml_path) as f:
            loaded = yaml.safe_load(f) or {}
        cfg = merge_overrides(cfg, loaded)
    if overrides:
        cfg = merge_overrides(cfg, overrides)
    return cfg


def merge_from_list(cfg: Config, kv_list) -> Config:
    """Dotted-key overrides from a flat list:
    ['train.optim.lr', '3e-4', ...]."""
    if len(kv_list) % 2:
        raise ValueError("override list must be key/value pairs")
    nested: dict = {}
    for key, val in zip(kv_list[0::2], kv_list[1::2]):
        d = nested
        parts = key.split(".")
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = val
    return merge_overrides(cfg, nested)
