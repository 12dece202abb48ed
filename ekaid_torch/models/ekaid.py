"""Full difference-VQA model: ChangeDetector + DynamicSpeaker (counterpart
of `ekaid_tpu/models/ekaid.py`), or, where the config's `decoder` is
'lm', ChangeDetector + the DeepSeek-V2 answer decoder
(`models/lm_decoder.py`; eval only: its greedy decode, no training, no
beam search and no multinomial decode).

A batch is a dict of padded arrays (numpy or torch):

  d_feats / q_feats   [B, N, F]   main/reference node features (mode0:
                                  [B, H, W] images, and no adjacency
                                  or boxes)
  d_adj / q_adj       [B, P, P]   spatial adjacency labels 0..11
  d_sem_adj / ...     [B, P, P]   semantic adjacency labels 0..2
  d_bb / q_bb         [B, N, 4]   boxes
  question            [B, Lq]     question tokens
  labels              [B, T+1]    <start> + answer tokens (training)
  masks               [B, T+1]    1 over tokens + the EOS slot (training)

`forward` is the training path: the encoder with gradients, then
teacher forcing; the losses below turn its outputs into the training
objective. `encode`, the greedy `decode` and the beam-search
`decode_beam` run without gradients.

On a CUDA device, an encode without gradients and without dropout
replays a CUDA graph of the encoder, one per input signature
(`EncodeGraphs`): the same kernels in the same order, launched by the
host as one graph in place of ~1,500-2,250 operations. Training and
the CPU run it eagerly.

On a mesh (`parallel/mesh.py`), every rank holds the whole model, and
a greedy decode splits its rows over the data axis (the reference's
`decode_mesh`): each rank decodes its contiguous block, through K1 on
the card, and the blocks are gathered back in row order.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ekaid_torch.models.change_detector import ChangeDetector
from ekaid_torch.models.decoder import DynamicSpeaker, greedy_path
from ekaid_torch.models.detector.backbone import GroupNorm
from ekaid_torch.models.layers import init_params
from ekaid_torch.models.lm_decoder import LMDecoder
from ekaid_torch.ops.graph import broadcast_adjacency
from ekaid_torch.parallel.mesh import gather
from ekaid_torch.utils.device import resolve_device
from ekaid_torch.utils.dtypes import F32, Policy, lm_param_dtype
from ekaid_torch.utils.observability import count, span

_INPUTS = ("d_feats", "q_feats", "d_adj", "q_adj", "d_sem_adj", "q_sem_adj",
           "d_bb", "q_bb", "question")
#: the pixels-in mode0 batch: the image pair and the question
_MODE0_INPUTS = ("d_feats", "q_feats", "question")
_TRAIN = ("labels", "masks")
#: input signatures whose encode `EncodeGraphs` keeps (least recently
#: used out): the eval loop uses one, the server its bucket and batch 1
GRAPH_SIGNATURES = 4
#: the device types on which an eval encode is captured and replayed
GRAPH_DEVICES = ("cuda",)


def _state_key(module: nn.Module, params: list, host: list) -> None:
    """Appends to `params` the (identity, storage address, dtype) of
    every parameter and buffer of `module`, and to `host` every module's
    `cfg` (the host-side settings that choose the operations an encode
    runs, such as `pair_batch`), walked over the modules' own tables (a
    few times faster than `parameters()`, which the encode would pay per
    batch)."""
    for t in (*module._parameters.values(), *module._buffers.values()):
        if t is not None:
            params.append((id(t), t.data_ptr(), t.dtype))
    cfg = module.__dict__.get("cfg")
    if cfg is not None:
        host.append(cfg)
    for child in module._modules.values():
        _state_key(child, params, host)


class _Graph:
    """One captured encode: the input buffers it reads, the graph, and
    the output buffers its replay writes."""

    def __init__(self, encode, b: Dict[str, torch.Tensor]):
        self.device = next(iter(b.values())).device
        self.inputs = {k: v.clone() for k, v in b.items()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            # other threads (a loader, a server's) may use the device
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = encode(self.inputs)

    def replay(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.cuda.device(self.device):
            for k, v in b.items():
                self.inputs[k].copy_(v)
            self.graph.replay()
            # fresh tensors: the next replay overwrites the buffers
            return {k: v.clone() for k, v in self.outputs.items()}


class EncodeGraphs:
    """An encode replayed as a CUDA graph per signature: the settings of
    the modules it runs (each one's `cfg`, by value) and each input's
    name, shape, dtype and device. The last `GRAPH_SIGNATURES`
    signatures are kept, least recently used out.

    A signature runs eagerly at its first sight, the run that settles
    the libraries' choices of algorithm and workspace; it is captured at
    its second and replayed from then on: its inputs copied into the
    graph's buffers, its outputs cloned out of them, so that no two
    calls return the same storage. A `cfg` swapped for another (a
    `pair_batch` turned on) is another signature, so a graph never
    replays operations the settings no longer choose. A graph reads the
    parameters at the addresses they had when it was captured, so every
    graph is dropped when a parameter's identity, storage or dtype
    changes (`cast_params_for_inference`, a load that replaces `p.data`,
    a move to another device); an update in place (an optimizer's step)
    keeps them, and the next replay reads the new values. A copy starts
    with no graph."""

    def __init__(self):
        #: signature -> None (seen once) or its `_Graph`, oldest first
        self._known: "OrderedDict[tuple, Optional[_Graph]]" = OrderedDict()
        self._params: Optional[list] = None

    def __deepcopy__(self, memo):
        return EncodeGraphs()

    def __call__(self, encode, b: Dict[str, torch.Tensor],
                 module: nn.Module) -> Tuple[Dict[str, torch.Tensor], bool]:
        """(encode(b)'s outputs, whether they came from a replay);
        `module` holds the parameters and settings the encode reads."""
        params, host = [], []
        _state_key(module, params, host)
        if params != self._params:
            self._known.clear()
            self._params = params
        sig = (tuple(host),
               tuple((k, v.shape, v.dtype, v.device) for k, v in b.items()))
        if sig not in self._known:
            self._known[sig] = None
            while len(self._known) > GRAPH_SIGNATURES:
                self._known.popitem(last=False)
            return encode(b), False
        self._known.move_to_end(sig)
        graph = self._known[sig]
        if graph is None:
            graph = self._known[sig] = _Graph(encode, b)
        return graph.replay(b), True


class EkaidModel(nn.Module):
    """`device` defaults to CUDA and raises without a card unless the
    caller asks for 'cpu'. Parameters are drawn from `seed`; load trained
    or reference weights with `ekaid_torch.convert.load_flax_params`.
    The LM decoder (`lm`, with `speaker` None) is built on the device in
    its parameters' dtype (`lm_param_dtype`), left unwritten where
    `seed` is None."""

    def __init__(self, cfg, ntoken: int, policy: Policy = F32,
                 device="cuda", seed: Optional[int] = 0, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        lm = cfg.decoder == "lm"
        self.change_detector = ChangeDetector(
            cfg.change_detector, feature_dim=cfg.data.feature_dim,
            speaker_embed_dim=cfg.speaker.embed_dim, ntoken=ntoken,
            graph=cfg.train.graph, setting=cfg.train.setting,
            question_att=cfg.question.att_mode, policy=policy,
            return_nodes=lm)
        self.speaker = None if lm else DynamicSpeaker(cfg.speaker, policy)
        self.lm = None
        if lm:
            # no f32 copy of the LM on any device: built on meta, cast,
            # then given memory on the device
            with torch.device("meta"):
                shape = LMDecoder(cfg)
            self.lm = shape.to(lm_param_dtype(policy)).to_empty(device=dev)
        if seed is not None:
            init_params(self, torch.Generator().manual_seed(seed))
        #: the `parallel.mesh.Mesh` this model is placed on, or None
        self.mesh = mesh
        self.graphs = EncodeGraphs()
        #: the device whose `decode_kernels` are loaded
        self._kernels_on: Optional[torch.device] = None
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.change_detector.img.kernel.device

    def tensors(self, batch, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        """The model inputs of `batch` (with labels and masks when
        `train`) as tensors on the model's device."""
        keys = (_MODE0_INPUTS if self.cfg.train.setting == "mode0"
                else _INPUTS) + (_TRAIN if train else ())
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in keys}

    def _adjacencies(self, b):
        c = self.cfg.change_detector
        n = b["d_feats"].shape[1]
        dt = self.policy.compute_dtype
        return (broadcast_adjacency(b["d_adj"], c.spa_label_num, n, dt),
                broadcast_adjacency(b["q_adj"], c.spa_label_num, n, dt),
                broadcast_adjacency(b["d_sem_adj"], c.sem_label_num, n, dt),
                broadcast_adjacency(b["q_sem_adj"], c.sem_label_num, n, dt))

    def decode_kernels(self) -> Tuple[str, ...]:
        """The kernels a greedy decode launches on this model's device:
        on CUDA, K5 where a GroupNorm of the trunk may take it
        (`GroupNorm.takes_kernel`) and K1 where `greedy_path` says
        'kernel' (never with the LM decoder)."""
        if self.device.type != "cuda":
            return ()
        names = []
        if any(isinstance(m, GroupNorm) and m.takes_kernel
               for m in self.modules()):
            names.append("group_norm")
        if self.speaker is not None and \
                greedy_path(self.cfg.speaker, self.device) == "kernel":
            names.append("greedy_decode")
        return tuple(names)

    def graphs_apply(self, gen=None) -> bool:
        """Whether an encode without gradients replays a CUDA graph: on
        a CUDA device and without dropout (`gen` None)."""
        return self.device.type in GRAPH_DEVICES and gen is None

    def _encode(self, b, gen=None) -> Dict[str, torch.Tensor]:
        """The encoder over the batch's tensors `b`, replayed from
        `graphs` where `graphs_apply`. Each encode without gradients
        adds 1 to `ekaid.encode.graph` or to `ekaid.encode.eager`, and 0
        to the other."""
        if torch.is_grad_enabled():
            return self._encoder(b, gen)
        if self.graphs_apply(gen):
            enc, graphed = self.graphs(self._encoder, b, self.change_detector)
        else:
            enc, graphed = self._encoder(b, gen), False
        count("ekaid.encode.graph", int(graphed))
        count("ekaid.encode.eager", int(not graphed))
        return enc

    def _encoder(self, b, gen=None) -> Dict[str, torch.Tensor]:
        if self.cfg.train.setting == "mode0":
            return self.change_detector(
                b["d_feats"], b["q_feats"], None, None, None, None, None,
                None, b["question"], gen)
        d_adj, q_adj, d_sem, q_sem = self._adjacencies(b)
        return self.change_detector(
            b["d_feats"], b["q_feats"], d_adj, q_adj, d_sem, q_sem,
            b["d_bb"], b["q_bb"], b["question"], gen)

    @torch.no_grad()
    def encode(self, batch) -> Dict[str, torch.Tensor]:
        return self._encode(self.tensors(batch))

    def forward(self, batch, ss_prob: float = 0.0,
                gen: Optional[torch.Generator] = None,
                ss_gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Training path with gradients: the encoder's outputs plus the
        teacher-forced logprobs [B, T, V], pos_logprobs and
        module_weights [B, T, 3]. gen: dropout draws (None: no dropout);
        ss_gen: scheduled sampling draws (see `teacher_forcing`)."""
        self._refuse_lm("training")
        b = self.tensors(batch, train=True)
        enc = self._encode(b, gen)
        dec = self.speaker.teacher_forcing(
            enc["feat_bef"], enc["feat_aft"], enc["feat_diff"], b["labels"],
            ss_prob=ss_prob, gen=gen, ss_gen=ss_gen)
        return {**enc, **dec}

    @torch.no_grad()
    def decode(self, batch, sample_max: bool = True,
               temperature: Optional[float] = None,
               gumbel: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None,
               early_exit: bool = True) -> Dict[str, torch.Tensor]:
        """Eval/inference path: the encoder's outputs plus seq, logprobs
        and module_weights of `DynamicSpeaker.sample` (greedy by
        default, through the kernel K1 or, with speaker.decode_kernel
        'xla', the torch step loop; sample_max=False draws
        multinomially in the loop, with the draws from gumbel or
        gen). On a mesh with a data axis over 1, a greedy decode runs on
        this rank's block of rows and returns the whole batch's
        (`_rows_of_this_rank`): every rank must call it together.
        With the LM decoder: seq and logprobs of its greedy decode
        (`LMDecoder.generate`) beside the encoder's outputs."""
        if not sample_max:
            self._refuse_lm("a multinomial decode")
        if self._kernels_on != self.device:
            # the first decode on a device builds all it launches at once
            from ekaid_torch import kernels
            kernels.load_all(self.decode_kernels())
            self._kernels_on = self.device
        mesh = self.mesh
        split = sample_max and mesh is not None and mesh.data > 1
        b = self.tensors(batch)
        if split:
            b = self._rows_of_this_rank(b)
        with span("ekaid.decode.encode"):
            enc = self._encode(b)
        with span("ekaid.decode.sample"):
            if self.lm is not None:
                dec = self.lm.generate(enc, b["question"],
                                       early_exit=early_exit)
            else:
                dec = self.speaker.sample(
                    enc["feat_bef"], enc["feat_aft"], enc["feat_diff"],
                    sample_max=sample_max, temperature=temperature,
                    gumbel=gumbel, gen=gen, early_exit=early_exit)
        out = {**enc, **dec}
        if split:
            out = {k: gather(v, 0) for k, v in out.items()}
        return out

    def _refuse_lm(self, what: str) -> None:
        if self.lm is not None:
            raise NotImplementedError(
                f"{what} is refused with the LM decoder (decoder 'lm'): "
                "it runs its greedy eval decode only")

    def _rows_of_this_rank(self, b) -> Dict[str, torch.Tensor]:
        """This rank's contiguous block of the batch's rows, as P('data')
        places them; a batch that the data axis does not divide
        raises."""
        n, parts = b["question"].shape[0], self.mesh.data
        if n % parts:
            raise ValueError(f"decode batch {n} does not split over the "
                             f"{parts} ranks of the data axis")
        k = n // parts
        return {key: v[self.mesh.rank * k:(self.mesh.rank + 1) * k]
                for key, v in b.items()}

    @torch.no_grad()
    def decode_beam(self, batch, beam_size: int = 3,
                    group_size: Optional[int] = None,
                    diversity_lambda: Optional[float] = None
                    ) -> Dict[str, torch.Tensor]:
        """Beam-search eval path: the encoder's outputs plus
        `DynamicSpeaker.sample_beam`'s (group_size > 1: diverse
        groups)."""
        self._refuse_lm("beam search")
        enc = self.encode(batch)
        dec = self.speaker.sample_beam(
            enc["feat_bef"], enc["feat_aft"], enc["feat_diff"],
            beam_size=beam_size, group_size=group_size,
            diversity_lambda=diversity_lambda)
        return {**enc, **dec}


def language_model_loss(logprobs, targets, masks, denom=None):
    """Masked NLL: -sum(logp[target] * mask) / sum(mask). logprobs
    [B, T, V]; targets and masks [B, >=T], cut to T. denom replaces the
    mask sum (gradient accumulation passes the whole batch's, so the
    microbatch losses sum to the batch loss)."""
    T = logprobs.shape[1]
    targets = targets[:, :T].long()
    masks = masks[:, :T].to(logprobs.dtype)
    picked = torch.gather(logprobs, -1, targets[..., None])[..., 0]
    if denom is None:
        denom = torch.clamp(masks.sum(), min=1.0)
    return -(picked * masks).sum() / denom


def attention_regularizer(att_bef, att_aft, batch=None):
    """(sum(att_bef) + sum(att_aft)) / (2 * batch); batch defaults to
    att_bef's leading size (accumulation passes the whole batch's)."""
    b = att_bef.shape[0] if batch is None else batch
    return (att_bef.float().sum() + att_aft.float().sum()) / (2.0 * b)


def entropy_loss(module_weights, masks, batch=None):
    """Module-attention entropy: -sum(w log w * mask) / batch, with
    module_weights [B, T, 3] and masks [B, >=T]."""
    t = module_weights.shape[1]
    m = masks[:, :t].float()
    w = module_weights.float()
    b = w * torch.log(torch.clamp(w, min=1e-12))
    denom = module_weights.shape[0] if batch is None else batch
    return -(b * m[..., None]).sum() / denom


def reward_loss(logprobs_taken, seq, reward):
    """Policy-gradient loss: -sum(logp * reward * mask) / sum(mask), the
    mask covering each row up to and including its first 0."""
    mask = (seq > 0).float()
    mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]], dim=1)
    out = -logprobs_taken * reward * mask
    return out.sum() / torch.clamp(mask.sum(), min=1.0)


def total_loss(outputs, batch, att_reg_weight: float = 2.5e-3,
               entropy_weight: float = 0.0, lang_denom=None,
               batch_denom=None):
    """NLL over labels[:, 1:] + att_reg_weight * the attention term,
    minus entropy_weight * the module-attention entropy when that weight
    is set. Returns (loss, aux) with aux speaker_loss, att_reg and, with
    an entropy weight, entropy. lang_denom / batch_denom: the whole
    batch's normalisers, for gradient accumulation."""
    lang = language_model_loss(outputs["logprobs"], batch["labels"][:, 1:],
                               batch["masks"][:, 1:], denom=lang_denom)
    att = attention_regularizer(outputs["att_bef"], outputs["att_aft"],
                                batch=batch_denom)
    loss = lang + att_reg_weight * att
    aux = {"speaker_loss": lang, "att_reg": att}
    if entropy_weight:
        ent = entropy_loss(outputs["module_weights"],
                           batch["masks"][:, 1:], batch=batch_denom)
        loss = loss - entropy_weight * ent
        aux["entropy"] = ent
    return loss, aux
