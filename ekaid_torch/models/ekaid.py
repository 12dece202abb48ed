"""Full difference-VQA model: ChangeDetector + DynamicSpeaker (counterpart
of `ekaid_tpu/models/ekaid.py`).

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

On a mesh (`parallel/mesh.py`), the parameters that its rules shard
over the model axis hold this rank's block (`parallel/tensor.py`), and
a greedy decode splits its rows over the data axis (the reference's
`decode_mesh`): each rank decodes its contiguous block, through K1 on
the card, and the blocks are gathered back in row order.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ekaid_torch.models.change_detector import ChangeDetector
from ekaid_torch.models.decoder import DynamicSpeaker
from ekaid_torch.models.layers import init_params
from ekaid_torch.ops.graph import broadcast_adjacency
from ekaid_torch.parallel.tensor import gather, shard_parameters
from ekaid_torch.utils.device import resolve_device
from ekaid_torch.utils.dtypes import F32, Policy
from ekaid_torch.utils.observability import span

_INPUTS = ("d_feats", "q_feats", "d_adj", "q_adj", "d_sem_adj", "q_sem_adj",
           "d_bb", "q_bb", "question")
#: the pixels-in mode0 batch: the image pair and the question
_MODE0_INPUTS = ("d_feats", "q_feats", "question")
_TRAIN = ("labels", "masks")


class EkaidModel(nn.Module):
    """`device` defaults to CUDA and raises without a card unless the
    caller asks for 'cpu'. Parameters are drawn from `seed`; load trained
    or reference weights with `ekaid_torch.convert.load_flax_params`."""

    def __init__(self, cfg, ntoken: int, policy: Policy = F32,
                 device="cuda", seed: Optional[int] = 0, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        self.change_detector = ChangeDetector(
            cfg.change_detector, feature_dim=cfg.data.feature_dim,
            speaker_embed_dim=cfg.speaker.embed_dim, ntoken=ntoken,
            graph=cfg.train.graph, setting=cfg.train.setting,
            question_att=cfg.question.att_mode, policy=policy)
        self.speaker = DynamicSpeaker(cfg.speaker, policy)
        if seed is not None:
            init_params(self, torch.Generator().manual_seed(seed))
        #: the `parallel.mesh.Mesh` this model is placed on, or None
        self.mesh = mesh
        if mesh is not None:
            shard_parameters(self, mesh)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.speaker.word_emb.device

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

    def _encode(self, b, gen=None) -> Dict[str, torch.Tensor]:
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
        (`_rows_of_this_rank`): every rank must call it together."""
        mesh = self.mesh
        split = sample_max and mesh is not None and mesh.data > 1
        b = self.tensors(batch)
        if split:
            b = self._rows_of_this_rank(b)
        with span("ekaid.decode.encode"):
            enc = self._encode(b)
        with span("ekaid.decode.sample"):
            dec = self.speaker.sample(
                enc["feat_bef"], enc["feat_aft"], enc["feat_diff"],
                sample_max=sample_max, temperature=temperature,
                gumbel=gumbel, gen=gen, early_exit=early_exit)
        out = {**enc, **dec}
        if split:
            out = {k: gather(v, mesh.data_group, 0) for k, v in out.items()}
        return out

    def _rows_of_this_rank(self, b) -> Dict[str, torch.Tensor]:
        """This rank's contiguous block of the batch's rows, as P('data')
        places them; a batch that the data axis does not divide
        raises."""
        n, parts = b["question"].shape[0], self.mesh.data
        if n % parts:
            raise ValueError(f"decode batch {n} does not split over the "
                             f"{parts} ranks of the data axis")
        k = n // parts
        return {key: v[self.mesh.d * k:(self.mesh.d + 1) * k]
                for key, v in b.items()}

    @torch.no_grad()
    def decode_beam(self, batch, beam_size: int = 3,
                    group_size: Optional[int] = None,
                    diversity_lambda: Optional[float] = None
                    ) -> Dict[str, torch.Tensor]:
        """Beam-search eval path: the encoder's outputs plus
        `DynamicSpeaker.sample_beam`'s (group_size > 1: diverse
        groups)."""
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
