"""ResNet-50 + FPN backbone.

Counterpart of `ekaid_tpu/models/detector/backbone.py`: 7x7/2 stem +
3x3/2 maxpool, bottleneck stages [3, 4, 6, 3] with the stride at stage
entry, FPN with `out_channels` laterals over C2..C5 and P6 as a
stride-2 subsample of P5.

Layout: the public functions take and return NHWC tensors ([B, H, W, C],
the reference's layout). Inside, a tensor is the NCHW view of NHWC
memory (`permute(0, 3, 1, 2)`, which is torch's channels-last format),
and every convolution runs channels-last, so the pyramid comes out as
contiguous NHWC. A GroupNorm takes its ReLU and residual add as
arguments (`ops/group_norm.py::epilogue`). Where `kernel_applies` (a
bf16 channels-last CUDA map, no gradient required) it runs the K5
kernel, which writes channels-last; elsewhere the plain chain, whose
`group_norm` returns the NCHW layout, so the next convolution copies
its input back to channels-last. `ResNet.forward` counts the path its
stem's GroupNorm took (`ekaid.gn.kernel` / `ekaid.gn.plain`, one a
call); the trunk's other GroupNorms take the same one, as the rule
reads what a trunk's maps share: device, dtype, layout, gradients.

Parameters keep the reference's names. Conv kernels are OIHW (the
weight bridge transposes flax's HWIO); norms carry `scale`/`bias`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ekaid_torch.ops.group_norm import (epilogue, group_norm_kernel,
                                       group_norm_plain, kernel_applies)
from ekaid_torch.utils.dtypes import F32, Policy
from ekaid_torch.utils.observability import count

GN_GROUPS = 32
GN_EPS = 1e-6              # flax nn.GroupNorm's epsilon (torch's is 1e-5)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> its NCHW (channels-last) view."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels-last) tensor -> its NHWC view."""
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax `nn.Conv` counterpart on NCHW views: kernel [O, I, k, k],
    symmetric padding k // 2 (flax 'SAME' at the sizes used: a 1x1
    stride-2 conv pads nothing), products in the compute dtype. The
    input is made channels-last (a no-op when it is already), so the
    output is too."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 use_bias: bool = True, policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None

    def _reset(self, gen):
        fan_in = self.kernel[0].numel()
        self.kernel.copy_(torch.randn(self.kernel.shape, generator=gen)
                          / fan_in ** 0.5)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        cc = self.policy.cast_compute
        b = None if self.bias is None else cc(self.bias)
        x = cc(x).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, cc(self.kernel), b, stride=self.stride,
                        padding=self.kernel.shape[-1] // 2)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(32)`: statistics and the affine in f32, eps
    1e-6, the result rounded once to the compute dtype; then the
    `epilogue` asked for."""

    def __init__(self, features: int, policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def _reset(self, gen):
        self.scale.fill_(1.0)
        self.bias.zero_()

    @property
    def takes_kernel(self) -> bool:
        """Whether its calls may run the K5 kernel: at a bf16 compute
        dtype (each call on a CUDA map where `kernel_applies`)."""
        return self.policy.compute_dtype == torch.bfloat16

    def uses_kernel(self, x, residual=None) -> bool:
        """Whether a call on x runs the K5 kernel."""
        return self.takes_kernel and \
            kernel_applies(x, self.scale, self.bias, GN_GROUPS, residual)

    def forward(self, x, relu: bool = False, residual=None):
        if self.uses_kernel(x, residual):
            return group_norm_kernel(x, self.scale, self.bias, GN_GROUPS,
                                     GN_EPS, relu, residual)
        return group_norm_plain(x, self.scale, self.bias, GN_GROUPS, GN_EPS,
                                self.policy.compute_dtype, relu, residual)


class FrozenAffine(nn.Module):
    """FrozenBatchNorm equivalent: y = x * scale + bias, in the compute
    dtype; then the `epilogue` asked for."""

    def __init__(self, features: int, policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def _reset(self, gen):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, relu: bool = False, residual=None):
        cc = self.policy.cast_compute
        y = x * cc(self.scale)[:, None, None] + cc(self.bias)[:, None, None]
        return epilogue(y, relu, residual)


def make_norm(kind: str, features: int, policy: Policy) -> nn.Module:
    if kind == "gn":
        return GroupNorm(features, policy)
    if kind == "frozen_bn":
        return FrozenAffine(features, policy)
    raise ValueError(f"unknown norm {kind!r}")


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 norm: str = "gn", stride_in_1x1: bool = False,
                 policy: Policy = F32):
        super().__init__()
        width = out_ch // 4
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        if stride != 1 or in_ch != out_ch:
            self.conv_sc = Conv(in_ch, out_ch, 1, stride, False, policy)
            self.norm_sc = make_norm(norm, out_ch, policy)
        else:
            self.conv_sc = None
        self.conv1 = Conv(in_ch, width, 1, s1, False, policy)
        self.norm1 = make_norm(norm, width, policy)
        self.conv2 = Conv(width, width, 3, s2, False, policy)
        self.norm2 = make_norm(norm, width, policy)
        self.conv3 = Conv(width, out_ch, 1, 1, False, policy)
        self.norm3 = make_norm(norm, out_ch, policy)

    def forward(self, x):
        shortcut = x
        if self.conv_sc is not None:
            shortcut = self.norm_sc(self.conv_sc(x))
        y = self.norm1(self.conv1(x), relu=True)
        y = self.norm2(self.conv2(y), relu=True)
        return self.norm3(self.conv3(y), relu=True, residual=shortcut)


class ResNet(nn.Module):
    """ResNet-50 trunk on NCHW views; returns {c2..c5}.

    The stem is the 7x7/2 conv (padding 3) of the reference's
    [7, 7, C, 64] parameter. The reference's `s2d_stem` computes the
    same conv as a 4x4 conv over a space-to-depth input (a TPU matrix-
    unit rewrite, algebraically identical), so the port ignores it."""

    def __init__(self, in_ch: int = 3,
                 depths: Sequence[int] = (3, 4, 6, 3),
                 channels: Sequence[int] = (256, 512, 1024, 2048),
                 norm: str = "gn", stride_in_1x1: bool = False,
                 policy: Policy = F32):
        super().__init__()
        self.policy = policy
        self.stem_conv = Conv(in_ch, 64, 7, 2, False, policy)
        self.stem_norm = make_norm(norm, 64, policy)
        self.stages = []
        prev = 64
        for stage, (depth, ch) in enumerate(zip(depths, channels)):
            names = []
            for block in range(depth):
                stride = 2 if (block == 0 and stage > 0) else 1
                name = f"c{stage + 2}_b{block}"
                self.add_module(name, Bottleneck(
                    prev, ch, stride, norm, stride_in_1x1, policy))
                names.append(name)
                prev = ch
            self.stages.append(names)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.stem_conv(self.policy.cast_compute(x))
        if isinstance(self.stem_norm, GroupNorm):
            kernel = self.stem_norm.uses_kernel(x)
            count("ekaid.gn.kernel", int(kernel))
            count("ekaid.gn.plain", int(not kernel))
        x = self.stem_norm(x, relu=True)
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = {}
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            feats[f"c{stage + 2}"] = x
        return feats


class ResNetFPN(nn.Module):
    """ResNet + FPN: NHWC images [B, S, S, C] -> {p2..p6} NHWC with
    `out_channels` channels."""

    def __init__(self, out_channels: int = 256, norm: str = "gn",
                 stride_in_1x1: bool = False, policy: Policy = F32,
                 in_ch: int = 3):
        super().__init__()
        self.resnet = ResNet(in_ch, norm=norm, stride_in_1x1=stride_in_1x1,
                             policy=policy)
        for lvl, ch in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
            self.add_module(f"lateral{lvl}",
                            Conv(ch, out_channels, 1, policy=policy))
            self.add_module(f"out{lvl}",
                            Conv(out_channels, out_channels, 3,
                                 policy=policy))

    def forward(self, images) -> Dict[str, torch.Tensor]:
        c = self.resnet(nchw(images))
        lat = {lvl: getattr(self, f"lateral{lvl}")(c[f"c{lvl}"])
               for lvl in (2, 3, 4, 5)}
        # top-down pathway: nearest-neighbour 2x repeat, cropped, + add
        merged = {5: lat[5]}
        for lvl in (4, 3, 2):
            up = merged[lvl + 1].repeat_interleave(2, dim=2)
            up = up.repeat_interleave(2, dim=3)
            h, w = lat[lvl].shape[2:]
            merged[lvl] = lat[lvl] + up[:, :, :h, :w]
        out = {f"p{lvl}": nhwc(getattr(self, f"out{lvl}")(merged[lvl]))
               for lvl in (2, 3, 4, 5)}
        out["p6"] = out["p5"][:, ::2, ::2]
        return out
