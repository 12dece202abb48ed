"""The trunk's GroupNorm (`ops/group_norm.py`): the K5 kernel, its plain
chain and the rule that picks between them.

On the CPU: the R101's GroupNorm shapes and bytes at 128^2; `plan`'s cut
of every trunk shape (R101 at 128^2, batch 64 and 1; R50-FPN at 1024^2,
batch 8); which shapes the kernel takes; the wrapper's refusals; the
CPU, f32 and gradient-carrying calls on the plain path with the trunk's
numbers as before (a Bottleneck's and a whole trunk's outputs equal to
the unfused code, bit for bit); the `ekaid.gn.*` counters, one per
`ResNet.forward` while a profiler records; `kernels.load` building
its own library and `kernels.load_all` the missing ones in one pool, as
a model's first decode does with the kernels it launches; the model
naming the library for a mode0 model on CUDA, and a serving artifact
that lacks it refused.

On a card (skipped without one): the kernel against the eager chain at
every GroupNorm shape of the R101 at 128^2 (batch 64 and 1) and of the
R50-FPN at 1024^2 (batch 8), with no epilogue, the ReLU, and the
residual add and ReLU, with an f32 and a bf16 affine: at least 99% of
the outputs bit-equal, and none further than one bf16 ulp of the
normalised value (carried through the add: plus one ulp of the sum;
an ulp taken at no less than 2^-8);
two calls and a CUDA graph's replays bit-equal to the eager call; a
bf16 R101 trunk taking the kernel once per GroupNorm, counted, and no
further from its f32 twin than the plain path is. Run there with
`python -m pytest --noconftest tests/test_torch_group_norm.py -q -s`.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from chip_smoke import trunk_gn_shapes
from ekaid_torch import kernels
from ekaid_torch.config import load_config
from ekaid_torch.data.synthetic import synthetic_batch
from ekaid_torch.models.detector.backbone import (GN_EPS, GN_GROUPS,
                                                  Bottleneck, GroupNorm,
                                                  ResNet)
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.ops import group_norm as gn
from ekaid_torch.serving.artifact import Artifact
from ekaid_torch.utils import observability as obs
from ekaid_torch.utils.dtypes import BF16, F32, cast_params_for_inference

R101 = (3, 4, 23, 3)
R50 = (3, 4, 6, 3)
#: (name, images, trunk depths, image size) of the trunks that run GroupNorm
TRUNKS = {"r101-128-b64": (64, R101, 128), "r101-128-b1": (1, R101, 128),
          "r50fpn-1024-b8": (8, R50, 1024)}
H100_SMS = 132


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset_recorded()
    yield
    obs.reset_recorded()


def _shapes(depths, size):
    return sorted({(h, w, c)
                   for h, w, c, _ in trunk_gn_shapes(size, depths)})


# ---- the trunk's shapes, cuts and refusals ---------------------------------

def test_r101_norms_and_bytes_at_128():
    """104 GroupNorms an image over 5,300,224 elements, 2,916,352 of them
    in the residual norms; two trunks of 64 images read and write 3.46 GB
    (the bound's bytes)."""
    norms = trunk_gn_shapes(128, R101)
    assert len(norms) == 104
    assert sum(h * w * c for h, w, c, _ in norms) == 5_300_224
    assert sum(h * w * c for h, w, c, e in norms if e == "residual") \
        == 2_916_352
    assert [e for *_, e in norms].count("none") == 4
    moved = 2 * sum(gn.norm_bytes(64, h * w, c, e == "residual")
                    for h, w, c, e in norms)
    assert moved == 2 * 64 * (5_300_224 * 4 + 2_916_352 * 2)
    assert 3.45e9 < moved < 3.47e9


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_plan_cuts_every_trunk_shape(trunk):
    n, depths, size = TRUNKS[trunk]
    for h, w, c in _shapes(depths, size):
        p = h * w
        pl = gn.plan(n, p, c, GN_GROUPS, H100_SMS)
        width = c // pl.blocks
        vpr = width // 8
        assert GN_GROUPS % pl.blocks == 0 and width % 8 == 0
        assert width % (c // GN_GROUPS) == 0 or (c // GN_GROUPS) % width == 0
        assert width * 2 >= gn.MIN_ROW_BYTES
        assert 1 <= pl.split <= gn.MAX_SPLIT
        assert pl.threads % 32 == 0 and pl.threads % vpr == 0
        assert pl.threads <= gn.THREADS
        gpv = max(1, 8 // (c // GN_GROUPS))
        smem = gn._smem(p, c, pl.blocks, pl.split, pl.threads, gpv,
                        pl.cached)
        tile = -(-p // pl.split) * width * 2
        assert smem == (tile if pl.cached else 0) + pl.threads * gpv * 12
        assert smem <= (gn.CACHE_BYTES if pl.cached else gn.MAX_SMEM)
        blocks = n * pl.blocks * pl.split
        if n == 64:
            # every R101 map at batch 64 is read once, on every SM
            assert pl.cached and blocks >= H100_SMS, (h, w, c, pl)
        if size == 1024 and (h, c) == (512, 64):
            # extraction's stem, 32 MB an image: streamed, over the card
            assert not pl.cached and blocks >= H100_SMS
        if n == 1 and (h, c) == (64, 64):
            assert blocks >= 32, pl           # batch 1 still spreads


def test_supported_shapes():
    for depths, size in ((R101, 128), (R50, 1024)):
        for h, w, c in _shapes(depths, size):
            assert gn.supported(c, GN_GROUPS, h * w)
    assert gn.supported(32, 32, 16)                  # a channel a group
    assert not gn.supported(96, 32, 16)              # 3 channels a group
    assert not gn.supported(128, 64, 16)             # 64 groups
    assert not gn.supported(100, 25, 16)             # no 16-byte vectors
    assert not gn.supported(64, 32, 1 << 23)         # an f32 count inexact
    with pytest.raises(ValueError, match="no plan"):
        gn.plan(1, 16, 96, 32, H100_SMS)


def _map(n=2, c=64, h=4, w=4, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def test_wrapper_refusals_on_the_cpu():
    x = _map()
    s, b = torch.ones(64), torch.zeros(64)
    cases = [
        (dict(x=x.float()), "want bf16"),
        (dict(x=x.contiguous()), "channels-last"),
        (dict(x=_map(c=96), s=torch.ones(96), b=torch.zeros(96)),
         "not a shape"),
        (dict(s=torch.ones(32)), "scale must be"),
        (dict(b=torch.zeros(64, dtype=torch.bfloat16)), "bias must be"),
        (dict(r=_map(), relu=False), "comes with the ReLU"),
        (dict(r=_map().contiguous()), "residual must be"),
        (dict(r=_map(c=32)), "residual must be"),
        ({}, "runs on a CUDA device"),
    ]
    for over, msg in cases:
        args = dict(x=x, s=s, b=b, r=None, relu=True) | over
        with pytest.raises(ValueError, match=msg):
            gn.group_norm_kernel(args["x"], args["s"], args["b"], GN_GROUPS,
                                 GN_EPS, args["relu"], args["r"])
    assert gn.group_norm_kernel.launches == 0


# ---- the plain path: the trunk's numbers as before -----------------------

def _rule_cases():
    x = _map()
    s = torch.nn.Parameter(torch.ones(64))
    b = torch.nn.Parameter(torch.zeros(64))
    yield "cpu", x, s, b
    yield "cpu f32", x.float(), s, b
    yield "cpu nchw", x.contiguous(), s, b


def test_rule_picks_the_plain_path_off_the_card():
    for what, x, s, b in _rule_cases():
        for grad in (True, False):
            with torch.set_grad_enabled(grad):
                assert not gn.kernel_applies(x, s, b, GN_GROUPS), what
                assert not gn.kernel_applies(x, s, b, GN_GROUPS, x), what


def _old_norm(norm, x):
    """A norm as the trunk ran it before the fused epilogue."""
    if isinstance(norm, GroupNorm):
        y = F.group_norm(x.float(), GN_GROUPS, norm.scale.float(),
                         norm.bias.float(), eps=GN_EPS)
        return norm.policy.cast_compute(y)
    cc = norm.policy.cast_compute
    return x * cc(norm.scale)[:, None, None] + cc(norm.bias)[:, None, None]


def _old_block(b, x):
    shortcut = x
    if b.conv_sc is not None:
        shortcut = _old_norm(b.norm_sc, b.conv_sc(x))
    y = torch.relu(_old_norm(b.norm1, b.conv1(x)))
    y = torch.relu(_old_norm(b.norm2, b.conv2(y)))
    y = _old_norm(b.norm3, b.conv3(y))
    return torch.relu(y + shortcut)


def _old_trunk(m, x):
    x = m.policy.cast_compute(x)
    x = torch.relu(_old_norm(m.stem_norm, m.stem_conv(x)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    feats = {}
    for stage, names in enumerate(m.stages):
        for name in names:
            x = _old_block(getattr(m, name), x)
        feats[f"c{stage + 2}"] = x
    return feats


def _randomise(m, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("kernel"):
                p.copy_(torch.randn(p.shape, generator=g)
                        / p[0].numel() ** 0.5)
            elif name.endswith("scale"):
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return m


POLICIES = {"f32": F32, "bf16": BF16}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("norm", ["gn", "frozen_bn"])
def test_trunk_on_the_cpu_equals_the_unfused_code(norm, policy):
    """A small trunk (R50's depths at 32^2, 128-2048 channels) gives the
    unfused code's features bit for bit, with and without gradients."""
    m = _randomise(ResNet(3, depths=(1, 1, 1, 1),
                          channels=(128, 256, 512, 1024), norm=norm,
                          policy=POLICIES[policy]))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = _old_trunk(m, x)
        got = m(x)
    for k in want:
        assert got[k].dtype == POLICIES[policy].compute_dtype
        assert torch.equal(got[k], want[k]), k
    got = m(x)                                 # gradients on
    assert torch.equal(got["c5"].detach(), want["c5"])
    got["c5"].float().sum().backward()
    assert m.stem_norm.scale.grad is not None


@pytest.mark.parametrize("relu,residual", [(False, False), (True, False),
                                           (True, True)],
                         ids=["none", "relu", "residual"])
def test_plain_chain_is_the_old_norm_and_epilogue(relu, residual):
    norm = _randomise(GroupNorm(64, BF16))
    x = _map(c=64, h=8, w=8)
    r = _map(c=64, h=8, w=8, seed=3) if residual else None
    want = _old_norm(norm, x)
    if residual:
        want = want + r
    if relu:
        want = torch.relu(want)
    with torch.no_grad():
        got = norm(x, relu=relu, residual=r)
    assert torch.equal(got, want)
    assert not norm.uses_kernel(x, r)


def test_bottleneck_on_the_cpu_equals_the_unfused_code():
    b = _randomise(Bottleneck(128, 256, stride=2, policy=BF16))
    x = _map(c=128, h=8, w=8)
    with torch.no_grad():
        assert torch.equal(b(x), _old_block(b, x))


# ---- the counters ------------------------------------------------------

def test_counters_one_per_trunk_forward_while_profiling():
    m = _randomise(ResNet(3, depths=(1, 1, 1, 1),
                          channels=(128, 256, 512, 1024), policy=BF16))
    x = torch.randn(1, 3, 16, 16)
    with torch.no_grad():
        m(x)                                   # no profiler: no count
        assert obs.recorded()["counts"] == {}
        with torch_profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                m(x)
    assert obs.recorded()["counts"] == {"ekaid.gn.kernel": 0,
                                        "ekaid.gn.plain": 3}


def test_frozen_affine_trunks_count_nothing():
    m = ResNet(3, depths=(1, 1, 1, 1), channels=(128, 256, 512, 1024),
               norm="frozen_bn", policy=BF16)
    with torch.no_grad(), torch_profile(activities=[ProfilerActivity.CPU]):
        m(torch.randn(1, 3, 16, 16))
    assert obs.recorded()["counts"] == {}


def test_mode0_encode_counts_both_trunk_calls():
    cfg = load_config(str(Path(__file__).resolve().parent.parent
                          / "configs" / "smoke.yaml"))
    cfg = cfg.replace(data=cfg.data.replace(feature_mode="mode0"),
                      train=cfg.train.replace(setting="mode0"))
    model = EkaidModel(cfg, cfg.speaker.vocab_size, device="cpu")
    b = synthetic_batch(cfg, 1, seed=0)
    rng = np.random.default_rng(0)
    for k in ("d_feats", "q_feats"):
        b[k] = rng.random((1, 32, 32), dtype=np.float32)
    with torch_profile(activities=[ProfilerActivity.CPU]):
        model.encode(b)
    c = obs.recorded()["counts"]
    assert (c["ekaid.gn.kernel"], c["ekaid.gn.plain"]) == (0, 2)


# ---- the build and the artifact ------------------------------------------

def _fake_builds(monkeypatch, tmp_path):
    built, opened = [], []

    def build(name):
        built.append(name)
        return tmp_path / f"lib{name}.so"

    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL",
                        lambda path: opened.append(path) or SimpleNamespace())
    monkeypatch.setattr(kernels, "_declare", lambda lib, name: lib)
    return built, opened


def test_load_builds_its_own_library(monkeypatch, tmp_path):
    built, opened = _fake_builds(monkeypatch, tmp_path)
    kernels.load("group_norm")
    assert built == ["group_norm"]
    assert opened == [str(tmp_path / "libgroup_norm.so")]
    kernels.load("group_norm")                # loaded: nothing built
    assert built == ["group_norm"]
    fn, argtypes = kernels.ENTRY["group_norm"]
    assert fn == "ekaid_group_norm" and len(argtypes) == 17
    assert len(kernels.source_hash("group_norm")) == 16


def test_load_all_builds_the_missing_in_one_pool(monkeypatch, tmp_path):
    built, opened = _fake_builds(monkeypatch, tmp_path)
    pools = []
    build_pool = kernels._build_pool
    monkeypatch.setattr(kernels, "_build_pool",
                        lambda names: pools.append(list(names))
                        or build_pool(names))
    kernels.load("greedy_decode")
    kernels.load_all(("group_norm", "greedy_decode", "group_norm"))
    assert pools == [["group_norm"]]
    assert sorted(built) == ["greedy_decode", "group_norm"]
    kernels.load_all(("group_norm", "greedy_decode"))
    kernels.load_all(())
    assert pools == [["group_norm"]] and len(opened) == 2
    kernels.load("group_norm")                # loaded: nothing built
    assert sorted(built) == ["greedy_decode", "group_norm"]


def _smoke_model(setting, policy):
    cfg = load_config(str(Path(__file__).resolve().parent.parent
                          / "configs" / "smoke.yaml"))
    if setting == "mode0":
        cfg = cfg.replace(data=cfg.data.replace(feature_mode="mode0"),
                          train=cfg.train.replace(setting="mode0"))
    return cfg, EkaidModel(cfg, cfg.speaker.vocab_size, policy=policy,
                           device="cpu")


@pytest.mark.parametrize("setting,policy,want", [
    ("mode0", "bf16", ("group_norm", "greedy_decode")),
    ("mode0", "f32", ("greedy_decode",)),
    ("mode2", "bf16", ("greedy_decode",)),
])
def test_artifact_carries_the_library_for_a_mode0_model_on_cuda(
        monkeypatch, setting, policy, want):
    """The kernels a decode launches, which an artifact carries, read from
    the model's own GroupNorms: K5 for a bf16 mode0 model on CUDA."""
    _, model = _smoke_model(setting, POLICIES[policy])
    assert model.decode_kernels() == ()                       # the CPU
    monkeypatch.setattr(EkaidModel, "device",
                        property(lambda self: torch.device("cuda")))
    assert model.decode_kernels() == want


@pytest.mark.parametrize("carried", [("greedy_decode",),
                                     ("greedy_decode", "group_norm")],
                         ids=["before-k5", "with-k5"])
def test_artifact_lacking_a_kernel_the_model_launches_is_refused(carried):
    """An artifact exported before K5 (it carries K1 alone) is refused for
    a model whose decode launches K5, before the weights are copied."""
    loaded = []
    meta = {"batch_sizes": [1], "kernels": {
        name: {"source_hash": "0" * 16, "file": f"lib{name}.so"}
        for name in carried}}
    art = Artifact(meta, {"w": torch.zeros(1)})
    model = SimpleNamespace(
        decode_kernels=lambda: ("group_norm", "greedy_decode"),
        load_state_dict=loaded.append)
    if "group_norm" in carried:
        art.load_into(model)
        assert loaded == [art.weights]
    else:
        with pytest.raises(RuntimeError, match="group_norm"):
            art.load_into(model)
        assert loaded == []


def test_first_decode_on_a_device_loads_its_kernels_at_once(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "load_all", calls.append)
    monkeypatch.setattr(EkaidModel, "decode_kernels",
                        lambda self: ("group_norm", "greedy_decode"))
    cfg, model = _smoke_model("mode2", F32)
    b = synthetic_batch(cfg, 2, seed=0)
    model.decode(b)
    model.decode(b)
    assert calls == [("group_norm", "greedy_decode")]
    model._kernels_on = torch.device("meta")           # another device
    model.decode(b)
    assert len(calls) == 2


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulp(v):
    """One bf16 ulp at |v|, taken at no less than 2^-8: the two paths'
    statistics agree to f32 rounding (~1e-7 of terms of order 1), which
    moves an output cancelled down to ~1e-6 by more than its own ulp."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -8))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _case(dev, n, h, w, c, affine, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn(1, c, 1, 1, generator=g, device=dev)
    x = (3 * torch.randn(n, c, h, w, generator=g, device=dev) + mu)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    r = torch.randn(n, c, h, w, generator=g, device=dev).to(torch.bfloat16)
    r = r.contiguous(memory_format=torch.channels_last)
    s = (1 + 0.3 * torch.randn(c, generator=g, device=dev)).to(affine)
    b = (0.3 * torch.randn(c, generator=g, device=dev)).to(affine)
    return x, r, s, b


EPILOGUES = {"none": (False, False), "relu": (True, False),
             "residual": (True, True)}


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_kernel_matches_the_eager_chain_on_cuda(card, trunk):
    n, depths, size = TRUNKS[trunk]
    worst = []
    for i, (h, w, c) in enumerate(_shapes(depths, size)):
        for affine in (torch.float32, torch.bfloat16):
            x, r, s, b = _case(card, n, h, w, c, affine, seed=i)
            y = gn.group_norm_plain(x, s, b, GN_GROUPS, GN_EPS,
                                    torch.bfloat16)
            for epi, (relu, res) in EPILOGUES.items():
                rr = r if res else None
                want = gn.group_norm_plain(x, s, b, GN_GROUPS, GN_EPS,
                                           torch.bfloat16, relu, rr)
                got = gn.group_norm_kernel(x, s, b, GN_GROUPS, GN_EPS,
                                           relu, rr)
                what = f"{trunk} {h}x{w}x{c} {epi} {affine}"
                assert got.dtype == torch.bfloat16, what
                assert got.shape == x.shape, what
                assert got.is_contiguous(
                    memory_format=torch.channels_last), what
                gap = (got.float() - want.float()).abs()
                tol = _ulp(y) + (_ulp(want) if res else 0)
                equal = (got == want).float().mean().item()
                assert torch.isfinite(got.float()).all(), what
                assert (gap <= tol).all(), (what, (gap - tol).max().item())
                assert equal >= 0.99, (what, equal)
                worst.append((equal, what))
    worst.sort()
    print(f"\n{trunk}: {len(worst)} cases, least bit-equal share "
          f"{worst[0][0]:.6f} ({worst[0][1]}) on "
          f"{torch.cuda.get_device_name(0)}")


def test_calls_and_graph_replays_are_bit_equal_on_cuda(card):
    x, r, s, b = _case(card, 64, 32, 32, 256, torch.bfloat16, seed=7)
    eager = gn.group_norm_kernel(x, s, b, GN_GROUPS, GN_EPS, True, r)
    again = gn.group_norm_kernel(x, s, b, GN_GROUPS, GN_EPS, True, r)
    assert torch.equal(eager, again)
    sx, sr = x.clone(), r.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        gn.group_norm_kernel(sx, s, b, GN_GROUPS, GN_EPS, True, sr)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gn.group_norm_kernel(sx, s, b, GN_GROUPS, GN_EPS, True, sr)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2, r2, _, _ = _case(card, 64, 32, 32, 256, torch.bfloat16, seed=8)
    sx.copy_(x2)
    sr.copy_(r2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, gn.group_norm_kernel(x2, s, b, GN_GROUPS,
                                                 GN_EPS, True, r2))


def test_r101_trunk_takes_the_kernel_on_cuda(card):
    """A bf16 R101 at 128^2, batch 8, inference-cast: without gradients
    every GroupNorm launches the kernel (104, one count), with them none
    (the plain path, one count); the kernel path stands no further from
    the f32 trunk on the same weights than the plain path (1.5x its
    distance, plus 1e-3 of the f32 features' scale), and its graph
    replays equal its eager call and show the kernel 104 times in a
    trace, which the wrapper does not count."""
    m32 = _randomise(ResNet(3, depths=R101, policy=F32)).to(card).eval()
    m16 = _randomise(ResNet(3, depths=R101, policy=BF16)).to(card).eval()
    cast_params_for_inference(m16, BF16)
    x = torch.rand(8, 3, 128, 128, device=card,
                   generator=torch.Generator(device=card).manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = m32(x)["c5"].float()
        start = gn.group_norm_kernel.launches
        with torch_profile(activities=[ProfilerActivity.CPU]):
            kern = m16(x)["c5"].float()
        assert gn.group_norm_kernel.launches - start == 104
    with torch.enable_grad():
        for p in m16.parameters():
            p.requires_grad_(True)
        with torch_profile(activities=[ProfilerActivity.CPU]):
            plain = m16(x)["c5"].detach().float()
        for p in m16.parameters():
            p.requires_grad_(False)
    assert gn.group_norm_kernel.launches - start == 104
    assert obs.recorded()["counts"] == {"ekaid.gn.kernel": 1,
                                        "ekaid.gn.plain": 1}
    d_kern = (kern - ref).abs().max().item()
    d_plain = (plain - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"\nR101 c5 max gap to f32: kernel {d_kern:.5g}, plain "
          f"{d_plain:.5g} (scale {scale:.5g}); kernel-plain "
          f"{(kern - plain).abs().max().item():.5g}")
    assert d_kern <= 1.5 * d_plain + 1e-3 * scale
    # the graph of the trunk replays the eager numbers
    sx = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.no_grad():
        with torch.cuda.stream(stream):
            m16(sx)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = m16(sx)["c5"]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.float(), kern)
    # a replay's trace shows the kernel once per GroupNorm, uncounted
    start = gn.group_norm_kernel.launches
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("group_norm_kernel" in n for n in names) == 104
    assert not any("RowwiseMoments" in n for n in names)
    assert gn.group_norm_kernel.launches == start
