"""The ROI geometry of the K2/K3 kernels and the packing of their
arguments, on the CPU.

`roi_kernels._roi_geometry` (which the kernel in `csrc/roi_align.cu`
repeats operation for operation, and which `chip_smoke.py` holds the
kernel's geometry against on the card, bit for bit) is held against the
JAX package's `_roi_geometry` exactly: levels and all 8 floats, on the
hard ROI set, on random boxes and on ROIs within 2 f32 ulps of every
level boundary (`chip_smoke.boundary_rois`). The port's log2 is the
correctly rounded one (`roi_align.log2_f32`). The reference's XLA log2
on the CPU is log(x) * f32(1 / ln 2), which is not: within 8 ulps of
the boundaries, the one size where the two levels differ is sqrt(area)
= 448 - 3 ulps (level 5 here, 4 there), which
`test_geometry_differs_from_jax_only_where_xla_log2_rounds_off` pins.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import ekaid_tpu.ops.pallas_roi as jroi
from ekaid_torch.ops import roi_align as tra
from ekaid_torch.ops import roi_kernels as trk
from test_torch_detector_ops import HARD_ROIS, SCALES, random_boxes

HEIGHTS = (256, 128, 64, 32)


def _geometry_sets():
    rng = np.random.default_rng(5)
    return {"hard": HARD_ROIS,
            "boundary": chip_smoke.boundary_rois(2),
            "random": random_boxes(rng, 4000, size=1024)}


@pytest.mark.parametrize("which", ["hard", "boundary", "random"])
def test_roi_geometry_matches_jax_exactly(which):
    rois = _geometry_sets()[which]
    lvl, fmeta = trk._roi_geometry(torch.as_tensor(rois), SCALES, HEIGHTS,
                                   7, 2, 2, 4)
    jl, _, _, jf = jroi._roi_geometry(jnp.asarray(rois), SCALES, HEIGHTS,
                                      7, 2, 2, 4)
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        fmeta.numpy().view(np.int32).reshape(-1),
        np.asarray(jf).view(np.int32))


def test_boundary_set_crosses_every_boundary():
    """Within `BOUNDARY_ULPS` (the set the card's check takes), each
    level boundary is taken on both sides, and the bump on both sides
    of each cap."""
    rois = torch.as_tensor(chip_smoke.boundary_rois())
    lvl, _ = trk._roi_geometry(rois, SCALES, HEIGHTS, 7, 2, 2, 4)
    assert set(lvl.tolist()) == {0, 1, 2, 3}
    w, h = rois[:, 2] - rois[:, 0], rois[:, 3] - rois[:, 1]
    for side in (112.0, 224.0, 448.0):
        at = ((w - side).abs() < 1e-3) & ((h - side).abs() < 1e-3)
        assert len(set(lvl[at].tolist())) == 2, side
    for long_side in (176.0, 352.0, 704.0):
        at = (torch.maximum(w, h) - long_side).abs() < 1e-3
        assert len(set(lvl[at].tolist())) == 2, long_side


def test_geometry_differs_from_jax_only_where_xla_log2_rounds_off():
    """Over the card's boundary set (8 ulps either side), the port and
    the reference differ only on the two squares whose sqrt(area) is
    448 - 3 ulps: the correctly rounded log2 puts them on level 5, XLA's
    on level 4. Every other level and float is equal."""
    rois = chip_smoke.boundary_rois(8)
    lvl, fmeta = trk._roi_geometry(torch.as_tensor(rois), SCALES, HEIGHTS,
                                   7, 2, 2, 4)
    jl, _, _, jf = jroi._roi_geometry(jnp.asarray(rois), SCALES, HEIGHTS,
                                      7, 2, 2, 4)
    jl, jf = np.asarray(jl), np.asarray(jf).reshape(-1, 8)
    w448 = (np.array([448.0], np.float32).view(np.int32) - 3).view(
        np.float32)[0]
    off = (rois[:, 2] - rois[:, 0] == w448) & (rois[:, 3] - rois[:, 1]
                                                == w448)
    assert off.sum() == 2
    np.testing.assert_array_equal(lvl.numpy()[~off], jl[~off])
    np.testing.assert_array_equal(fmeta.numpy()[~off].view(np.int32),
                                  jf[~off].view(np.int32))
    assert (lvl.numpy()[off] == 3).all() and (jl[off] == 2).all()


def _levels_np(q, canonical_level=4.0):
    """floor(4 + log2(q)) with log2 rounded once to f32, in numpy."""
    l2 = np.log2(q.astype(np.float64)).astype(np.float32)
    return np.floor(np.float32(canonical_level) + l2)


def test_level_follows_the_correctly_rounded_log2():
    """Within 64 ulps of each level boundary, the port's level is that
    of the correctly rounded log2."""
    for side in (112.0, 224.0, 448.0):
        bits = np.array([side], np.float32).view(np.int32)
        w = (bits + np.arange(-64, 65, dtype=np.int32)).view(np.float32)
        rois = np.stack([np.zeros_like(w), np.zeros_like(w), w, w], 1)
        got = tra.assign_levels(torch.as_tensor(rois)).numpy()
        q = (w / np.float32(224.0)).astype(np.float32)
        np.testing.assert_array_equal(
            got, np.clip(_levels_np(q), 2, 5).astype(np.int32))


def test_log2_and_division_are_rounded_once():
    """`log2_f32` is log2 rounded once to f32 and `true_div` a true
    division, on values near powers of two and at random."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (np.array([2.0 ** k for k in range(-20, 21)], np.float32)
         .view(np.int32)[:, None]
         + np.arange(-8, 9, dtype=np.int32)).reshape(-1).view(np.float32),
        rng.uniform(1e-6, 1e3, 100_000).astype(np.float32)])
    np.testing.assert_array_equal(
        tra.log2_f32(torch.as_tensor(x)).numpy(),
        np.log2(x.astype(np.float64)).astype(np.float32))
    for d in (7.0, 44.0, 224.0):
        np.testing.assert_array_equal(
            tra.true_div(torch.as_tensor(x), d).numpy(), x / np.float32(d))


# ------------------------------------------------ the kernel's arguments ---

def _maps(dtype=torch.bfloat16, c=16, b=2, sizes=(256, 128, 64, 32)):
    return [torch.zeros(b, s, s, c, dtype=dtype) for s in sizes]


def _rois(b=2, r=5):
    rng = np.random.default_rng(1)
    return torch.as_tensor(random_boxes(rng, b * r, size=1000)
                           .reshape(b, r, 4))


def test_level_table_matches_the_kernel_struct():
    """csrc/roi_align.cu::Levels: 8 pointers, 8 heights, 8 scales, the
    count and the first level, in that order."""
    t = trk.LevelTable
    assert ctypes.sizeof(t) == 8 * 8 + 8 * 4 + 8 * 4 + 4 + 4
    assert [t.ptr.offset, t.h.offset, t.scale.offset, t.num.offset,
            t.min_level.offset] == [0, 64, 96, 128, 132]
    maps = _maps()
    table = trk.level_table(maps, SCALES, 2)
    assert list(table.ptr[:4]) == [m.data_ptr() for m in maps]
    assert list(table.h[:4]) == [256, 128, 64, 32]
    assert list(table.scale[:4]) == SCALES
    assert (table.num, table.min_level) == (4, 2)


@pytest.mark.parametrize("batched", [True, False])
def test_kernel_args_pack_raw_boxes(batched):
    maps, rois = _maps(), _rois()
    if not batched:
        maps, rois = [m[0] for m in maps], rois[0]
    args = trk._kernel_args(maps, rois, SCALES, 7, 2, 2)
    b, r = (2, 5) if batched else (1, 5)
    assert (args.batched, args.b, args.r_per) == (batched, b, r)
    assert args.rois.dtype == torch.float32 and args.rois.is_contiguous()
    assert torch.equal(args.rois, rois.reshape(-1, 4))
    assert args.rois.data_ptr() % 16 == 0
    assert all(m.dim() == 4 for m in args.fmaps)


@pytest.mark.parametrize("dtype,c,ok", [
    (torch.bfloat16, 256, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 12, False), (torch.bfloat16, 4, False),
    (torch.float32, 4, True), (torch.float32, 6, False),
    (torch.float16, 16, False)])
def test_kernel_args_refuse_channels_off_the_16_byte_vector(dtype, c, ok):
    maps, rois = _maps(dtype, c), _rois()
    if ok:
        trk._kernel_args(maps, rois, SCALES, 7, 2, 2)
    else:
        with pytest.raises(ValueError, match="multiple of|instance"):
            trk._kernel_args(maps, rois, SCALES, 7, 2, 2)


def test_kernel_args_refuse_misaligned_or_strided_maps():
    maps, rois = _maps(), _rois()
    flat = torch.zeros(maps[1].numel() + 1, dtype=torch.bfloat16)
    shifted = list(maps)
    shifted[1] = flat[1:].view(maps[1].shape)      # 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        trk._kernel_args(shifted, rois, SCALES, 7, 2, 2)
    strided = list(maps)
    strided[0] = maps[0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        trk._kernel_args(strided, rois, SCALES, 7, 2, 2)


@pytest.mark.parametrize("kw", [{"out_size": 17}, {"out_size": 0},
                                {"sampling_ratio": 5},
                                {"sampling_ratio": 0}])
def test_kernel_args_refuse_sizes_beyond_the_kernel(kw):
    args = dict(out_size=7, sampling_ratio=2, min_level=2) | kw
    with pytest.raises(ValueError, match="out_size"):
        trk._kernel_args(_maps(), _rois(), SCALES, **args)


def test_kernel_args_refuse_more_levels_or_other_batches():
    sizes = (1024, 512, 256, 128, 64, 32, 16, 8, 8)
    with pytest.raises(ValueError, match="levels"):
        trk.level_table(_maps(c=8, b=1, sizes=sizes), [1.0] * 9, 2)
    with pytest.raises(ValueError, match="one image"):
        trk._kernel_args(_maps(b=3), _rois(b=2), SCALES, 7, 2, 2)
