"""K5's launch plan (``ops/wgrad_kernels.wgrad_plan``) on the CPU: how a
call cuts the sum over B·H·W into row segments and split ranges, and how
many blocks it launches. Checked at every conv shape of full-width
milesial that engages K5 (batch 4 at 960 × 640, read off the model
itself) and at ragged shapes: every pixel of every row is covered by
exactly one segment of exactly one split, the partials stay within
64 MiB, and the blocks fill whole waves of the card's SMs wherever a
split count allows it. The kernel source states the same geometry.
"""

import re
from collections import Counter

import pytest
import torch

from distributedpytorch_tpu_torch.models.milesial import MilesialUNet
from distributedpytorch_tpu_torch.models.unet import TapsConv2d
from distributedpytorch_tpu_torch.ops import _build
from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

# (H, W, Cin, Cout) of milesial's convs with both sides >= 128 channels at
# batch 4 on 960 x 640, and how many of the 13 per step have the shape
MILESIAL_ENGAGED = {
    (320, 480, 128, 128): 2, (320, 480, 256, 128): 1,
    (160, 240, 128, 256): 1, (160, 240, 256, 256): 2,
    (160, 240, 512, 256): 1,
    (80, 120, 256, 512): 1, (80, 120, 512, 512): 2, (80, 120, 1024, 512): 1,
    (40, 60, 512, 1024): 1, (40, 60, 1024, 1024): 1,
}
RAGGED = [(2, 9, 37, 144, 128), (2, 7, 70, 128, 256), (3, 1, 64, 128, 128),
          (2, 5, 20, 128, 128), (2, 8, 16, 1024, 128), (1, 6, 33, 128, 144),
          (1, 6, 35, 16, 32), (1, 1, 1, 16, 16)]
SHAPES = [(4,) + s for s in MILESIAL_ENGAGED] + RAGGED


def test_engaged_shapes_are_milesials():
    """The table above is what full-width milesial's taps convs see: a
    forward on the meta device records each conv's input plane."""
    with torch.device("meta"):
        model = MilesialUNet(n_classes=1, wgrad_taps=True)
        seen = Counter()

        def record(module, args, out):
            x = args[0]
            cin, cout = x.shape[1], out.shape[1]
            if min(cin, cout) >= 128:
                seen[(x.shape[2], x.shape[3], cin, cout)] += 1

        for m in model.modules():
            if isinstance(m, TapsConv2d):
                m.register_forward_hook(record)
        model(torch.empty(4, 640, 960, 3))
    assert dict(seen) == MILESIAL_ENGAGED
    flops = sum(n * 2 * 9 * 4 * h * w * ci * co
                for (h, w, ci, co), n in MILESIAL_ENGAGED.items())
    assert sum(seen.values()) == 13 and round(flops / 1e9) == 2627


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_ranges_cover_every_pixel_once(shape, bf16):
    b, h, w, cin, cout = shape
    plan = wk.wgrad_plan(b, h, w, cin, cout, bf16)
    assert 1 <= plan.splits <= max(plan.n_segs, 1)
    ranges = [plan.seg_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.n_segs
    assert all(r[0] < r[1] for r in ranges)  # no split goes idle
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    covered = Counter()
    for begin, end in ranges:
        for seg in range(begin, end):
            bi, y, x0 = plan.segment(seg)
            assert 0 <= bi < b and 0 <= y < h and 0 <= x0 < w
            for x in range(x0, min(x0 + plan.seg, w)):
                covered[(bi, y, x)] += 1
    assert len(covered) == b * h * w and set(covered.values()) == {1}


@pytest.mark.parametrize("shape", SHAPES)
def test_partials_stay_within_64_mib(shape):
    for bf16 in (True, False):
        plan = wk.wgrad_plan(*shape, bf16)
        assert plan.partial_bytes <= wk.MAX_PARTIAL_BYTES
        assert plan.partial_bytes == (0 if plan.splits == 1 else
                                      plan.splits * 9 * shape[3] * shape[4] * 4)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_blocks_fill_whole_waves_where_the_split_allows(shape, sms):
    """No allowed split count fills the last wave better; where one gives
    whole waves, the plan's blocks are whole waves."""
    b, h, w, cin, cout = shape
    plan = wk.wgrad_plan(b, h, w, cin, cout, True, sms)
    most = max(1, min(plan.n_segs,
                      wk.MAX_PARTIAL_BYTES // (9 * cin * cout * 4)))

    def fill(s):
        blocks = plan.tiles * s
        return blocks / (-(-blocks // sms) * sms)

    assert fill(plan.splits) == max(fill(s) for s in range(1, most + 1))
    if any(plan.tiles * s % sms == 0 for s in range(1, most + 1)):
        assert plan.blocks % sms == 0


def test_full_waves_at_milesials_largest_planes():
    """128 -> 128 and 256 -> 128 on 4 x 320 x 480, the step's longest K5
    calls, run one whole wave of 132 blocks."""
    for cin in (128, 256):
        plan = wk.wgrad_plan(4, 320, 480, cin, 128, True)
        assert plan.blocks == 132 and plan.splits > 1
    # 1024 -> 1024 has 384 tiles and no room for a second split's partials
    assert wk.wgrad_plan(4, 40, 60, 1024, 1024, True).splits == 1


@pytest.mark.parametrize("shape", [(1, 2, 3, 0, 16), (1, 2, 3, 16, 0),
                                   (2, 0, 5, 16, 16), (0, 4, 4, 16, 16)])
def test_empty_shapes_plan_one_split(shape):
    """No channels or no pixels: one split and no partials (the entry
    point writes zeros or nothing)."""
    for bf16 in (True, False):
        plan = wk.wgrad_plan(*shape, bf16)
        assert plan.splits == 1 and plan.partial_bytes == 0


def test_f32_plan_keeps_four_blocks_per_sm():
    for shape in SHAPES:
        plan = wk.wgrad_plan(*shape, False)
        b, h, w, cin, cout = shape
        tiles = 3 * -(-cin // 16) * -(-cout // 16)
        by_memory = wk.MAX_PARTIAL_BYTES // (9 * cin * cout * 4)
        want = max(1, min(-(-528 // tiles), plan.n_segs, by_memory))
        assert (plan.tiles, plan.splits) == (tiles, want)


def test_geometry_matches_the_kernel_source():
    """The plan's segment and tile sizes are the ones the kernels are
    compiled with; the entry point refuses any other."""
    src = _build.source_path("wgrad_9tap").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    bf16 = wk.wgrad_plan(1, 1, 1, 16, 16, True)
    f32 = wk.wgrad_plan(1, 1, 1, 16, 16, False)
    assert (bf16.seg, bf16.tile_ci, bf16.tile_co) == (
        const("kSeg"), const("kTileCi"), const("kTileCo"))
    assert (f32.seg, f32.tile_ci, f32.tile_co) == (
        const("kTK"), const("kTileF"), const("kTileF"))
