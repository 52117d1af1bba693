"""K1's launch plan (``ops/loss_kernels.loss_stats_plan``) and its order of
summation, on the CPU.

The plan cuts n elements into float4-aligned chunks, one per block, with
the n mod 4 tail in the last block, and never launches more than one
wave of the card's resident blocks. A torch emulation of the kernel
(each thread's running sums over its float4s in the kernel's order, the
warp trees, the warps in order, then the last block's pass over the
partials in block-index order) must give ``eval_stats_reference``'s six
sums (counts exact, soft sums within ``EMU_RTOL``: float32 sums of up to
2.5 M terms in two orders, both trees) and agree with the JAX package's
Pallas kernel in interpret mode at small shapes (``PALLAS_RTOL``, as
``test_torch_loss.py`` holds the plain version to it).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops.pallas_kernels import eval_stats_pallas
from distributedpytorch_tpu_torch.ops import _build
from distributedpytorch_tpu_torch.ops import loss_kernels as lk

EMU_RTOL = 1e-6
PALLAS_RTOL = 1e-5
TRAIN_N = 4 * 640 * 960  # the train/eval batch at the reference geometry
SIZES = [0, 1, 3, 4, 5, 1023, 1025, 2**20 + 3, TRAIN_N, 2**31 - 1]
CARDS = [(132, 4), (114, 4), (132, 8), (114, 8)]  # (SMs, blocks per SM)
WARP = 32


def _inputs(n, seed=0, subnormal=True):
    """p with exact 0 and 1, 0.5 and the float32 just below it, and
    (with ``subnormal``) subnormal values; t in {0, 1, 255} (255 counts
    as 0)."""
    rng = np.random.default_rng(seed)
    p = rng.random(n, dtype=np.float32)
    special = [(0, 0.0), (1, 1.0), (2, 0.5), (3, 0.49999997)]
    if subnormal:
        special += [(4, 1e-40), (5, 1e-45), (6, 1.1754942e-38)]
    for start, value in special:
        p[start::11] = value
    t = rng.integers(0, 3, n).astype(np.float32)
    t[t == 2] = 255.0
    return p, t


def _terms(p, t):
    """The kernel's per-element terms: three floats, three 0/1 counts."""
    tb = t == 1.0
    pb = p >= 0.5
    bce = -torch.clamp(torch.log(torch.where(tb, p, 1.0 - p)), min=-100.0)
    floats = torch.stack([bce, torch.where(tb, p, torch.zeros_like(p)), p])
    counts = torch.stack([tb, pb, tb & pb]).to(torch.int64)
    return floats, counts


def _block_sum(v):
    """(..., threads) -> (...): shuffle-down trees within each warp (lane 0
    reads lane offset at 16, 8, 4, 2, 1), then the warps in order."""
    v = v.reshape(*v.shape[:-1], -1, WARP)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    v = v[..., 0]
    total = v[..., 0]
    for w in range(1, v.shape[-1]):
        total = total + v[..., w]
    return total


def emulate(p, t, plan):
    """The six sums as the kernel forms them under ``plan``."""
    floats, counts = _terms(p, t)
    threads = lk.THREADS
    body = plan.n - plan.n % 4
    chunk4 = plan.chunk // 4
    trips = -(-chunk4 // threads)
    # float4 i of block b is its slot i - b chunk4; slots past a block's
    # end hold zero terms, which leave every float32 sum as it is
    slots = torch.zeros(3, plan.blocks, trips * threads, 4)
    for b in range(plan.blocks):
        begin, end = plan.block_range(b)
        slots[:, b, :(end - begin) // 4] = floats[:, begin:end].reshape(
            3, -1, 4)
    slots = slots.reshape(3, plan.blocks, trips, threads, 4)
    acc = torch.zeros(3, plan.blocks, threads)
    for k in range(trips):  # each thread: its float4s in order, x y z w
        for lane in range(4):
            acc = acc + slots[:, :, k, :, lane]
    tail = floats[:, body:]
    acc[:, -1, :tail.shape[1]] += tail  # after the last block's loop
    partial = _block_sum(acc)  # (3, blocks)
    # the last block: thread i adds partials i, i + threads, ... in turn
    rounds = -(-plan.blocks // threads)
    padded = torch.zeros(3, rounds * threads)
    padded[:, :plan.blocks] = partial
    per_thread = torch.zeros(3, threads)
    for r in range(rounds):
        per_thread = per_thread + padded[:, r * threads:(r + 1) * threads]
    bce, inter, sum_p = _block_sum(per_thread)
    n_t, n_pred, n_both = counts.sum(dim=1).tolist()
    f32 = torch.float32
    return torch.stack([
        bce, torch.tensor(plan.n, dtype=f32), inter,
        sum_p + torch.tensor(n_t, dtype=f32), torch.tensor(n_both, dtype=f32),
        torch.tensor(n_pred + n_t, dtype=f32),
    ])


# -- the partition ------------------------------------------------------------


@pytest.mark.parametrize("sms,per_sm", CARDS)
@pytest.mark.parametrize("n", SIZES)
def test_chunks_cover_every_element_once(n, sms, per_sm):
    plan = lk.loss_stats_plan(n, sms, per_sm)
    body = n - n % 4
    assert plan.chunk % 4 == 0 and plan.chunk >= 4 * lk.THREADS
    ranges = [plan.block_range(b) for b in range(plan.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == body
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(begin % 4 == 0 and end % 4 == 0 for begin, end in ranges)
    # no block idles, except the lone block of an input under 4 elements
    assert all(begin < end for begin, end in ranges) or plan.blocks == 1
    assert all(end - begin == plan.chunk for begin, end in ranges[:-1])
    assert plan.tail == (body, n) and n - body < 4
    if n <= 2**22:
        covered = np.zeros(n, np.int64)
        for begin, end in ranges + [plan.tail]:
            covered[begin:end] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("sms,per_sm", CARDS)
def test_grid_never_exceeds_one_wave(sms, per_sm):
    for n in SIZES + [2**20, 4 * sms * per_sm * lk.THREADS + 4]:
        assert 1 <= lk.loss_stats_plan(n, sms, per_sm).blocks <= sms * per_sm


@pytest.mark.parametrize("sms,per_sm", CARDS)
def test_train_shape_fills_whole_waves(sms, per_sm):
    plan = lk.loss_stats_plan(TRAIN_N, sms, per_sm)
    assert plan.blocks == sms * per_sm


def test_small_inputs_take_one_block():
    """A chunk holds a float4 for every thread, so up to 4 x THREADS
    elements (and the tail) run in one block and the last pass adds one
    partial."""
    for n in (0, 1, 3, 5, 1023, 4 * lk.THREADS + 3):
        assert lk.loss_stats_plan(n, 132, 4).blocks == 1
    assert lk.loss_stats_plan(4 * lk.THREADS + 4, 132, 4).blocks == 2


def test_geometry_matches_the_kernel_source():
    """The plan's thread and load constants are the ones the kernel is
    compiled with, and the source computes the same chunk; its entry
    point refuses any other plan."""
    src = _build.source_path("loss_stats").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (lk.THREADS, lk.UNROLL) == (const("kStatsThreads"),
                                       const("kUnroll"))
    assert "if (chunk4 < kStatsThreads) chunk4 = kStatsThreads;" in src
    assert "blocks != want_blocks || chunk != want_chunk" in src


# -- the order of summation ---------------------------------------------------


@pytest.mark.parametrize("n", [s for s in SIZES if s < 2**31 - 1])
def test_emulated_kernel_sums_match_the_plain_version(n):
    p, t = (torch.from_numpy(x) for x in _inputs(n, seed=n % 7))
    plan = lk.loss_stats_plan(n, 132, 4)
    got = emulate(p, t, plan)
    want = lk.eval_stats_reference(p, t)
    assert torch.equal(got[[1, 4, 5]], want[[1, 4, 5]])
    np.testing.assert_allclose(got[[0, 2, 3]].numpy(),
                               want[[0, 2, 3]].numpy(), rtol=EMU_RTOL,
                               atol=0)


@pytest.mark.parametrize("sms,per_sm", CARDS)
def test_sums_do_not_depend_on_the_card_beyond_rounding(sms, per_sm):
    """Another card's plan regroups the same terms: the soft sums move
    by rounding only, the counts not at all."""
    p, t = (torch.from_numpy(x) for x in _inputs(2**20 + 3, seed=1))
    base = emulate(p, t, lk.loss_stats_plan(p.numel(), 132, 4))
    other = emulate(p, t, lk.loss_stats_plan(p.numel(), sms, per_sm))
    assert torch.equal(base[[1, 4, 5]], other[[1, 4, 5]])
    np.testing.assert_allclose(other.numpy(), base.numpy(), rtol=EMU_RTOL,
                               atol=0)


@pytest.mark.parametrize("shape", [(1, 1, 5, 1), (2, 33, 47, 1),
                                   (4, 64, 96, 1)])
def test_emulated_kernel_matches_pallas_interpret(shape):
    """No subnormal p here: XLA on the CPU flushes them to zero, so the
    Pallas kernel's log clamps at -100 where IEEE logf gives about -92."""
    n = int(np.prod(shape))
    p, t = (x.reshape(shape) for x in _inputs(n, seed=4, subnormal=False))
    want = np.asarray(eval_stats_pallas(jnp.asarray(p), jnp.asarray(t),
                                        interpret=True))
    got = emulate(torch.from_numpy(p).reshape(-1),
                  torch.from_numpy(t).reshape(-1),
                  lk.loss_stats_plan(n, 132, 4)).numpy()
    np.testing.assert_array_equal(got[[1, 4, 5]], want[[1, 4, 5]])
    np.testing.assert_allclose(got[[0, 2, 3]], want[[0, 2, 3]],
                               rtol=PALLAS_RTOL, atol=0)
