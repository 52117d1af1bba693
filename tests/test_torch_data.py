"""The port's data layer against the JAX package's: the split, each
epoch's batch order, the synthetic items and the decoded Carvana items
must be bit-equal, so the two trainers see the same batches."""

import numpy as np
import pytest

from distributedpytorch_tpu.data import dataset as jds
from distributedpytorch_tpu.data import loader as jld
from distributedpytorch_tpu_torch.data import dataset as tds
from distributedpytorch_tpu_torch.data import loader as tld
from distributedpytorch_tpu_torch.data.dataset import SampleCache
from distributedpytorch_tpu_torch.utils.prefetch import (
    SINGLE,
    STACK,
    stacked_work,
)


@pytest.mark.parametrize("n,frac,seed", [(16, 0.25, 0), (40, 0.2, 0),
                                         (101, 0.1, 7), (5, 0.1, 0)])
def test_seeded_split_is_the_jax_split(n, frac, seed):
    got = tld.seeded_split(n, frac, seed)
    want = jld.seeded_split(n, frac, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batch_order_per_epoch_is_the_jax_order(world, drop_last):
    indices = np.random.default_rng(0).permutation(23)[:19]
    for rank in range(world):
        kw = dict(indices=indices, batch_size=4, shuffle=True,
                  drop_last=drop_last, seed=42)
        got = tld.DataLoader(range(23), shard=tld.ShardSpec(rank, world),
                             **kw)
        want = jld.DataLoader(range(23), shard=jld.ShardSpec(rank, world),
                              **kw)
        assert len(got) == len(want)
        for epoch in range(3):
            g, w = got.batch_slices(epoch), want.batch_slices(epoch)
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_epoch_batches_equal_the_jax_loaders(num_workers):
    """Whole batches, decode threads and the sample cache included."""
    size, n = (48, 32), 11
    got = tld.DataLoader(tds.SyntheticSegmentationDataset(n, size, 3),
                         batch_size=3, shuffle=True, seed=5,
                         num_workers=num_workers,
                         cache=SampleCache(2**20))
    want = jld.DataLoader(jds.SyntheticSegmentationDataset(n, size, 3),
                          batch_size=3, shuffle=True, seed=5)
    for epoch in range(2):  # the second epoch comes from the cache
        pairs = list(zip(got.epoch_batches(epoch),
                         want.epoch_batches(epoch)))
        assert len(pairs) == len(want)
        for a, b in pairs:
            for key in ("image", "mask"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("idx", [0, 5, 15])
def test_synthetic_items_are_bit_equal(idx):
    got = tds.SyntheticSegmentationDataset(16, (48, 32), seed=42)[idx]
    want = jds.SyntheticSegmentationDataset(16, (48, 32), seed=42)[idx]
    for key in ("image", "mask"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_carvana_tree_items_and_fallback(tmp_path):
    images, masks = jds.write_synthetic_carvana_tree(str(tmp_path), n=4,
                                                     size_wh=(40, 24))
    got = tds.build_dataset(images, masks, (20, 12))
    want = jds.build_dataset(images, masks, (20, 12))
    want.use_native = False  # the port decodes with PIL only
    assert isinstance(got, tds.CarvanaDataset) and got.ids == want.ids
    for i in range(len(got)):
        for key in ("image", "mask"):
            np.testing.assert_array_equal(got[i][key], want[i][key])
    # masks without the _mask suffix: the basic dataset takes over
    plain = tmp_path / "plain"
    (plain / "img").mkdir(parents=True)
    (plain / "msk").mkdir()
    for name in sorted((tmp_path / "train_hq").iterdir()):
        (plain / "img" / name.name).write_bytes(name.read_bytes())
        mask = tmp_path / "train_masks" / f"{name.stem}_mask.gif"
        (plain / "msk" / f"{name.stem}.gif").write_bytes(mask.read_bytes())
    basic = tds.build_dataset(str(plain / "img"), str(plain / "msk"), (20, 12))
    assert type(basic) is tds.BasicDataset
    np.testing.assert_array_equal(basic[1]["mask"], got[1]["mask"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="No input file"):
        tds.BasicDataset(str(tmp_path / "empty"), str(plain / "msk"))


def test_stacked_work_groups_like_the_jax_pipeline():
    from distributedpytorch_tpu.utils.prefetch import (
        stacked_work as jax_stacked_work,
    )

    sizes = [4, 4, 4, 2, 4, 4, 4, 4, 4]
    batches = [{"image": np.zeros((s, 1, 1, 3))} for s in sizes]
    got = [(k, [b["image"].shape[0] for b in (p if k == STACK else [p])])
           for k, p in stacked_work(batches, 2, 4)]
    want = [(k, [b["image"].shape[0] for b in (p if k == "stack" else [p])])
            for k, p in jax_stacked_work(batches, 2, 4)]
    assert got == want
    assert [k for k, _ in got].count(SINGLE) == 3
