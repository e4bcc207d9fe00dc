"""The port's loader (ioudet_torch/data/loader.py) against ioudet's with one
shard, on the CPU: GroupedBatchSampler's index batches for shuffle on and
off, drop_last, ragged tails and orientation groups over two epochs, and the
collated batches of DataLoader / build_dataloader bit-equal on a planted
dataset.  Then what the port adds: an orientation group of fewer images
than half a batch keeps its images when unshuffled (ioudet's loader drops
them), and a sample's exception reaches the consumer."""

import threading

import numpy as np
import pytest

from ioudet.data import build_dataset as jax_build_dataset
from ioudet.data.loader import (DataLoader as JaxDataLoader,
                                GroupedBatchSampler as JaxSampler,
                                build_dataloader as jax_build_dataloader)
from ioudet_torch.data import build_dataset
from ioudet_torch.data.loader import DataLoader, GroupedBatchSampler, build_dataloader
from tests.test_torch_data_pipeline import plant_coco, small_pipeline
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

# 13 landscape, 6 portrait: ragged at batch 4 and 5 in both groups
FLAGS = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1], np.uint8)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("batch", [1, 4, 5])
def test_sampler_batches_equal_ioudet(shuffle, drop_last, batch):
    ours = GroupedBatchSampler(FLAGS, batch, shuffle, seed=3, drop_last=drop_last)
    ref = JaxSampler(FLAGS, batch, shuffle, seed=3, num_shards=1, shard_index=0,
                     drop_last=drop_last)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = list(ours)
        assert got == list(ref)
        assert len(ours) == len(ref) == len(got)
        for b in got:
            assert len(b) == batch and len(set(FLAGS[b])) == 1
    if not shuffle:
        ours.set_epoch(0)
        seen = sorted({i for b in ours for i in b})
        assert seen == list(range(len(FLAGS))) or drop_last


SIZES = [(40, 64), (64, 40), (40, 72), (36, 64), (64, 36), (48, 80), (40, 60),
         (60, 40), (44, 70), (50, 64)]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    ann_file, img_dir = plant_coco(str(tmp_path_factory.mktemp("loader")), SIZES, seed=4)
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               pipeline=small_pipeline("train_pipeline", (80, 48), (64, 96)))
    return build_dataset(cfg), jax_build_dataset(cfg)


def assert_batches_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_equal_ioudet(datasets, shuffle):
    ours_ds, ref_ds = datasets
    ours = DataLoader(ours_ds, 3, shuffle=shuffle, num_workers=2, seed=5)
    ref = JaxDataLoader(ref_ds, 3, shuffle=shuffle, num_workers=2, seed=5, num_shards=1,
                        shard_index=0)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert_batches_equal(list(ours), list(ref))


def test_build_dataloader_equals_ioudet(datasets):
    ours_ds, ref_ds = datasets
    ours = build_dataloader(ours_ds, 2, 3, seed=1)
    ref = jax_build_dataloader(ref_ds, 2, 3, seed=1, num_shards=1, shard_index=0)
    assert len(ours) == len(ref)
    assert_batches_equal(list(ours), list(ref))
    # the worker count does not change what a sample draws
    assert_batches_equal(list(build_dataloader(ours_ds, 2, 1, seed=1)), list(ref))


def test_square_images_batch_with_the_landscape_ones(tmp_path):
    """A square image gets the landscape canvas from Pad, so it is in the
    landscape group (in ioudet's portrait group the batch cannot be
    stacked)."""
    ann_file, img_dir = plant_coco(str(tmp_path), [(48, 48), (40, 64), (64, 40), (50, 50)])
    ds = build_dataset(dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
                            pipeline=small_pipeline("train_pipeline", (80, 48), (64, 96))))
    assert ds.flag.tolist() == [1, 1, 0, 1]
    batches = list(DataLoader(ds, 2, shuffle=True, num_workers=2))
    assert sorted(b["img"].shape[1:3] for b in batches) == [(64, 96), (64, 96), (96, 64)]


def test_small_group_keeps_its_images():
    flags = np.array([1] * 9 + [0] * 2, np.uint8)
    batches = list(GroupedBatchSampler(flags, 8, shuffle=False))
    assert sorted({i for b in batches for i in b}) == list(range(11))
    assert [9, 10, 9, 10, 9, 10, 9, 10] in batches
    # ioudet's unshuffled sampler drops the two portrait images
    ref = list(JaxSampler(flags, 8, shuffle=False, num_shards=1, shard_index=0))
    assert {i for b in ref for i in b} == set(range(9))


class Failing:
    flag = np.zeros(6, np.uint8)

    def __len__(self):
        return 6

    def __getitem__(self, idx):
        if idx == 4:
            raise OSError("unreadable sample 4")
        return dict(x=np.full(2, idx))


def test_sample_errors_reach_the_consumer():
    it = iter(DataLoader(Failing(), 2, shuffle=False, num_workers=2))
    assert next(it)["x"].tolist() == [[0, 0], [1, 1]]
    with pytest.raises(OSError, match="sample 4"):
        list(it)


def test_abandoned_iterator_stops():
    before = threading.active_count()
    it = iter(DataLoader(Failing(), 1, shuffle=False, num_workers=1, prefetch=1))
    next(it)
    it.close()
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=5)
    assert threading.active_count() <= before
