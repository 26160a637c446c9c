"""The port's ``gluon.data`` against the JAX package's.

Samplers and loaders without shuffling give the same index lists and
the same batches, batch for batch (exact: the same numpy values are
stacked).  Shuffling draws from other generators by design, so it is
held by its properties: every pass is a permutation of the indices, a
fresh one each pass, and ``random.seed`` (or an explicit generator)
repeats it.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu_torch import random, recordio
from incubator_mxnet_tpu_torch.gluon import Trainer, data


def _np(batch):
    if isinstance(batch, (tuple, list)):
        return [_np(b) for b in batch]
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return batch.asnumpy()


def _same_batches(got, want):
    got, want = [_np(b) for b in got], [_np(b) for b in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = (g, w) if isinstance(g, list) else ([g], [w])
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_sequential_and_filter_samplers_match_jax():
    assert list(data.SequentialSampler(7, start=3)) == list(
        jdata.SequentialSampler(7, start=3))
    assert len(data.SequentialSampler(7)) == 7
    ds = list(range(20))
    f, jf = (m.FilterSampler(lambda v: v % 3 == 1, ds) for m in (data, jdata))
    assert list(f) == list(jf) and len(f) == len(jf)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("n,bs", [(10, 3), (12, 4), (5, 8)])
def test_batch_sampler_matches_jax(last_batch, n, bs):
    ours = data.BatchSampler(data.SequentialSampler(n), bs, last_batch)
    theirs = jdata.BatchSampler(jdata.SequentialSampler(n), bs, last_batch)
    for _ in range(3):          # rollover carries a short batch over
        assert len(ours) == len(theirs)
        assert list(ours) == list(theirs)


def test_batch_sampler_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="last_batch"):
        data.BatchSampler(data.SequentialSampler(4), 2, "pad")


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_matches_jax_without_shuffle(last_batch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((11, 1, 4, 4)).astype(np.float32)
    y = rng.integers(0, 10, 11).astype(np.float32)
    ours = data.DataLoader(data.ArrayDataset(x, y), batch_size=4,
                           last_batch=last_batch)
    theirs = jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=4,
                              last_batch=last_batch)
    for _ in range(2):
        assert len(ours) == len(theirs)
        got = list(ours)
        _same_batches(got, list(theirs))
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for b in got for t in b)


def test_dataloader_batchify_narrows_float64_and_stacks_tensors():
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    ours = list(data.DataLoader(data.SimpleDataset(list(x)), batch_size=4))
    theirs = list(jdata.DataLoader(jdata.SimpleDataset(list(x)),
                                   batch_size=4))
    _same_batches(ours, theirs)
    assert ours[0].dtype == torch.float32
    t = [torch.full((3,), float(i)) for i in range(5)]
    (batch,) = list(data.DataLoader(t, batch_size=5))
    assert torch.equal(batch, torch.stack(t))


def test_dataloader_with_batch_sampler_and_batchify_fn():
    x = np.arange(10, dtype=np.float32)
    sampler = [[0, 5], [9], [2, 3, 4]]
    ours = list(data.DataLoader(data.ArrayDataset(x), batch_sampler=sampler,
                                batchify_fn=lambda s: float(sum(s))))
    theirs = list(jdata.DataLoader(jdata.ArrayDataset(x),
                                   batch_sampler=sampler,
                                   batchify_fn=lambda s: float(sum(s))))
    assert ours == theirs == [5.0, 9.0, 9.0]
    with pytest.raises(ValueError, match="batch_sampler"):
        data.DataLoader(x, batch_size=2, batch_sampler=sampler)
    with pytest.raises(ValueError, match="batch_size"):
        data.DataLoader(x)


def test_datasets_and_transforms_match_jax():
    x = np.arange(8, dtype=np.float32)
    y = np.arange(8, dtype=np.float32) * 10
    for lazy in (True, False):
        ours = data.ArrayDataset(x, y).transform(lambda a, b: (a + b, b),
                                                 lazy)
        theirs = jdata.ArrayDataset(x, y).transform(lambda a, b: (a + b, b),
                                                    lazy)
        assert [ours[i] for i in range(8)] == [theirs[i] for i in range(8)]
        ours = data.ArrayDataset(x, y).transform_first(lambda a: -a, lazy)
        theirs = jdata.ArrayDataset(x, y).transform_first(lambda a: -a, lazy)
        assert [ours[i] for i in range(8)] == [theirs[i] for i in range(8)]
    ds, jds = data.SimpleDataset(list(range(10))), jdata.SimpleDataset(
        list(range(10)))
    for name, args in (("filter", (lambda v: v > 6,)), ("take", (3,)),
                       ("shard", (3, 1))):
        a, b = getattr(ds, name)(*args), getattr(jds, name)(*args)
        assert [a[i] for i in range(len(a))] == [b[i] for i in range(len(b))]
    single = data.ArrayDataset(x)
    assert len(single) == 8 and single[3] == x[3]
    with pytest.raises(ValueError, match="length"):
        data.ArrayDataset(x, y[:3])


def test_shuffle_is_a_fresh_permutation_repeated_by_seed():
    n = 50
    random.seed(11)
    sampler = data.RandomSampler(n)
    first, second = list(sampler), list(sampler)
    assert sorted(first) == sorted(second) == list(range(n))
    assert first != second
    random.seed(11)
    assert list(sampler) == first
    g = torch.Generator().manual_seed(5)
    explicit = data.RandomSampler(n, generator=g)
    a = list(explicit)
    g.manual_seed(5)
    assert list(explicit) == a and sorted(a) == list(range(n))
    x = np.arange(n, dtype=np.float32)
    random.seed(3)
    loader = data.DataLoader(data.ArrayDataset(x), batch_size=8,
                             shuffle=True, last_batch="discard")
    seen = torch.cat(list(loader)).tolist()
    assert len(seen) == 48 and len(set(seen)) == 48
    random.seed(3)
    assert torch.cat(list(loader)).tolist() == seen


def test_what_is_not_ported_yet_raises():
    # the image codec is ported; encoding on the card is not (nvJPEG's
    # encoder): a tensor off the CPU raises, naming it
    with pytest.raises(NotImplementedError, match="not ported"):
        recordio.pack_img(recordio.IRHeader(0, 0.0, 0, 0),
                          torch.empty((2, 2, 3), dtype=torch.uint8,
                                      device="meta"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer([torch.zeros(2, requires_grad=True)], "sgd", elastic=True)
