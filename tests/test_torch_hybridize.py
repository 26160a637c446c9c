"""``HybridBlock.hybridize()`` (``gluon/block.py``, ``gluon/_cached_op.py``)
on the CPU.  The graphs themselves need the card
(``tests/test_torch_cuda.py``); here:

* the JAX contract's flags: only the outermost block compiles, its
  children are deactivated, ``active=False`` turns it off, a new call
  drops the graphs, ``static_alloc``/``static_shape`` are recorded;
* on CPU tensors a hybridized block runs eagerly: the same logits as
  unhybridized, and as the hybridized JAX net on the same weights
  (within ZOO_TOL = 1e-5 of the largest |JAX| logit, the zoo tests'
  bound: the same products summed in another order);
* what a signature holds: the parameters' storage, dtype and shape (a
  cast or replaced parameter changes it, an in-place write does not),
  train and inference mode; None while a parameter is deferred;
* the signature cache builds once under racing threads and counts hits
  and misses; a deep copy of a hybridized block compiles afresh;
* ``quantize_net`` de-hybridizes; ``fuse_conv_bn`` changes the
  signature, so no graph of the unfolded layers can replay;
* ``benchmark_score`` hybridizes its nets, and scores them eagerly
  when ``score`` is told to.
"""
import copy
import pickle
import threading
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from incubator_mxnet_tpu.ndarray.ndarray import NDArray

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.contrib.quantization import quantize_net
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.gluon import contrib, nn
from incubator_mxnet_tpu_torch.gluon._cached_op import CachedOp, TraceCache
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet

ZOO_TOL = 1e-5


def _thumb():
    return resnet.ResNetV1(resnet.BottleneckV1, [1], [16, 64], classes=4,
                           thumbnail=True)


def _net(x):
    net = _thumb()
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net(torch.tensor(x))
    return net


def _x(batch=2):
    return np.random.RandomState(0).rand(batch, 3, 16, 16).astype(np.float32)


def test_hybridize_flags_follow_the_jax_contract():
    net = _net(_x())
    net.features.hybridize()
    assert net.features._active
    assert net.hybridize(static_alloc=True, static_shape=True) is net
    assert net._active and net._flags == {"static_alloc": True,
                                          "static_shape": True}
    assert not any(m._active for m in net.modules() if m is not net)
    op = net._get_cached_op()
    assert op.static_alloc and op.static_shape
    net.hybridize()                       # a new call drops the graphs
    assert net._cached_op is None and net._flags["static_alloc"] is False
    net.hybridize(active=False)
    assert not net._active


def test_hybridized_block_on_the_cpu_runs_eagerly_like_jax():
    x = _x()
    net = _net(x)
    with torch.no_grad():
        eager = net(torch.tensor(x)).numpy()
        net.hybridize()
        got = net(torch.tensor(x)).numpy()
    assert net._cached_op is None        # no graph on the CPU
    np.testing.assert_array_equal(got, eager)
    jnet = jresnet.ResNetV1(jresnet.BottleneckV1, [1], [16, 64], classes=4,
                            thumbnail=True)
    jnet.initialize(ctx=mx.cpu())
    for k, p in jnet.collect_params().items():
        arr = net.collect_params()[k].detach().numpy()
        p.shape = arr.shape
        p._data = NDArray(jnp.asarray(arr), ctx=mx.cpu())
        p._deferred_init_args = None
    jnet.hybridize()
    want = jnet(jnd.array(x)).asnumpy()
    assert np.abs(got - want).max() <= ZOO_TOL * np.abs(want).max()
    # and back: the JAX weights into a fresh hybridized port net
    net2 = _thumb()
    net2.initialize(device="cpu")
    net2.hybridize()
    params_from_jax({k: p.data().asnumpy()
                     for k, p in jnet.collect_params().items()}, net2)
    with torch.no_grad():
        np.testing.assert_array_equal(net2(torch.tensor(x)).numpy(), got)


def test_signature_holds_storage_dtype_shape_and_modes():
    net = nn.HybridSequential()
    net.add(nn.Dense(5), nn.BatchNorm())
    net.initialize(device="cpu")
    op = CachedOp(net)
    assert op.state() is None            # deferred: the call runs eagerly
    with torch.no_grad():
        net(torch.zeros(2, 3))
    state = op.state()
    assert state is not None and len(state) == 6
    with torch.no_grad():
        net[0].weight.copy_(torch.ones(5, 3))      # in place: same state
    assert op.state() == state
    x = [torch.zeros(2, 3)]
    sig = op.signature(x, state)
    with autograd.train_mode():
        assert op.signature(x, state) != sig
    with torch.inference_mode():
        assert op.signature(x, state) != sig
    assert op.signature([torch.zeros(4, 3)], state) != sig
    net[0].weight.data = net[0].weight.data.clone()  # replaced storage
    assert op.state() != state
    state = op.state()
    net.cast("float64")
    assert op.state() != state


def test_trace_cache_builds_once_under_racing_threads():
    cache = TraceCache("t")
    built = []
    barrier = threading.Barrier(8)

    def factory():
        built.append(1)
        return object()

    def race():
        barrier.wait()
        cache.get_or_create("k", factory)

    threads = [threading.Thread(target=race) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(built) == 1
    assert cache.stats() == {"entries": 1, "hits": 7, "misses": 1}
    cache.get_or_create("j", object)
    cache.evict(lambda key: key == "k")
    assert len(cache) == 1 and cache.clear() == 1 and len(cache) == 0


def test_copies_of_a_hybridized_block_compile_afresh():
    net = _net(_x())
    net.hybridize(static_alloc=True)
    op = net._get_cached_op()
    twin = copy.deepcopy(net)
    assert twin._cached_op is not op and twin._cached_op.block is twin
    assert twin._cached_op.static_alloc and twin._active
    again = pickle.loads(pickle.dumps(net))
    assert again._cached_op.block is again


def test_quantize_net_dehybridizes_and_fuse_changes_the_signature():
    x = _x()
    net = _net(x)
    net.hybridize()
    op = net._get_cached_op()
    before = op.state()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert contrib.fuse_conv_bn(net) > 0
    assert op.state() != before
    net.hybridize()
    quantize_net(net, calib_data=[x])
    assert not any(getattr(m, "_active", False) for m in net.modules())
    assert net._cached_op is None
    net.hybridize()
    with torch.no_grad():
        out = net(torch.tensor(x))
    assert out.shape == (2, 4) and torch.isfinite(out).all()


_SCORE_ARGS = dict(model_name="resnet18_v1", batch_size=1,
                   image_shape=(3, 32, 32), dtype="float32", steps=1,
                   warmup=0, device="cpu")


@pytest.mark.parametrize("hybridize", [True, False])
def test_benchmark_score_hybridizes_unless_told(hybridize, monkeypatch):
    from incubator_mxnet_tpu_torch.examples import benchmark_score
    built = []
    factory = benchmark_score.vision.resnet18_v1

    def spy(**kw):
        built.append(factory(**kw))
        return built[-1]

    monkeypatch.setattr(benchmark_score.vision, "resnet18_v1", spy)
    if hybridize:                    # the script's path: main() hybridizes
        benchmark_score.main(
            ["--models", "resnet18_v1", "--batch-sizes", "1",
             "--image-shape", "3,32,32", "--dtype", "float32", "--steps",
             "1", "--warmup", "0", "--device", "cpu"])
    else:                            # phase 18 (e)'s eager scores
        assert benchmark_score.score(**_SCORE_ARGS, hybridize=False) > 0
    assert len(built) == 1 and built[0]._active is hybridize
