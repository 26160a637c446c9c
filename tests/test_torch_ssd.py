"""The port's SSD (``models/ssd.py``) against the JAX package's, on the
CPU, at the JAX suite's size: ``SSD(num_classes=2, sizes=((0.3, 0.4),
(0.6, 0.7)), ratios=((1, 2),) * 2, base_channels=8)`` on 2x3x32x32
images (771 anchors: a 16x16 map and the global max pool's 1x1, three
anchors a pixel).

The JAX model's weights (deferred until its first forward) are carried
across with ``params_from_jax``; inputs come from numpy.  Tolerances
(float32): anchors bit for bit; cls_preds, box_preds, location targets
and detections 1e-5 absolute (values up to about 10, sums of 72-216
products in another order); class targets and masks equal (the data
have no near-tie at the mining cut-off: ``test_torch_contrib_det.py``
states the rule); the loss 1e-5 relative.  Three Adam steps (lr 5e-3,
BatchNorm in training mode) against the hybridized JAX model: each
step's loss 1e-5 relative; every gradient max|d| <= 1e-4 of its tensor's
largest |JAX| value at the first step and 5e-4 later (the weights then
differ by Adam's updates of near-zero gradients, a small fraction of
lr); after each step the update of every weight whose gradient stayed
above 1e-2 of its tensor's largest within 1e-2·lr, and every weight
within 2·lr.  The convolution biases in front of a BatchNorm
(``stage0.0.bias``, ``stage0.3.bias``) get a gradient that is 0 in exact
arithmetic, since BatchNorm subtracts the batch mean: in both packages
it is rounding noise (below 1e-4 of the convolution weight's largest
gradient), which Adam turns into steps of up to lr in either direction.
They are held to that bound, each step's move to lr, and the moving
means, which absorb them, to (1 - momentum) times the biases' summed
difference.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.ssd import SSD as JaxSSD
from incubator_mxnet_tpu.models.ssd import SSDLoss as JaxSSDLoss

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                               params_from_jax,
                                               params_to_numpy)
from incubator_mxnet_tpu_torch.error import DeviceUnavailableError
from incubator_mxnet_tpu_torch.examples import train_ssd
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.models import SSD, SSDLoss, ssd_300

KW = dict(num_classes=2, sizes=((0.3, 0.4), (0.6, 0.7)),
          ratios=((1, 2),) * 2, base_channels=8)
LR = 5e-3
PRE_BN_BIASES = ("stage0.0.bias", "stage0.3.bias")
LABELS = np.array([[[0, .1, .1, .45, .45]], [[1, .5, .5, .95, .95]]],
                  np.float32)


@pytest.fixture(scope="module")
def models():
    """The JAX model after one forward (its deferred weights fixed), its
    weights by name, and a port model carrying them."""
    mx.random.seed(0)
    jnet = JaxSSD(**KW)
    jnet.initialize()
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jnet(nd.array(x))
    named = {k: p.data().asnumpy().copy()
             for k, p in jnet.collect_params().items()}
    return jnet, named, x


def _port(named):
    net = SSD(**KW)
    net.initialize(device="cpu")
    params_from_jax(named, net)
    return net


def _close(got, want, atol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.asnumpy() if hasattr(want, "asnumpy") else want
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, (what, err)


def test_parameter_names_match_jax(models):
    jnet, named, _ = models
    net = _port(named)
    assert sorted(net.collect_params()) == sorted(named)
    assert "stage1.weight" not in named           # the global max pool
    assert [k for k in named if k.startswith("stage0.1.")] == [
        "stage0.1.gamma", "stage0.1.beta", "stage0.1.running_mean",
        "stage0.1.running_var"]


def test_forward_targets_loss_and_detections_match_jax(models):
    """Predict mode: anchors, cls_preds, box_preds; the targets with hard
    negative mining; the loss; the detections (softmax + decode + NMS)."""
    jnet, named, x = models
    net = _port(named)
    ja, jc, jb = jnet(nd.array(x))
    with autograd.pause():
        a, c, b = net(torch.from_numpy(x))
    assert a.shape == (1, 771, 4) and c.shape == (2, 3, 771)
    assert b.shape == (2, 771 * 4)
    np.testing.assert_array_equal(a.numpy(), ja.asnumpy())
    _close(c, jc, what="cls_preds")
    _close(b, jb, what="box_preds")
    labels = nd.array(LABELS)
    jt = jnet.targets(ja, labels, jc)
    t = net.targets(a, torch.from_numpy(LABELS), c)
    _close(t[0], jt[0], what="loc_target")
    np.testing.assert_array_equal(t[1].numpy(), jt[1].asnumpy())
    np.testing.assert_array_equal(t[2].numpy(), jt[2].asnumpy())
    assert (t[2].numpy() == -1).any() and (t[2].numpy() > 0).any()
    jloss = JaxSSDLoss()(jc, jb, jt[2], jt[0], jt[1]).asnumpy()
    loss = SSDLoss()(c, b, t[2], t[0], t[1]).numpy()
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    det = net.detections(c, b, a)
    jdet = jnet.detections(jc, jb, ja).asnumpy()
    assert not det.requires_grad and det.shape == (2, 771, 6)
    np.testing.assert_array_equal(det.numpy()[..., 0], jdet[..., 0])
    _close(det, jdet, what="detections")


def _jax_step(jnet, x, labels):
    with jax_autograd.record():
        anchors, cls_preds, box_preds = jnet(nd.array(x))
        loc_t, loc_m, cls_t = jnet.targets(anchors, nd.array(labels),
                                           cls_preds)
        loss = JaxSSDLoss()(cls_preds, box_preds, cls_t, loc_t, loc_m)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in jnet.collect_params().items()
             if p.grad_req != "null"}
    return loss.asnumpy(), grads


def _port_step(net, x, labels):
    with autograd.record():
        anchors, cls_preds, box_preds = net(torch.from_numpy(x))
        loc_t, loc_m, cls_t = net.targets(anchors, torch.from_numpy(labels),
                                          cls_preds)
        loss = SSDLoss()(cls_preds, box_preds, cls_t, loc_t, loc_m)
    autograd.backward(loss)
    return loss.detach().numpy(), grads_to_numpy(net)


def _named(jnet):
    return {k: p.data().asnumpy().copy()
            for k, p in jnet.collect_params().items()}


def test_three_adam_steps_match_jax(models):
    """Three Adam steps, BatchNorm in training mode, the JAX model
    hybridized: losses, gradients, updates, weights and moving
    statistics, by the rules of the module docstring."""
    _, named, x = models
    jnet = JaxSSD(**KW)
    jnet.initialize()
    jnet(nd.array(x))
    for k, p in jnet.collect_params().items():
        p.set_data(nd.array(named[k]))
    jnet.hybridize()
    net = _port(named)
    jtrainer = jax_gluon.Trainer(jnet.collect_params(), "adam",
                                 {"learning_rate": LR})
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": LR})
    steady, drift = None, 0.0
    for step in range(3):
        jloss, jgrads = _jax_step(jnet, x, LABELS)
        loss, grads = _port_step(net, x, LABELS)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        tol = 1e-4 if step == 0 else 5e-4
        for k, jg in jgrads.items():
            if k in PRE_BN_BIASES:
                wscale = np.abs(jgrads[k.replace("bias", "weight")]).max()
                for g in (grads[k], jg):
                    assert np.abs(g).max() <= 1e-4 * wscale, (k, step)
                continue
            _close(grads[k], jg, tol * np.abs(jg).max(), f"grad {k} {step}")
        assert not np.abs(grads["cls0.weight"]).max() == 0
        large = {k: np.abs(g) > 1e-2 * np.abs(g).max()
                 for k, g in jgrads.items() if k not in PRE_BN_BIASES}
        steady = large if steady is None else {
            k: steady[k] & large[k] for k in large}
        jbefore, before = _named(jnet), params_to_numpy(net)
        drift += 0.1 * max(np.abs(before[k] - jbefore[k]).max()
                           for k in PRE_BN_BIASES)
        jtrainer.step(2)
        trainer.step(2)
        jafter, after = _named(jnet), params_to_numpy(net)
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        for k, mask in steady.items():
            d = np.abs((after[k] - before[k]) - (jafter[k] - jbefore[k]))
            if mask.any():
                assert d[mask].max() <= 1e-2 * LR, (k, step, d[mask].max())
            assert np.abs(after[k] - jafter[k]).max() <= 2 * LR, (k, step)
        for k in PRE_BN_BIASES:
            for a, b in ((after, before), (jafter, jbefore)):
                assert np.abs(a[k] - b[k]).max() <= 1.01 * LR, (k, step)
        for k in jafter:
            if k.endswith("running_var"):
                _close(state[k], jafter[k], what=f"{k} {step}")
            elif k.endswith("running_mean"):
                _close(state[k], jafter[k], drift + 1e-5, f"{k} {step}")
    assert sum(int(m.sum()) for m in steady.values()) > 500


def test_overfits_tiny_batch():
    """The JAX suite's ``test_ssd_overfits_tiny_batch`` on the port: 40
    Adam steps on two images halve the loss, and image 0's best
    detection is its box's class (0) within 0.1 of the box."""
    torch.manual_seed(0)
    net = SSD(**KW)
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    labels = torch.from_numpy(LABELS)
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": LR})
    losses = []
    for _ in range(40):
        with autograd.record():
            anchors, cls_preds, box_preds = net(x)
            loc_t, loc_m, cls_t = net.targets(anchors, labels, cls_preds)
            loss = SSDLoss()(cls_preds, box_preds, cls_t, loc_t, loc_m)
        autograd.backward(loss)
        trainer.step(2)
        losses.append(loss.mean().item())
    assert losses[-1] < 0.5 * losses[0], losses
    det = net.detections(cls_preds, box_preds, anchors).numpy()[0]
    top = det[det[:, 1] > 0.5]
    assert len(top) >= 1 and top[0][0] == 0
    np.testing.assert_allclose(top[0][2:], [.1, .1, .45, .45], atol=0.1)


def test_example_smoke(capsys):
    out = train_ssd.main(["--smoke", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "loss " in printed and "detections on image 0:" in printed
    losses = out["losses"]
    assert len(losses) == 25 and np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses
    assert out["detections"].shape == (2, 771, 6)


def test_ssd_300_shapes_without_running_it():
    """``ssd_300()``: five scales, 4 anchors a pixel, 21 class outputs;
    its 300x300 forward is left to the card (``chip_smoke.py`` phase 14)."""
    net = ssd_300()
    assert net.num_classes == 20 and len(net.sizes) == 5
    assert net.cls0._channels == 4 * 21 and net.box4._channels == 16
    assert [getattr(net, f"stage{i}")[0]._channels for i in range(4)] == [
        16, 32, 64, 64]


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        SSD(**KW).initialize()
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        train_ssd.main(["--smoke"])
