"""Post-training int8 quantization (counterpart of
``incubator_mxnet_tpu/contrib/quantization.py``; reference
python/mxnet/contrib/quantization.py and calibrate.cc).

The JAX package's flow: (1) run calibration batches through the float
net and collect each quantizable layer's input statistics, (2) pick a
range per layer by ``calib_mode``: ``"naive"`` (min and max) or
``"entropy"`` (the KL-optimal clip of a growing histogram), (3) swap each
``Dense``/``Conv2D`` for a layer that quantizes its input, runs the int8
product with int32 sums and dequantizes.  On the card each swapped layer
runs three hand-written kernels (``ops/int8_conv.py``): quantize, the
int8 product, dequantize.  They are separate passes over the data, where
the JAX package's compiled graph lets XLA fuse the glue around the
product.

The numpy calibration code is the JAX package's, kept here.  Each
hooked input is read back to the host (one synchronisation a layer a
calibration batch on the card), as the JAX collector's ``asnumpy()``
does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ops import nn_ops
from ..ops import quantization_ops as qops

__all__ = ["quantize_net", "CalibrationCollector", "optimal_threshold_kl",
           "QuantizedDense", "QuantizedConv2D"]


def optimal_threshold_kl(arr, num_bins=8001, num_quantized_bins=255):
    """KL-divergence-optimal |threshold| for int8 clipping (reference
    calibrate.cc LogKL, the TensorRT-style search)."""
    arr = np.abs(np.asarray(arr, dtype=np.float64).ravel())
    amax = float(arr.max()) if arr.size else 0.0
    if amax <= 0:
        return 1e-8
    hist, edges = np.histogram(arr, bins=num_bins, range=(0, amax))
    best_div, best_t = np.inf, amax
    # the candidate thresholds sweep the upper part of the histogram
    for i in range(num_quantized_bins, num_bins + 1,
                   max((num_bins - num_quantized_bins) // 64, 1)):
        t = edges[i] if i < len(edges) else amax
        sliced = hist[:i].astype(np.float64)
        p = sliced.copy()
        p[-1] += hist[i:].sum()       # the clipped mass stays in p
        if p.sum() == 0:
            continue
        # q approximates the unclipped slice with num_quantized_bins
        # levels: the tail mass in p but not in q penalizes a small t
        factor = i / num_quantized_bins
        idx = np.minimum((np.arange(i) / factor).astype(np.int64),
                         num_quantized_bins - 1)
        # bincount sums each bin in input order, as np.add.at does
        q_small = np.bincount(idx, weights=sliced, minlength=num_quantized_bins)
        counts = np.bincount(idx, weights=(sliced > 0).astype(np.float64),
                             minlength=num_quantized_bins)
        q = np.zeros(i)
        nz = counts[idx] > 0
        safe = np.maximum(counts[idx], 1.0)
        q[nz] = (q_small[idx] / safe)[nz]
        p_n = p / p.sum()
        qs = q.sum()
        if qs == 0:
            continue
        q_n = q / qs
        mask = p_n > 0
        div = float(np.sum(p_n[mask] * np.log(p_n[mask] /
                                              np.maximum(q_n[mask], 1e-12))))
        if div < best_div:
            best_div, best_t = div, t
    return float(best_t)


class CalibrationCollector:
    """Per-layer activation statistics over the calibration batches
    (reference _LayerOutputMinMaxCollector / _LayerHistogramCollector).

    ``"entropy"`` mode keeps a symmetric histogram a layer, not the raw
    values.  Its range starts at twice the first batch's largest |value|
    and grows when a later batch exceeds it: the counts so far are
    rebinned by bin centre into the wider histogram, so a degenerate
    first batch cannot freeze the range."""

    def __init__(self, mode="naive", num_bins=8001):
        assert mode in ("naive", "entropy")
        self.mode = mode
        self.num_bins = num_bins if num_bins % 2 == 1 else num_bins + 1
        self.minmax: dict = {}
        self.hists: dict = {}
        self.edges: dict = {}

    def collect(self, name, arr):
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr)
        lo, hi = float(a.min()), float(a.max())
        if name in self.minmax:
            plo, phi = self.minmax[name]
            self.minmax[name] = (min(lo, plo), max(hi, phi))
        else:
            self.minmax[name] = (lo, hi)
        if self.mode == "entropy":
            amax = max(abs(lo), abs(hi), 1e-8) * 2.0
            if name not in self.hists:
                self.edges[name] = np.linspace(-amax, amax,
                                               self.num_bins + 1)
                self.hists[name] = np.zeros(self.num_bins, np.float64)
            elif amax > self.edges[name][-1]:
                # widen, and rebin the counts so far by old bin centre
                old_edges, old_hist = self.edges[name], self.hists[name]
                new_edges = np.linspace(-amax, amax, self.num_bins + 1)
                centers = (old_edges[:-1] + old_edges[1:]) / 2.0
                self.hists[name], _ = np.histogram(
                    centers, bins=new_edges, weights=old_hist)
                self.edges[name] = new_edges
            edges = self.edges[name]
            clipped = np.clip(a.ravel(), edges[0], edges[-1])
            h, _ = np.histogram(clipped, bins=edges)
            self.hists[name] += h

    def thresholds(self, name):
        lo, hi = self.minmax[name]
        if self.mode == "entropy" and name in self.hists:
            t, _ = qops.calibrate_entropy(self.hists[name], self.edges[name])
            t = float(t)
            return (-t, t)
        return (lo, hi)


def _apply_activation(y, act):
    if act is None:
        return y
    return nn_ops.activation(y, act_type=act)


class _Quantized(HybridBlock):
    """The weight of ``fp_layer`` as int8 codes (its own min/max range,
    read to the host once) and its float bias, both buffers on the
    layer's device; the weight is kept channels-last, as the kernel reads
    it."""

    def __init__(self, fp_layer, in_range):
        super().__init__()
        w = fp_layer.weight.detach()
        wq, wmin, wmax = qops.quantize(w.float())
        if wq.dim() == 4:
            wq = wq.contiguous(memory_format=torch.channels_last)
        self.register_buffer("weight_q", wq)
        bias = fp_layer.bias
        self.register_buffer("bias_f", None if bias is None
                             else bias.detach().float().clone())
        self._wmin, self._wmax = float(wmin), float(wmax)
        self._act = fp_layer._activation
        self._in_range = tuple(float(v) for v in in_range)


class QuantizedDense(_Quantized):
    """``Dense`` replacement: int8 x int8 → int32 on the card's tensor
    cores."""

    def __init__(self, fp_layer, in_range):
        super().__init__(fp_layer, in_range)
        self._flatten = fp_layer._flatten

    def forward(self, x):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        lo, hi = self._in_range
        xq, xmin, xmax = qops.quantize(x, lo, hi)
        acc, omin, omax = qops.quantized_dense(
            xq, self.weight_q, self.bias_f, xmin, xmax, self._wmin,
            self._wmax)
        return _apply_activation(qops.dequantize(acc, omin, omax), self._act)


class QuantizedConv2D(_Quantized):
    """``Conv2D`` replacement: int8 convolution with int32 sums.  NCHW and
    one group only: the JAX layer passes NCHW dimension numbers and no
    group count whatever the layer says, so it mishandles the others
    (ROADMAP §C); this one raises."""

    def __init__(self, fp_layer, in_range):
        if fp_layer._layout != "NCHW":
            raise ValueError(f"QuantizedConv2D: layout {fp_layer._layout!r}"
                             " is not supported; quantize an NCHW net")
        if fp_layer._groups != 1:
            raise ValueError(f"QuantizedConv2D: groups={fp_layer._groups} "
                             "is not supported; the int8 convolution has "
                             "one group")
        super().__init__(fp_layer, in_range)
        self._stride = fp_layer._strides
        self._pad = fp_layer._padding
        self._dilate = fp_layer._dilation

    def forward(self, x):
        lo, hi = self._in_range
        # the codes channels-last, as the kernel reads them: no copy there
        xq, xmin, xmax = qops.quantize(x, lo, hi, channels_last=True)
        acc, omin, omax = qops.quantized_conv2d(
            xq, self.weight_q, self.bias_f, xmin, xmax, self._wmin,
            self._wmax, stride=self._stride, pad=self._pad,
            dilate=self._dilate)
        return _apply_activation(qops.dequantize(acc, omin, omax), self._act)


def _dehybridize(net):
    """Deactivate every block's hybridization and drop its graphs: a
    replay would skip the calibration hooks and run the float layers."""
    for block in net.modules():
        if isinstance(block, HybridBlock):
            block.hybridize(active=False)


def quantize_net(net, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=(),
                 num_calib_batches=None):
    """Post-training quantization of a Gluon net, in place (reference
    contrib/quantization.py:quantize_net): each ``Dense`` and ``Conv2D``
    whose structural name is not in ``exclude_layers`` is swapped for
    its int8 version, calibrated on ``calib_data`` (batches of tensors or
    arrays, moved to the net's device).  The net is de-hybridized first;
    hybridize it again after.  Returns ``net``."""
    if quantized_dtype != "int8":
        raise ValueError(f"quantized_dtype {quantized_dtype!r}: int8 is the "
                         "only one ported")
    _dehybridize(net)
    collector = CalibrationCollector(calib_mode)
    targets = []

    def walk(prefix, block):
        for name, child in list(block.named_children()):
            full = f"{prefix}{name}"
            if isinstance(child, (nn.Dense, nn.Conv2D)) \
                    and full not in exclude_layers:
                targets.append((block, name, full, child))
            walk(full + ".", child)

    walk("", net)
    if calib_data is not None:
        device = next(net.parameters()).device
        handles = [torch.nn.Module.register_forward_pre_hook(
            child, lambda mod, args, _full=full: collector.collect(
                _full, args[0]))
            for _, _, full, child in targets]
        try:
            with torch.no_grad():
                for n, batch in enumerate(calib_data, 1):
                    net(torch.as_tensor(batch).to(device))
                    if num_calib_batches is not None \
                            and n >= num_calib_batches:
                        break
        finally:
            for h in handles:
                h.remove()

    for parent, name, full, child in targets:
        in_range = collector.thresholds(full) if full in collector.minmax \
            else (-1.0, 1.0)
        q = QuantizedDense(child, in_range) if isinstance(child, nn.Dense) \
            else QuantizedConv2D(child, in_range)
        setattr(parent, name, q)
    return net

