"""Deploy/predict surface (counterpart of ``incubator_mxnet_tpu/deploy.py``).

An artifact is two files beside a prefix:

* ``{prefix}.meta.json`` — the format tag, the model factory
  (``"module:qualname"`` inside this package) and its keyword
  arguments, the input specs in the JAX package's ``"inputs"`` form
  (the example's shape, leading batch axis included, and dtype), and
  the outputs that are served (their index in the forward's outputs,
  shape and dtype);
* ``{prefix}.params.npz`` — the state dict as numpy arrays.

Unlike the JAX artifact, which is StableHLO and carries no model code,
this one rebuilds the model from its factory at load time.
"""
from __future__ import annotations

import importlib
import json

import numpy as np
import torch

from .context import resolve_device

__all__ = ["export_model", "Predictor", "load_predictor"]

FORMAT = "mxtorch_predict_v1"
_PACKAGE = __name__.rpartition(".")[0]


def _factory(spec):
    """The callable named by ``"module:qualname"``; only names inside
    this package are accepted, since the artifact is outside input."""
    module, sep, qualname = spec.partition(":")
    if not sep or not (module == _PACKAGE
                       or module.startswith(_PACKAGE + ".")):
        raise ValueError(f"model factory {spec!r} is not a "
                         f"'module:qualname' inside {_PACKAGE}")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def export_model(model, example_inputs, prefix, kwargs=None, outputs=None):
    """Write ``model``'s artifact under ``prefix``; returns the meta dict.

    ``example_inputs`` are arrays (numpy or tensors) with a leading
    batch axis; the model runs once on them, in ``eval()`` mode, to
    record the output specs.  The factory is the model's class, called
    with ``kwargs`` (default ``{}``) at load time; that it rebuilds a
    model with the same parameter names and shapes is checked here.
    ``outputs`` lists the indices of the forward's outputs to serve
    (default: all)."""
    factory = f"{type(model).__module__}:{type(model).__qualname__}"
    kwargs = dict(kwargs or {})
    with torch.device("meta"):
        shell = _factory(factory)(**kwargs)
    want = {k: tuple(v.shape) for k, v in shell.state_dict().items()}
    state = model.state_dict()
    have = {k: tuple(v.shape) for k, v in state.items()}
    if want != have:
        raise ValueError(f"{factory}(**{kwargs}) does not rebuild this "
                         "model's parameters")
    example = [x.detach().cpu().numpy() if torch.is_tensor(x)
               else np.asarray(x) for x in example_inputs]
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            outs = _as_tuple(model(*[torch.from_numpy(a).to(device)
                                     for a in example]))
    finally:
        model.train(was_training)
    served = (list(range(len(outs))) if outputs is None
              else [int(i) for i in outputs])
    np.savez(prefix + ".params.npz",
             **{k: v.detach().cpu().numpy() for k, v in state.items()})
    meta = {
        "format": FORMAT,
        "model": {"factory": factory, "kwargs": kwargs},
        "inputs": [{"shape": list(a.shape), "dtype": a.dtype.name}
                   for a in example],
        "outputs": [{"index": i, "shape": list(outs[i].shape),
                     "dtype": str(outs[i].dtype).removeprefix("torch.")}
                    for i in served],
    }
    with open(prefix + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class Predictor:
    """Loaded artifact: ``pred(*inputs) -> tuple of numpy outputs``.

    Inputs are numpy arrays with the exported instance shapes and
    dtypes under any shared leading batch size.  The model runs in
    ``eval()`` mode under ``torch.inference_mode()`` on ``device``
    (``cuda:0`` unless given; raises without CUDA)."""

    def __init__(self, prefix, device=None):
        self.device = resolve_device(device)
        with open(prefix + ".meta.json") as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"{prefix}: not a {FORMAT} artifact")
        spec = self.meta["model"]
        model = _factory(spec["factory"])(**spec["kwargs"])
        with np.load(prefix + ".params.npz", allow_pickle=False) as z:
            state = {k: torch.from_numpy(z[k]) for k in z.files}
        model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval()
        self._inputs = [(tuple(s["shape"][1:]), np.dtype(s["dtype"]))
                        for s in self.meta["inputs"]]
        self._served = [o["index"] for o in self.meta["outputs"]]

    def _check(self, inputs):
        if len(inputs) != len(self._inputs):
            raise ValueError(f"model takes {len(self._inputs)} inputs, got "
                             f"{len(inputs)}")
        arrs = [np.asarray(x) for x in inputs]
        for a, (shape, dtype) in zip(arrs, self._inputs):
            if a.ndim != len(shape) + 1 or tuple(a.shape[1:]) != shape:
                raise ValueError(f"input shape {a.shape} does not match the "
                                 f"exported instance shape {shape} under a "
                                 "leading batch axis")
            if a.dtype != dtype:
                raise ValueError(f"input dtype {a.dtype} != exported {dtype}")
        if len({a.shape[0] for a in arrs}) != 1:
            raise ValueError("all inputs must share one leading batch size")
        return arrs

    def __call__(self, *inputs):
        arrs = self._check(inputs)
        with torch.inference_mode():
            out = _as_tuple(self.model(*[
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrs]))
            return tuple(out[i].cpu().numpy() for i in self._served)

    def warmup(self, batch_sizes):
        """Run one zeros batch at each size, so that the first request
        at a size pays no one-time cost (kernel load, library
        heuristics, allocator growth)."""
        for n in batch_sizes:
            self(*[np.zeros((int(n),) + shape, dtype)
                   for shape, dtype in self._inputs])


def load_predictor(prefix, device=None):
    return Predictor(prefix, device=device)
