"""``hybridize()``'s compiled forward: one CUDA graph per call signature
(counterpart of ``CachedOp`` in ``incubator_mxnet_tpu/gluon/block.py``
and of ``TraceCache`` in ``incubator_mxnet_tpu/executor_cache.py``).

The JAX package compiles a hybridized block into one XLA program per
signature.  Here the outermost hybridized block's forward is captured
into one ``torch.cuda.CUDAGraph`` per signature, and a later call with
that signature copies its inputs into the graph's static inputs and
replays it: one launch for the forward instead of hundreds.

A signature is the inputs' shapes, dtypes and device,
``autograd.is_training()``, ``torch.is_inference_mode_enabled()``, and
the shapes, dtypes and storage of the block's parameters and buffers:
a parameter that was replaced or recast (``cast``, ``amp.convert_block``,
``quantize_net``'s swap) gets a graph of its own, never a stale one.  A
value written into a parameter in place (``load_parameters``,
``initialize``) is read by the graph as it is.

A new signature runs the call once eagerly on a side stream (the
warm-up: kernels are built, libraries initialised; its result is the
call's) and then captures one forward, which the capture does not run.
Each replay hands out copies of the graph's outputs, so a result a
caller holds keeps its values after the next call.  BatchNorm's moving
statistics update in a replay under ``autograd.train_mode()`` as in an
eager call (``register_state_update`` copies in place, which the graph
keeps), and random blocks draw fresh numbers each replay (the blocks'
private CUDA generators are registered with each graph, as
``FusedTrainStep``'s are).
"""
from __future__ import annotations

import threading

import torch
from torch.nn.parameter import UninitializedParameter
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import autograd

__all__ = ["TraceCache", "CachedOp"]


class TraceCache:
    """A keyed cache with a lock and hit/miss counters.
    :meth:`get_or_create` is atomic: two threads racing on one key build
    it once."""

    def __init__(self, name):
        self.name = name
        self._d: dict = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get_or_create(self, key, factory):
        """``(entry, hit)``; ``factory()`` runs under the lock on a
        miss."""
        with self._lock:
            entry = self._d.get(key)
            if entry is not None:
                self.hits += 1
                return entry, True
            self.misses += 1
            entry = self._d[key] = factory()
            return entry, False

    def clear(self):
        with self._lock:
            n = len(self._d)
            self._d.clear()
        return n

    def evict(self, stale):
        """Drop every entry whose key ``stale(key)`` calls stale."""
        with self._lock:
            for key in [k for k in self._d if stale(k)]:
                del self._d[key]

    def __len__(self):
        with self._lock:
            return len(self._d)

    def stats(self):
        with self._lock:
            return {"entries": len(self._d), "hits": self.hits,
                    "misses": self.misses}


class _Graph:
    """One signature's graph, its static inputs and outputs."""

    def __init__(self, graph, inputs, outputs, spec):
        self.graph, self.inputs, self.outputs, self.spec = (graph, inputs,
                                                            outputs, spec)
        self.lock = threading.Lock()
        self.done = None          # an event after the last replay's copies


def _leaves(mod, out):
    """The parameters and buffers of ``mod`` and every module under it, in
    one walk (``None`` slots included)."""
    out.extend(mod._parameters.values())
    out.extend(mod._buffers.values())
    for child in mod._modules.values():
        if child is not None:
            _leaves(child, out)
    return out


class CachedOp:
    """The compiled forward of one hybridized block: ``captures`` counts
    the graphs captured, ``replays`` the replays.  ``static_alloc`` and
    ``static_shape`` are recorded as the JAX package takes them; a graph
    holds its buffers already, so they change nothing else."""

    def __init__(self, block, static_alloc=False, static_shape=False):
        self.block = block
        self.static_alloc = bool(static_alloc)
        self.static_shape = bool(static_shape)
        self._cache = TraceCache(f"cachedop:{type(block).__name__}")
        self.captures = 0
        self.replays = 0

    def __deepcopy__(self, memo):
        # a copy of the block compiles afresh: graphs are not copied
        from copy import deepcopy
        return CachedOp(deepcopy(self.block, memo), self.static_alloc,
                        self.static_shape)

    def __getstate__(self):
        return {"block": self.block, "static_alloc": self.static_alloc,
                "static_shape": self.static_shape}

    def __setstate__(self, state):
        self.__init__(**state)

    def state(self):
        """The storage, dtype and shape of every parameter and buffer of
        the block, or None while a parameter is still deferred (the call
        then runs eagerly and gives it its shape)."""
        out = []
        for t in _leaves(self.block, []):
            if t is None:
                continue
            if isinstance(t, UninitializedParameter):
                return None
            out.append((t.data_ptr(), t.dtype, t.shape))
        return tuple(out)

    @staticmethod
    def signature(inputs, state):
        """``(inputs, modes, state)``: see the module docstring."""
        return (tuple((x.shape, x.dtype, x.device) for x in inputs),
                (autograd.is_training(), torch.is_inference_mode_enabled()),
                state)

    def stats(self):
        return dict(self._cache.stats(), captures=self.captures,
                    replays=self.replays)

    def __call__(self, inputs, state):
        """The block's forward on ``inputs`` by its signature's graph;
        ``state`` is :meth:`state`."""
        first = []
        sig = self.signature(inputs, state)

        def build():
            # graphs of parameters the block no longer holds are stale:
            # free their memory
            self._cache.evict(lambda key: key[2] != sig[2])
            return self._warm_up_and_capture(inputs, first)

        entry, hit = self._cache.get_or_create(sig, build)
        if not hit:
            return first[0]
        return self._replay(entry, inputs)

    def _run(self, inputs):
        with torch.no_grad():
            return self.block.forward(*inputs)

    def _warm_up_and_capture(self, inputs, first):
        """This call's forward, run eagerly on a side stream, then one
        forward captured (not run) into a graph for later calls."""
        from ..fuse import _generators, capturing
        device = inputs[0].device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._run(inputs)
        current.wait_stream(side)
        flat, spec = tree_flatten(out)
        first.append(tree_unflatten([t.clone() if isinstance(
            t, torch.Tensor) else t for t in flat], spec))
        static_in = [x.clone() for x in inputs]
        graph = torch.cuda.CUDAGraph()
        for gen in _generators(self.block):
            graph.register_generator_state(gen)
        with capturing(graph):
            static_out = self._run(static_in)
        flat, spec = tree_flatten(static_out)
        if not all(isinstance(t, torch.Tensor) for t in flat):
            raise TypeError(f"hybridized {type(self.block).__name__} returns "
                            "something other than tensors")
        self.captures += 1
        return _Graph(graph, static_in, flat, spec)

    def _replay(self, entry, inputs):
        current = torch.cuda.current_stream(inputs[0].device)
        with entry.lock:
            if entry.done is not None:
                current.wait_event(entry.done)
            for dst, src in zip(entry.inputs, inputs):
                dst.copy_(src)
            entry.graph.replay()
            outs = [t.clone() for t in entry.outputs]
            entry.done = torch.cuda.Event()
            entry.done.record(current)
            self.replays += 1
        return tree_unflatten(outs, entry.spec)
