"""The chunked training loop: K fused train steps a dispatch
(counterpart of ``incubator_mxnet_tpu/fuse_loop.py``).

The fused step (``fuse.py``) makes a step one CUDA graph replay; the
loop still pays Python, a launch and a loss handle once a step.
:class:`ChunkedTrainLoop` runs K steps a dispatch.  On the card, the
first chunk of a block shape runs its K steps eagerly (they train, and
count as steps), then all K steps are captured into ONE
``torch.cuda.CUDAGraph`` with a static ``(K, batch, ...)`` input; later
chunks copy their block into that input and replay.  The K losses
accumulate in float32 on the card, and each chunk's record holds their
mean as a device tensor: the loop never waits for the card.  On the CPU
the K steps run eagerly.

The loop shares the step's state (``params``, ``aux``, ``opt_state``),
so tail steps, ``write_back`` and checkpoints see one state.  A replay
advances the random generators as K per-step replays do (``fuse.py``),
so a block with Dropout draws the same masks chunked or one step at a
time.  The batches come in through a
:class:`~.gluon.data.dataloader.DevicePrefetchRing`; the tail of an
epoch that does not fill a chunk runs through the per-step graph,
never a second, shorter loop graph.

Not ported yet: the JAX package's ``train.chunk`` and ``prefetch.*``
trace spans (ROADMAP §A item 7, with ``trace.py``).
"""
from __future__ import annotations

import torch

from .base import resolve_chunk_steps as _resolve_chunk_steps
from .fuse import capturing, kernel_launches
from .gluon.data.dataloader import DevicePrefetchRing

__all__ = ["ChunkedTrainLoop"]


class _LoopGraph:
    """One block shape's K-step graph and its static tensors."""

    def __init__(self, graph, xs, ys, loss, losses):
        self.graph, self.xs, self.ys = graph, xs, ys
        self.loss, self.losses = loss, losses


class ChunkedTrainLoop:
    """K fused train steps a dispatch.

    Usage::

        step = make_fused_train_step(net, loss_fn, "sgd", opt_params,
                                     chunk_steps=16)
        loop = step.chunked_loop()          # or ChunkedTrainLoop(step)
        for epoch in range(epochs):
            records = loop.run_epoch(batches)   # iterable of (x, y)
        step.write_back()

    ``chunk_steps == 1`` is the per-step fused path exactly: no loop
    graph is built, so the default (``MXNET_TRAIN_CHUNK_STEPS=1``) is
    bit for bit the per-step run."""

    def __init__(self, step, chunk_steps=None):
        self.step = step
        self.chunk_steps = _resolve_chunk_steps(
            chunk_steps if chunk_steps is not None else step.chunk_steps)
        self.chunks_run = 0
        self.tail_steps_run = 0
        self._graphs: dict[tuple, _LoopGraph] = {}
        #: the K losses of the last chunk (a float32 device tensor)
        self.last_losses = None
        #: kernel launches recorded in each K-step capture, by block key
        self.capture_launches: dict[tuple, dict[str, int]] = {}
        #: the ring of the last :meth:`run_epoch` (its ``wait_s``)
        self.ring = None

    @property
    def compile_count(self):
        """K-step graphs captured: one per (K, block shape) driven."""
        return len(self._graphs)

    @property
    def steps_run(self):
        return self.chunks_run * self.chunk_steps + self.tail_steps_run

    def _eager_chunk(self, xs, ys):
        """The K steps, one after another, on the step's state → the
        per-step mean loss, summed in float32 on the device, and the K
        losses."""
        losses = [self.step.step_fn(xs[i], ys[i]).float()
                  for i in range(self.chunk_steps)]
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        return total / self.chunk_steps, torch.stack(losses)

    def run_chunk(self, xs, ys):
        """One chunk of K steps: ``xs``/``ys`` are blocks shaped ``(K,
        batch, ...)``.  Returns the chunk's mean loss, a float32 device
        tensor (not synchronised); ``last_losses`` holds its K losses."""
        if self.chunk_steps == 1:
            raise RuntimeError(
                "chunk_steps == 1 has no loop program; drive the "
                "per-step FusedTrainStep (run_epoch does this for you)")
        if xs.shape[0] != self.chunk_steps:
            raise ValueError(
                f"block carries {xs.shape[0]} steps, loop compiled for "
                f"chunks of {self.chunk_steps}")
        s = self.step
        xs, ys = xs.to(s.device), ys.to(s.device)
        s._begin()
        if s.device.type != "cuda":
            loss, losses = self._eager_chunk(xs, ys)
        else:
            key = (tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype)
            cap = self._graphs.get(key)
            if cap is None:
                loss, losses = self._warm_up_and_capture(key, xs, ys)
            else:
                cap.xs.copy_(xs)
                cap.ys.copy_(ys)
                cap.graph.replay()
                loss, losses = cap.loss.clone(), cap.losses.clone()
        s._publish()
        self.chunks_run += 1
        self.last_losses = losses
        return loss

    def _warm_up_and_capture(self, key, xs, ys):
        """This chunk's K steps, run eagerly on a side stream, then all K
        captured (not run) into one CUDA graph for later chunks."""
        dev = self.step.device
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss, losses = self._eager_chunk(xs, ys)
        current.wait_stream(side)
        loss, losses = loss.clone(), losses.clone()
        static_xs, static_ys = xs.clone(), ys.clone()
        graph = self.step.new_graph()
        before = kernel_launches()
        with capturing(graph):
            static = self._eager_chunk(static_xs, static_ys)
        after = kernel_launches()
        self.capture_launches[key] = {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]}
        self._graphs[key] = _LoopGraph(graph, static_xs, static_ys, *static)
        return loss, losses

    def run_epoch(self, batches, on_chunk=None):
        """Run one epoch: ``batches`` (an iterable of ``(x, y)`` pairs; a
        DataLoader works as is) grouped into K-step blocks by a
        :class:`DevicePrefetchRing` on the step's device, a chunk for
        each, and the tail that does not fill a chunk through the
        per-step path.  ``on_chunk(record)`` runs at every chunk
        boundary (after the tail too): the place to checkpoint.
        Returns the records ``[{"steps", "loss", "kind", "losses"},
        ...]``, where ``loss`` is the per-step mean over the record's
        steps and ``losses`` its steps' losses, device tensors (the JAX
        records have no ``losses``)."""
        records = []
        if self.chunk_steps == 1:
            for x, y in batches:
                loss = self.step(x, y)
                self.tail_steps_run += 1
                rec = {"steps": 1, "loss": loss, "kind": "step",
                       "losses": loss.float().reshape(1)}
                records.append(rec)
                if on_chunk is not None:
                    on_chunk(rec)
            return records
        self.ring = DevicePrefetchRing(batches, self.chunk_steps,
                                       device=self.step.device)
        for block in self.ring:
            if block[0] == "chunk":
                _, xs, ys = block
                rec = {"steps": self.chunk_steps,
                       "loss": self.run_chunk(xs, ys), "kind": "chunk",
                       "losses": self.last_losses}
            else:
                tail = block[1]
                losses = []
                for x, y in tail:
                    losses.append(self.step(x, y))
                    self.tail_steps_run += 1
                total = losses[0]
                for loss in losses[1:]:
                    total = total + loss
                rec = {"steps": len(tail), "loss": total / len(tail),
                       "kind": "tail",
                       "losses": torch.stack(losses).float()}
            records.append(rec)
            if on_chunk is not None:
                on_chunk(rec)
        return records

    def write_back(self):
        self.step.write_back()
