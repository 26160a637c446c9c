"""DataLoader and the device prefetch ring (counterpart of
``incubator_mxnet_tpu/gluon/data/dataloader.py``).

Batches are assembled on the host and yielded as CPU tensors, in the
sampler's order.  ``num_workers > 0`` loads them in the background:

* ``thread_pool=True`` (default): a pool of threads, ``prefetch``
  batches in flight; right where decoding releases the GIL (numpy,
  RecordIO reads).
* ``thread_pool=False``: forked worker processes that use numpy only
  (they never touch torch's CUDA, so forking a parent that has set up
  the card is safe) and hand each batch over through POSIX shared
  memory (``multiprocessing.shared_memory``).  The parent copies the
  batch out and unlinks the segments; segments of batches not yet
  delivered are unlinked when the consumer stops early.  Where only
  ``spawn`` exists and the dataset or batchify function cannot be
  pickled, the loader takes the thread pool, as the JAX package does,
  and says so.

:class:`DevicePrefetchRing` groups a loader's ``(x, y)`` batches into
K-step blocks for ``fuse_loop.ChunkedTrainLoop``.  On the card it stacks
each block in pinned host memory and copies it to the card on a side
stream, so the copy of the next block overlaps the current chunk.
"""
from __future__ import annotations

import logging
import queue as _queue
import time
import traceback
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...base import resolve_chunk_steps
from ...context import resolve_device
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "DevicePrefetchRing", "default_batchify_fn"]

_log = logging.getLogger(__name__)


def default_batchify_fn(data):
    """Stack samples into a batch on the host: tuples field by field,
    tensors with ``torch.stack``, numpy arrays and numbers through one
    numpy array (float64 narrowed to float32, as in the JAX package)."""
    first = data[0]
    if isinstance(first, tuple):
        return tuple(default_batchify_fn(list(s)) for s in zip(*data))
    if isinstance(first, torch.Tensor):
        return torch.stack(data, dim=0)
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


def _pin(batch):
    if isinstance(batch, tuple):
        return tuple(_pin(b) for b in batch)
    return batch.pin_memory()


# ---------------------------------------------------------------------------
# process workers: numpy-only children, batches through shared memory
# ---------------------------------------------------------------------------

def _np_batchify(data):
    """Worker-side batchify: stacks into numpy (a CUDA tensor is
    refused: workers never touch the card)."""
    if isinstance(data[0], tuple):
        return tuple(_np_batchify([s[i] for s in data])
                     for i in range(len(data[0])))
    arr = np.stack([_host_array(d) for d in data], axis=0)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def _host_array(v):
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu":
            raise TypeError(
                "process DataLoader workers use numpy only and never touch "
                f"the card; the dataset returned a tensor on {v.device} "
                "(return numpy or CPU tensors, or use thread_pool=True)")
        return v.numpy()
    return np.asarray(v)


def _tree_to_shm(tree):
    """Copy a batch (numpy arrays, tuples of them) into shared memory →
    its spec; the parent owns and unlinks the segments."""
    from multiprocessing import resource_tracker, shared_memory
    if isinstance(tree, tuple):
        return ("tuple", [_tree_to_shm(t) for t in tree])
    arr = _host_array(tree)
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
    name = shm.name
    shm.close()
    # the parent unlinks it; the worker's resource tracker must not
    try:
        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:  # mxlint: allow-broad-except(the tracker's unregister is best-effort; the parent owns the segment)
        pass
    return ("array", name, arr.shape, str(arr.dtype))


def _tree_from_shm(spec):
    """The batch of a spec as CPU tensors (copied out), its segments
    unlinked."""
    from multiprocessing import shared_memory
    if spec[0] == "tuple":
        return tuple(_tree_from_shm(s) for s in spec[1])
    _, name, shape, dtype = spec
    shm = shared_memory.SharedMemory(name=name)
    try:
        view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf)
        out = torch.from_numpy(view.copy())
    finally:
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
    return out


def _unlink_spec(spec):
    """Release the shared memory of an undelivered batch."""
    from multiprocessing import shared_memory
    if spec[0] == "tuple":
        for s in spec[1]:
            _unlink_spec(s)
        return
    try:
        shm = shared_memory.SharedMemory(name=spec[1])
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass


def _start_cpu_math():
    """Run one exp on torch's CPU threads before this process first
    forks.  With MKL (torch 2.13's CPU build), a thread that first runs
    MKL's exp after its process forked may take a less accurate kernel:
    one batch row of a small TransformerLM's attention exp came out 1e-4
    off in about a quarter of such processes, and in none after this
    call (``scripts/torch_fork_math_check.py``).  Only the first call
    does anything."""
    global _cpu_math_started
    if not _cpu_math_started:
        torch.exp(torch.zeros(1 << 20))
        _cpu_math_started = True


_cpu_math_started = False


def _worker_loop(dataset, batchify_fn, key_queue, result_queue):
    """A worker: pull ``(seq, indices)``, push ``(seq, "ok", spec)`` or
    ``(seq, "error", traceback)``; stop at None."""
    while True:
        item = key_queue.get()
        if item is None:
            return
        seq, indices = item
        try:
            batch = batchify_fn([dataset[i] for i in indices])
            result_queue.put((seq, "ok", _tree_to_shm(batch)))
        except Exception:  # mxlint: allow-broad-except(a worker's failure goes to the parent with its traceback)
            result_queue.put((seq, "error", traceback.format_exc()))


def _decodes_on_cuda(dataset):
    """Whether reading ``dataset`` (or the dataset a transform wraps)
    uses the card."""
    while dataset is not None:
        if getattr(dataset, "decodes_on_cuda", False):
            return True
        dataset = getattr(dataset, "_data", None)
    return False


class DataLoader:
    """Iterates over ``dataset`` in batches.

    ``batch_size`` with ``shuffle`` (a :class:`RandomSampler`) or
    ``sampler`` (any sampler of indices) and ``last_batch`` (``"keep"``,
    ``"discard"``, ``"rollover"``) build the :class:`BatchSampler`; or
    ``batch_sampler`` gives the index lists itself.  ``batchify_fn``
    stacks a list of samples (default :func:`default_batchify_fn`; in
    process workers a numpy stack).  ``pin_memory`` pins each batch for
    asynchronous copies to the card.  ``num_workers``, ``thread_pool``,
    ``prefetch`` (batches in flight, default ``2 * num_workers``, at
    least 1 with workers) and ``timeout`` (seconds a process worker may
    take for a batch) as in the module docstring."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True, timeout=120):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise ValueError("shuffle must be False with a sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must be unset with a batch_sampler")
        if num_workers and not thread_pool and _decodes_on_cuda(dataset):
            raise ValueError(
                "DataLoader: this dataset decodes on the card, and a forked "
                "process worker must not use CUDA; use num_workers=0 or "
                "thread workers (thread_pool=True)")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._pin_memory = pin_memory
        self._num_workers = int(num_workers)
        self._thread_pool = thread_pool
        self._timeout = timeout
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(self._num_workers, 1))
        if self._num_workers > 0:
            # with workers, prefetch=0 would submit nothing and yield an
            # empty epoch: keep at least one batch in flight
            self._prefetch = max(1, self._prefetch)

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._num_workers == 0:
            batches = (self._make_batch(i) for i in self._batch_sampler)
        elif self._thread_pool:
            batches = self._iter_threads()
        else:
            batches = self._iter_processes()
        for batch in batches:
            yield _pin(batch) if self._pin_memory else batch

    def __len__(self):
        return len(self._batch_sampler)

    def _iter_threads(self):
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            it = iter(self._batch_sampler)
            futures = deque()
            for indices in it:
                futures.append(pool.submit(self._make_batch, indices))
                if len(futures) >= self._prefetch:
                    break
            while futures:
                batch = futures.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(pool.submit(self._make_batch, nxt))
                yield batch

    def _spawn_ok(self, batchify):
        """Whether spawned workers can receive the dataset and batchify
        function (pickled once per loader)."""
        ok = getattr(self, "_spawn_picklable", None)
        if ok is None:
            import pickle
            try:
                pickle.dumps((self._dataset, batchify))
                ok = True
            except Exception as e:  # mxlint: allow-broad-except(any pickling failure means spawned workers cannot start)
                ok = False
                self._spawn_pickle_error = f"{type(e).__name__}: {e}"
            self._spawn_picklable = ok
        return ok

    def _iter_processes(self):
        """Numpy-only worker processes, batches through shared memory,
        yielded strictly in sampler order."""
        import multiprocessing as mp
        ctx = mp.get_context("fork" if "fork" in mp.get_all_start_methods()
                             else "spawn")
        batchify = (self._batchify_fn if self._batchify_fn
                    is not default_batchify_fn else _np_batchify)
        if ctx.get_start_method() == "spawn" and not self._spawn_ok(batchify):
            msg = ("process DataLoader workers need a picklable dataset and "
                   "batchify function where only spawn exists "
                   f"({self._spawn_pickle_error}); falling back to the "
                   "thread pool (module-level functions instead of lambdas "
                   "or closures restore process workers)")
            _log.warning(msg)
            warnings.warn(msg)
            yield from self._iter_threads()
            return
        _start_cpu_math()
        key_queue, result_queue = ctx.Queue(), ctx.Queue()
        workers = [ctx.Process(
            target=_worker_loop,
            args=(self._dataset, batchify, key_queue, result_queue),
            daemon=True) for _ in range(self._num_workers)]
        for w in workers:
            w.start()
        done = {}
        try:
            it = enumerate(iter(self._batch_sampler))
            sent = 0
            for item in it:
                key_queue.put(item)
                sent += 1
                if sent >= self._prefetch:
                    break
            next_seq = 0
            while next_seq < sent:
                while next_seq not in done:
                    try:
                        seq, status, payload = result_queue.get(
                            timeout=self._timeout)
                    except _queue.Empty:
                        dead = [w.pid for w in workers if not w.is_alive()]
                        raise RuntimeError(
                            f"DataLoader timed out after {self._timeout}s "
                            f"waiting for batch {next_seq}"
                            + (f"; worker pid(s) {dead} died without "
                               "reporting" if dead else
                               " (workers alive: raise `timeout` for slow "
                               "batches)")) from None
                    if status == "error":
                        raise RuntimeError(
                            f"DataLoader worker failed on batch {seq}:\n"
                            f"{payload}")
                    done[seq] = payload
                    item = next(it, None)
                    if item is not None:
                        key_queue.put(item)
                        sent += 1
                yield _tree_from_shm(done.pop(next_seq))
                next_seq += 1
        finally:
            for _ in workers:
                key_queue.put(None)
            # drain while the workers finish (a worker blocked on a full
            # pipe would not exit), then once more after they stopped:
            # what they delivered and the consumer did not take is
            # released here
            deadline = time.monotonic() + 5
            while True:
                alive = any(w.is_alive() for w in workers)
                try:
                    _, status, payload = result_queue.get(
                        timeout=0.05 if alive else 0.1)
                except (_queue.Empty, OSError, EOFError):
                    if not alive or time.monotonic() > deadline:
                        break
                    continue
                if status == "ok":
                    _unlink_spec(payload)
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=5)
            for payload in done.values():
                _unlink_spec(payload)
            for q in (key_queue, result_queue):
                q.close()
                q.cancel_join_thread()


# ---------------------------------------------------------------------------
# the device prefetch ring (fuse_loop.ChunkedTrainLoop's feed)
# ---------------------------------------------------------------------------

def _host_tensor(v):
    """A CPU tensor of a host batch (float64 narrowed to float32)."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(v)))
    return t.float() if t.dtype == torch.float64 else t


class _PinnedSlot:
    """A pinned host buffer and the event of the copy that last read it."""

    def __init__(self, shape, dtype):
        self.buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.event = None


class DevicePrefetchRing:
    """Group a loader's ``(x, y)`` batches into K-step blocks on
    ``device`` (``cuda:0`` unless given; ``"cpu"`` stacks on the host),
    ``depth`` blocks ahead of the consumer.

    Yields ``("chunk", xs, ys)`` for each full block, ``xs`` shaped
    ``(K, batch, ...)``, in order, and one final ``("tail", [(x, y),
    ...])`` when the batches do not fill the last block.

    On the card each block is stacked into a pinned host buffer and
    copied to a fresh device tensor with ``non_blocking=True`` on a side
    stream, which records an event; the consumer's stream waits on that
    event when the block is yielded, and the tensor is marked as used on
    that stream, so the allocator does not hand its memory out again
    before the consumer's work on it is done.  A pinned buffer is
    stacked into again only after the copy that read it has finished
    (``depth + 1`` buffers cycle).  Batches already on the card are
    stacked there, on the consumer's stream.  ``wait_s`` is the host
    time the consumer spent waiting in the ring (filling blocks)."""

    def __init__(self, batches, chunk_steps, depth=2, device=None):
        self.chunk_steps = resolve_chunk_steps(chunk_steps)
        self.depth = int(depth)
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        self.device = resolve_device(device)
        self._it = iter(batches)
        self.blocks = 0
        self.tail_steps = 0
        self.wait_s = 0.0
        self._slots: dict[tuple, deque] = {}
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def _slot(self, shape, dtype):
        """The least recently used pinned buffer of this shape, once the
        copy that last read it has finished."""
        ring = self._slots.setdefault((tuple(shape), dtype), deque())
        if len(ring) < self.depth + 1:
            slot = _PinnedSlot(shape, dtype)
        else:
            slot = ring.popleft()
            if slot.event is not None:
                slot.event.synchronize()
        ring.append(slot)
        return slot

    def _stack(self, arrs, copied):
        first = arrs[0]
        if isinstance(first, torch.Tensor) and first.device.type == "cuda":
            return torch.stack([a.to(first.device) for a in arrs], dim=0)
        host = [_host_tensor(a) for a in arrs]
        if self.device.type == "cpu":
            return torch.stack(host, dim=0)
        shape = (len(host),) + tuple(host[0].shape)
        slot = self._slot(shape, host[0].dtype)
        torch.stack(host, dim=0, out=slot.buf)
        with torch.cuda.stream(self._side):
            out = torch.empty(shape, dtype=slot.buf.dtype, device=self.device)
            out.copy_(slot.buf, non_blocking=True)
        copied.append(slot)
        return out

    def _next_block(self):
        pairs = []
        for pair in self._it:
            pairs.append(pair)
            if len(pairs) == self.chunk_steps:
                break
        if not pairs:
            return None
        if len(pairs) < self.chunk_steps:
            self.tail_steps = len(pairs)
            return ("tail", pairs)
        copied = []
        xs = self._stack([x for x, _ in pairs], copied)
        ys = self._stack([y for _, y in pairs], copied)
        event = None
        if copied:
            event = torch.cuda.Event()
            event.record(self._side)
            for slot in copied:
                slot.event = event
        self.blocks += 1
        return ("chunk", xs, ys, event)

    def _hand_over(self, block):
        if block[0] == "tail":
            return block
        _, xs, ys, event = block
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in (xs, ys):
                if t.device.type == "cuda":
                    t.record_stream(current)
        return ("chunk", xs, ys)

    def __iter__(self):
        q = deque()
        exhausted = False
        while True:
            t0 = time.perf_counter()
            while not exhausted and len(q) < self.depth:
                block = self._next_block()
                if block is None or block[0] == "tail":
                    exhausted = True
                if block is not None:
                    q.append(block)
            self.wait_s += time.perf_counter() - t0
            if not q:
                return
            yield self._hand_over(q.popleft())
