"""Asynchronous checkpoints of a training state (counterpart of
``incubator_mxnet_tpu/checkpoint.py``, its one-process part).

``save(step, tree)`` takes a copy of every tensor of ``tree`` (a flat
``{name: tensor}``; numpy arrays and numbers too) before it returns: on
the card a device-to-device copy on the current stream, so the fused
step's in-place updates (``fuse.py``) after ``save`` cannot reach the
snapshot.  A writer thread then moves the copies to the host and writes
them, one step at a time, in the JAX package's layout:

* ``step_%08d.tmp/`` while it writes, renamed to ``step_%08d/`` at the
  end (a torn save is never published);
* one ``.npy`` per tensor, its name with every character outside
  ``[A-Za-z0-9_.-]`` replaced by ``_``;
* ``index.json`` last: ``{"step", "nprocs": 1, "params": {name:
  {"shape", "dtype", "file", "crc32"}}}``.

numpy has no bfloat16: a bfloat16 tensor is written as the JAX package
writes one, a 2-byte void ``.npy`` whose dtype in ``index.json`` is
``"bfloat16"``, and read back through a 16-bit integer view.  So each
package restores the other's files.

``restore`` returns ``{name: CPU tensor}`` in each recorded dtype (the
JAX package returns numpy arrays, which cannot hold bfloat16).  Every
file's CRC32 is checked; ``restore()`` without a step falls back to the
newest step that loads, an explicit step is strict.  A failed write is
kept and raised as ``CheckpointWriteError`` at the next ``save`` or
``wait``.

Not ported yet: multi-process shards and ``reshard_restore`` (ROADMAP
§A item 11), and the ``checkpoint.write``/``checkpoint.read`` fault
points and flight-recorder records (item 7).
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from .error import CheckpointCorruptError, CheckpointWriteError

__all__ = ["AsyncCheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_(\d+)\.tmp$")

_log = logging.getLogger(__name__)


def _crc_of(host) -> int:
    """CRC32 of an array's payload bytes, recorded in the index and
    checked at load."""
    return zlib.crc32(np.ascontiguousarray(host).tobytes()) & 0xFFFFFFFF


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def _snapshot(v):
    """A copy of a leaf that later in-place updates cannot reach."""
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    return np.array(v)


def _to_host(v):
    """``(numpy array to write, dtype name for the index)``; bfloat16 as
    2-byte void items."""
    if not isinstance(v, torch.Tensor):
        return v, str(v.dtype)
    v = v.cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view("V2"), "bfloat16"
    host = v.numpy()
    return host, str(host.dtype)


def _save(path, host, dtype):
    """``np.save``, but a bfloat16 array's header says ``'<V2'``, as
    numpy writes an ``ml_dtypes.bfloat16`` array (the JAX package's)."""
    if dtype != "bfloat16":
        np.save(path, host)
        return
    header = np.lib.format.header_data_from_array_1_0(host)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(host).tobytes())


def _from_host(block, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(block).view(np.int16).copy()).view(
                torch.bfloat16)
    want = np.dtype(dtype)
    if block.dtype != want and block.dtype.kind == "V":
        block = block.view(want)
    return torch.from_numpy(np.array(block, dtype=want, copy=True))


class AsyncCheckpointManager:
    """Checkpoints of one process in ``directory``, the newest ``keep``
    kept.

    Usage::

        ckpt = AsyncCheckpointManager(dir, keep=3)
        ckpt.save(step, {"w": w, "m": m})   # returns after the copy
        ...
        ckpt.wait()                          # until the write is durable
        tree = ckpt.restore()                # newest: name -> CPU tensor
    """

    _TMP_STALE_S = 15 * 60

    def __init__(self, directory, keep=5):
        self.directory = str(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)
        self._thread = None
        self._error = None
        self._cleanup_stale_tmp()

    def _cleanup_stale_tmp(self):
        """Remove ``step_N.tmp`` staging directories of a crashed save:
        those whose newest file is older than ``_TMP_STALE_S`` (a live
        writer of another manager keeps touching its own)."""
        now = time.time()
        for entry in os.listdir(self.directory):
            if not _TMP_RE.match(entry):
                continue
            p = os.path.join(self.directory, entry)
            try:
                newest = max([os.path.getmtime(p)]
                             + [os.path.getmtime(os.path.join(p, f))
                                for f in os.listdir(p)])
            except OSError:
                continue
            if now - newest > self._TMP_STALE_S:
                _log.warning("checkpoint: removing stale staging dir %s "
                             "(crashed save, idle %.0fs)", entry,
                             now - newest)
                shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------- save
    def save(self, step, tree, wait=False):
        """Snapshot ``tree`` at ``step``: the copies are taken before this
        returns; the writer thread moves them to the host and writes
        them.  One save is in flight at a time (this waits for the
        previous one, and raises its error)."""
        self.wait()
        flat = {str(k): _snapshot(v) for k, v in tree.items()}
        event = None
        devices = {t.device for t in flat.values()
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
        if devices:
            # the writer thread's stream must see the copies finished
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(next(iter(devices))))
        self._thread = threading.Thread(
            target=self._write, args=(int(step), flat, event), daemon=True)
        self._thread.start()
        if wait:
            self.wait()

    def _write(self, step, flat, event):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        try:
            if event is not None:
                event.synchronize()
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            index = {}
            for name, arr in flat.items():
                fn = f"{_safe(name)}.npy"
                host, dtype = _to_host(arr)
                _save(os.path.join(tmp, fn), host, dtype)
                index[name] = {"shape": list(host.shape), "dtype": dtype,
                               "file": fn, "crc32": _crc_of(host)}
            # the index is written last: it marks the step complete
            with open(os.path.join(tmp, "index.json"), "w") as f:
                json.dump({"step": step, "nprocs": 1, "params": index}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException as e:  # mxlint: allow-broad-except(kept and raised at the next wait or save)
            self._error = e
            shutil.rmtree(tmp, ignore_errors=True)
            return
        try:
            self._prune()   # the step is durable: a failed prune is not
        except OSError:
            pass

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------- inspection
    def wait(self):
        """Block until the save in flight is durable; a writer failure is
        raised here as :class:`~.error.CheckpointWriteError`."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointWriteError(
                f"async checkpoint write failed: {type(err).__name__}: "
                f"{err}") from err

    def all_steps(self):
        out = []
        for entry in os.listdir(self.directory):
            m = _STEP_RE.match(entry)
            if m and os.path.exists(os.path.join(self.directory, entry,
                                                 "index.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---------------------------------------------------------- restore
    def restore(self, step=None):
        """A checkpoint as ``{name: CPU tensor}``, each in its recorded
        dtype.  Every file's CRC32 is checked: a mismatch, a truncated
        file or a torn index raises
        :class:`~.error.CheckpointCorruptError`.  With ``step=None`` the
        newest step that loads wins (damaged ones are logged and
        skipped); an explicit ``step`` is strict, and a missing one
        raises ``FileNotFoundError``."""
        if step is not None:
            return self._restore_step(step)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_err = None
        for s in reversed(steps):
            try:
                return self._restore_step(s)
            except CheckpointCorruptError as e:
                _log.warning("checkpoint step %d is damaged (%s); falling "
                             "back to the previous one", s, e)
                last_err = e
        raise CheckpointCorruptError(
            f"no valid checkpoint in {self.directory}: all of steps "
            f"{steps} failed verification") from last_err

    def _restore_step(self, step):
        d = os.path.join(self.directory, f"step_{int(step):08d}")
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"no checkpoint for step {step} in {self.directory}")
        try:
            with open(os.path.join(d, "index.json")) as f:
                index = json.load(f)["params"]
            return {name: self._read(d, meta, step, name)
                    for name, meta in index.items()}
        except CheckpointCorruptError:
            raise
        except (OSError, ValueError, EOFError, KeyError) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step} failed to load: "
                f"{type(e).__name__}: {e}") from e

    @staticmethod
    def _read(d, meta, step, name):
        block = np.load(os.path.join(d, meta["file"]))
        want = meta.get("crc32")
        if want is not None and _crc_of(block) != want:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: CRC mismatch for {name!r} "
                f"({meta['file']}): recorded {want:#010x}, file has "
                f"{_crc_of(block):#010x} (bit rot or a torn write)")
        return _from_host(block, meta["dtype"])
