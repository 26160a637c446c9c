"""Data iterators (counterpart of ``incubator_mxnet_tpu/io/__init__.py``;
reference ``python/mxnet/io/`` and ``src/io/``).

The batch-iterator protocol is the JAX package's: a :class:`DataIter`
yields :class:`DataBatch` objects (``data``, ``label``, ``pad``) and
describes them by ``provide_data``/``provide_label``.  Arrays are
``torch.Tensor``s on the iterator's ``device``, ``cuda:0`` unless the
caller passes ``device="cpu"``.

:class:`ImageRecordIter` takes the place of the JAX package's
``NativeImageRecordIter`` (``src/image_iter.cc``, a C++ pipeline of
libjpeg decode threads on the host).  On the card it reads and parses
the records on a host thread, decodes JPEG records with nvJPEG and
copies raw ``b"MXTR"`` records from pinned memory on a side stream,
then
assembles the batch with one launch of the ``image_batch`` kernel
(resize, crop, mirror, normalize; ``ops/image_batch.py``); an event
hands the batch to the consumer's stream.  On the CPU it decodes with
cv2 or PIL and runs the kernel's plain version.  Either way each value
is the native iterator's, bit for bit, for the same decoded pixels and
crops.  Unlike the native iterator, its crops, mirrors and order come
from numpy generators seeded by ``seed`` (per epoch and batch), so a
run repeats; the native iterator draws its crops from
``std::random_device`` and shuffles with ``mt19937_64``.
"""
from __future__ import annotations

import os
import queue
import struct
import threading

import numpy as np
import torch

from .. import random as _random
from ..context import resolve_device

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "NativeImageRecordIter", "MXDataIter", "LibSVMIter"]


class DataDesc:
    def __init__(self, name, shape, dtype="float32", layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"


class DataBatch:
    def __init__(self, data=None, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator (reference ``io/io.py:179``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        raise StopIteration

    def __next__(self):
        return self.next()

    @property
    def provide_data(self):
        return []

    @property
    def provide_label(self):
        return []


def _no_extra(name, kwargs):
    if kwargs:
        raise TypeError(f"{name}: unknown arguments {sorted(kwargs)}")


class NDArrayIter(DataIter):
    """Batches of dense arrays (reference ``io/io.py:490``).  The last
    batch is padded from the start (``"pad"``) or dropped
    (``"discard"``); ``shuffle`` reorders at each :meth:`reset` with
    ``rng`` (a ``numpy.random.RandomState``, :data:`random.np_rng` by
    default)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", device=None, rng=None):
        super().__init__(batch_size)
        self.device = resolve_device(device)
        self.data = self._init_data(data, data_name)
        self.label = self._init_data(label, label_name) \
            if label is not None else []
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._rng = rng
        self.cursor = -batch_size
        self._order = np.arange(self.num_data)
        self.reset()

    @staticmethod
    def _init_data(data, default_name):
        if data is None:
            return []
        if isinstance(data, (np.ndarray, torch.Tensor)):
            data = [(default_name, data)]
        elif isinstance(data, dict):
            data = list(data.items())
        elif isinstance(data, (list, tuple)):
            data = [(f"{default_name}_{i}" if i else default_name, d)
                    for i, d in enumerate(data)]
        out = []
        for name, d in data:
            if isinstance(d, torch.Tensor):
                d = d.detach().cpu().numpy()
            d = np.asarray(d)
            if d.dtype == np.float64:
                d = d.astype(np.float32)
            out.append((name, d))
        return out

    @property
    def provide_data(self):
        return [DataDesc(name, (self.batch_size,) + d.shape[1:],
                         d.dtype.name) for name, d in self.data]

    @property
    def provide_label(self):
        return [DataDesc(name, (self.batch_size,) + d.shape[1:],
                         d.dtype.name) for name, d in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            (self._rng or _random.np_rng).shuffle(self._order)

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        lo = self.cursor
        hi = min(lo + self.batch_size, self.num_data)
        pad = self.batch_size - (hi - lo)
        idx = self._order[lo:hi]
        if pad:
            if self.last_batch_handle == "discard":
                raise StopIteration
            idx = np.concatenate([idx, self._order[:pad]])

        def take(arrays):
            return [torch.as_tensor(d[idx], device=self.device)
                    for _, d in arrays]

        return DataBatch(data=take(self.data), label=take(self.label),
                         pad=pad, index=idx, provide_data=self.provide_data,
                         provide_label=self.provide_label)


class ResizeIter(DataIter):
    """A fixed number of batches of another iterator, reset and read
    again when it runs out (reference ``io.py ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label


class PrefetchingIter(DataIter):
    """Reads one iterator's batches ahead on a background thread
    (reference ``io.py PrefetchingIter``), at most 4 in flight."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, list):
            iters = [iters]
        if len(iters) != 1:
            raise ValueError("PrefetchingIter: one backing iterator only")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._queue = queue.Queue(maxsize=4)
        self._stop = False
        self._thread = None
        self._start()

    def _start(self):
        def worker():
            while not self._stop:
                try:
                    batch = self.iter.next()
                except StopIteration:
                    self._queue.put(None)
                    return
                except Exception as e:  # handed to the consumer
                    self._queue.put(e)
                    return
                self._queue.put(batch)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop = True
        if self._thread is not None:
            while self._thread.is_alive():
                while not self._queue.empty():
                    self._queue.get_nowait()
                self._thread.join(timeout=0.05)
        while not self._queue.empty():
            self._queue.get_nowait()
        self.iter.reset()
        self._stop = False
        self._start()

    def next(self):
        batch = self._queue.get()
        if batch is None:
            self._queue.put(None)    # every later call ends too
            raise StopIteration
        if isinstance(batch, Exception):
            raise batch
        return batch

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label


class _InnerIter(DataIter):
    """An iterator that hands every call to an :class:`NDArrayIter`."""

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class CSVIter(_InnerIter):
    """Batches of the rows of a CSV file (reference
    ``src/io/iter_csv.cc``); labels from ``label_csv``, else zeros."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, device=None, **kwargs):
        _no_extra("CSVIter", kwargs)
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0], 1), np.float32)
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="pad" if round_batch
                                  else "discard", device=device)


class MNISTIter(_InnerIter):
    """MNIST batches (reference ``src/io/iter_mnist.cc``): the
    ``gluon.data.vision.MNIST`` set (its seeded synthetic stand-in when
    the files are absent), scaled to [0, 1], NCHW or ``flat``.  ``label``
    and ``input_shape`` are accepted and unused, as in the JAX
    package."""

    def __init__(self, image="train-images-idx3-ubyte", label=None,
                 batch_size=128, shuffle=True, flat=False, input_shape=None,
                 device=None, rng=None, **kwargs):
        _no_extra("MNISTIter", kwargs)
        super().__init__(batch_size)
        from ..gluon.data.vision import MNIST
        ds = MNIST(train="train" in image)
        data = ds._data.numpy().astype(np.float32) / 255.0
        data = data.transpose(0, 3, 1, 2)
        if flat:
            data = data.reshape(data.shape[0], -1)
        self._inner = NDArrayIter(data, ds._label.astype(np.float32),
                                  batch_size, shuffle=shuffle, device=device,
                                  rng=rng)


class LibSVMIter(DataIter):
    """Batches of LibSVM text rows, ``label idx:val ...`` with 0-based
    indices (reference ``src/io/iter_libsvm.cc``).  The port has no
    sparse arrays yet (ROADMAP §A item 12, ``ndarray/sparse.py``): the
    data comes as dense (B, num_col) float32 rows where the JAX package
    gives a CSR array, and ``label_libsvm`` raises.  With
    ``round_batch`` the last batch wraps to the start and ``pad``
    counts the wrapped rows; else it is short."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=None, round_batch=True,
                 device=None, **kwargs):
        _no_extra("LibSVMIter", kwargs)
        if label_libsvm is not None:
            raise NotImplementedError(
                "LibSVMIter: label_libsvm needs sparse arrays, which are not "
                "ported yet (ROADMAP §A item 12, ndarray/sparse.py)")
        super().__init__(batch_size)
        self.device = resolve_device(device)
        self._data_shape = tuple(data_shape)
        self._num_col = int(self._data_shape[-1])
        self._round_batch = round_batch
        self._rows, self._labels = self._parse(data_libsvm)
        self._label_shape = tuple(label_shape) if label_shape else ()
        self._cursor = 0

    @staticmethod
    def _parse(path):
        rows, labels = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                rows.append([(int(k), float(v)) for k, v in
                             (p.split(":") for p in parts[1:])])
        return rows, labels

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_col))]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label",
                         (self.batch_size,) + self._label_shape)]

    def reset(self):
        self._cursor = 0

    def next(self):
        n = len(self._rows)
        if self._cursor >= n:
            raise StopIteration
        idxs = list(range(self._cursor, min(self._cursor + self.batch_size,
                                            n)))
        pad = self.batch_size - len(idxs)
        if pad and self._round_batch:
            idxs += [i % n for i in range(pad)]
        else:
            pad = 0
        self._cursor += self.batch_size
        dense = np.zeros((len(idxs), self._num_col), np.float32)
        for r, i in enumerate(idxs):
            for k, v in self._rows[i]:
                dense[r, k] = v
        lab = np.asarray([self._labels[i] for i in idxs], np.float32)
        return DataBatch(data=[torch.as_tensor(dense, device=self.device)],
                         label=[torch.as_tensor(lab, device=self.device)],
                         pad=pad)


# ---------------------------------------------------------------------------
# ImageRecordIter
# ---------------------------------------------------------------------------

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1


def _record_offsets(path):
    """The offset of every record's first part in a RecordIO file (the
    native iterator's ``IndexFile``)."""
    offsets = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            f.seek(pos)
            header = f.read(8)
            if len(header) < 8:
                break
            magic, lrec = struct.unpack("<II", header)
            if magic != _MAGIC:
                break
            length, cflag = lrec & _LEN_MASK, (lrec >> 29) & 7
            if cflag in (0, 1):
                offsets.append(pos)
            pos += 8 + length + (4 - (length & 3)) % 4
    return offsets


class _Sample:
    """One slot's parsed record: its labels, and its image as raw HWC
    bytes or JPEG bytes with the image's size."""

    __slots__ = ("labels", "raw", "jpeg", "h", "w")


def _parse_record(payload, label_width, device_type):
    """A record's payload → :class:`_Sample` (``ProcessSample``'s header,
    label and image checks)."""
    from .. import image
    from ..ops import jpeg_decode
    if len(payload) < 24:
        raise ValueError("record too short")
    flag, label0 = struct.unpack("<If", payload[:8])
    s = _Sample()
    s.labels = np.zeros(label_width, np.float32)
    img_off = 24
    if flag == 0:
        s.labels[0] = label0
    else:
        if len(payload) < 24 + 4 * flag:
            raise ValueError("record labels truncated")
        k = min(flag, label_width)
        s.labels[:k] = np.frombuffer(payload, np.float32, count=k, offset=24)
        img_off += 4 * flag
    img = payload[img_off:]
    s.raw = s.jpeg = None
    if len(img) >= 12 and img[:4] == b"MXTR":
        h, w = struct.unpack("<ii", img[4:12])
        if h <= 0 or w <= 0 or len(img) < 12 + 3 * h * w:
            raise ValueError("raw record geometry mismatch")
        s.raw = np.frombuffer(img, np.uint8, count=3 * h * w, offset=12)
    elif device_type == "cuda":
        jpeg_decode.check_jpeg(img)
        h, w, _ = jpeg_decode.jpeg_size(img)
        s.jpeg = img
    else:
        dec = image.imdecode_np(img, 1)
        h, w = dec.shape[:2]
        s.raw = np.ascontiguousarray(dec).reshape(-1)
    s.h, s.w = h, w
    return s


class _Batch:
    __slots__ = ("data", "label", "count", "event")


class ImageRecordIter(DataIter):
    """Image batches from a RecordIO file of JPEG or raw ``b"MXTR"``
    records (reference ``src/io/iter_image_recordio_2.cc``), with the
    native iterator's arguments and semantics
    (``src/image_iter.cc``):

    * ``resize`` > 0 resizes the short side to it (the long side by
      ``lround`` of the aspect), 0 resizes straight to the output size;
      then each side is at least the output's;
    * the crop is centred, or drawn when ``rand_crop``; ``rand_mirror``
      flips half the samples; each value is ``(px - mean) * scale /
      std`` (a std or scale that is not positive counts as 1), or the
      grey sum first for ``data_shape[0] == 1``;
    * ``label_width`` labels a sample (a record with a label array
      gives its first ``label_width``; the rest stay 0);
    * ``round_batch`` fills the last batch from the start of the epoch,
      else leaves its tail zero; ``pad`` counts the slots that are not
      new samples either way;
    * ``shuffle`` permutes the records at every :meth:`reset`.

    ``data`` is (B, C, H, W) float32 and ``label`` (B,) or (B,
    label_width) float32, both on ``device`` (``cuda:0`` unless given).
    ``prefetch_buffer`` batches are made ahead on a host thread; 0 makes
    each batch in :meth:`next` (the native iterator reads 0 as 4).
    ``seed`` fixes the order, crops and mirrors of every epoch.
    On the CPU ``preprocess_threads`` host threads decode a batch's
    JPEGs with cv2/PIL (0: one a core, at most 8, as the native iterator
    takes one a core); on the card nvJPEG decodes them on the producer
    thread.  Unknown keyword arguments raise (the JAX
    package's Python path ignores them)."""

    def __init__(self, path_imgrec, data_shape=(3, 224, 224), batch_size=128,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, scale=1.0, resize=0, round_batch=True,
                 preprocess_threads=0, prefetch_buffer=4, seed=0,
                 label_width=1, data_name="data", label_name="softmax_label",
                 device=None, **kwargs):
        _no_extra("ImageRecordIter", kwargs)
        super().__init__(batch_size)
        self.device = resolve_device(device)
        c, h, w = (int(v) for v in data_shape)
        if c not in (1, 3):
            raise ValueError("channels must be 1 or 3")
        self._shape = (batch_size, c, h, w)
        self._path = path_imgrec
        self._offsets = _record_offsets(path_imgrec)
        if not self._offsets:
            raise RuntimeError("no records found in imgrec file")
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._mean = (mean_r, mean_g, mean_b)
        self._std = (std_r, std_g, std_b)
        self._scale = scale
        self._resize = resize
        self._round_batch = round_batch
        # nvJPEG decodes on the producer thread: more host threads do not
        # make the iterator faster (scripts/torch_jpeg_threads.py)
        self._threads = 1 if self.device.type == "cuda" else (
            int(preprocess_threads) if preprocess_threads > 0
            else min(8, os.cpu_count() or 1))
        self._pool = None
        self._prefetch = max(0, int(prefetch_buffer))
        self._seed = int(seed)
        self._label_width = max(1, int(label_width))
        self._data_name = data_name
        self._label_name = label_name
        self._total = -(-len(self._offsets) // batch_size)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._epoch = -1
        self._producer = None
        self.reset()

    @property
    def num_samples(self):
        return len(self._offsets)

    @property
    def provide_data(self):
        return [DataDesc(self._data_name, self._shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self._label_width == 1
                 else (self.batch_size, self._label_width))
        return [DataDesc(self._label_name, shape)]

    def _rng(self, *key):
        seed = [self._seed % 2**32, self._seed >> 32 & 0xffffffff, *key]
        return np.random.RandomState(np.array(seed, np.uint32))

    def reset(self):
        self._stop_producer()
        self._epoch += 1
        n = len(self._offsets)
        self._order = (self._rng(self._epoch).permutation(n)
                       if self._shuffle else np.arange(n))
        self._next_batch = 0
        if self._prefetch > 0:
            stop = threading.Event()
            q = queue.Queue(maxsize=self._prefetch)
            t = threading.Thread(target=self._produce,
                                 args=(self._epoch, self._order, q, stop),
                                 daemon=True)
            self._producer = (t, q, stop)
            t.start()

    def _stop_producer(self):
        if self._producer is None:
            return
        t, q, stop = self._producer
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)
        self._producer = None

    def __del__(self):
        try:
            self._stop_producer()
            if self._pool is not None:
                self._pool.shutdown(wait=False)
        except Exception:  # interpreter shutdown: the threads are daemons
            pass

    def _map(self, fn, items):
        """``fn`` over ``items`` in order, on the CPU path's decode
        threads where it has more than one."""
        if self._threads <= 1 or len(items) <= 1:
            return [fn(i) for i in items]
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(self._threads,
                                            thread_name_prefix="imgdecode")
        return list(self._pool.map(fn, items))

    def _produce(self, epoch, order, q, stop):
        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        from .. import recordio
        reader = recordio.MXRecordIO(self._path, "r")
        try:
            for b in range(self._total):
                if stop.is_set():
                    return
                try:
                    item = self._make_batch(reader, epoch, order, b)
                except Exception as e:  # handed to the consumer
                    put(e)
                    return
                if not put(item):
                    return
            put(None)
        finally:
            reader.close()

    def _slots(self, order, b):
        n = len(order)
        begin = b * self.batch_size
        count = min(begin + self.batch_size, n) - begin
        fill = self.batch_size if self._round_batch else count
        return [order[(begin + s) % n] for s in range(fill)], count

    def _make_batch(self, reader, epoch, order, b):
        from ..ops import image_batch as ib
        samples_idx, count = self._slots(order, b)
        payloads = []
        for i in samples_idx:
            reader._seek(self._offsets[i])
            payloads.append(reader.read())
        dtype = self.device.type
        samples = self._map(
            lambda p: _parse_record(p, self._label_width, dtype), payloads)
        bsz, c, height, width = self._shape
        rng = self._rng(epoch, b)
        table = np.zeros((bsz, 8), np.int64)
        labels = np.zeros((bsz, self._label_width), np.float32)
        offset = 0
        for slot, s in enumerate(samples):
            rh, rw = ib.resized_size(s.h, s.w, height, width, self._resize)
            if self._rand_crop:
                y0 = rng.randint(0, rh - height + 1) if rh > height else 0
                x0 = rng.randint(0, rw - width + 1) if rw > width else 0
            else:
                y0, x0 = (rh - height) // 2, (rw - width) // 2
            mirror = bool(self._rand_mirror and rng.randint(0, 2))
            table[slot] = ib.sample_row(offset, s.h, s.w, rh, rw, y0, x0,
                                        mirror)
            labels[slot] = s.labels
            offset += 3 * s.h * s.w
        staging = np.empty(offset, np.uint8)
        raw = False
        for slot, s in enumerate(samples):
            if s.raw is not None:
                o = table[slot, 0]
                staging[o:o + s.raw.size] = s.raw
                raw = True
        batch = _Batch()
        batch.count = count
        if self.device.type == "cpu":
            batch.data = ib.image_batch(torch.from_numpy(staging),
                                        torch.from_numpy(table), self._shape,
                                        self._mean, self._std, self._scale)
            batch.label = torch.from_numpy(labels)
            batch.event = None
            return batch
        from ..ops import jpeg_decode
        dev = self.device
        with torch.cuda.device(dev), torch.cuda.stream(self._stream):
            packed = torch.empty(offset, dtype=torch.uint8, device=dev)
            if raw:
                packed.copy_(torch.from_numpy(staging).pin_memory(),
                             non_blocking=True)
            for slot, s in enumerate(samples):
                if s.jpeg is not None:   # on the same stream, after the copy
                    o = int(table[slot, 0])
                    jpeg_decode.decode_into(
                        s.jpeg, packed[o:o + 3 * s.h * s.w], (s.h, s.w))
            table_d = torch.from_numpy(table).pin_memory().to(
                dev, non_blocking=True)
            batch.data = ib.image_batch(packed, table_d, self._shape,
                                        self._mean, self._std, self._scale)
            batch.label = torch.from_numpy(labels).pin_memory().to(
                dev, non_blocking=True)
            batch.event = torch.cuda.Event()
            batch.event.record(self._stream)
        return batch

    def next(self):
        if self._prefetch > 0:
            _, q, _ = self._producer
            batch = q.get()
            if batch is None:
                q.put(None)       # every later call ends too
                raise StopIteration
            if isinstance(batch, Exception):
                q.put(batch)
                raise batch
        else:
            if self._next_batch >= self._total:
                raise StopIteration
            from .. import recordio
            reader = recordio.MXRecordIO(self._path, "r")
            try:
                batch = self._make_batch(reader, self._epoch, self._order,
                                         self._next_batch)
            finally:
                reader.close()
            self._next_batch += 1
        if batch.event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(batch.event)
            batch.data.record_stream(consumer)
            batch.label.record_stream(consumer)
        label = batch.label[:, 0] if self._label_width == 1 else batch.label
        return DataBatch(data=[batch.data], label=[label],
                         pad=self.batch_size - batch.count,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


NativeImageRecordIter = ImageRecordIter
MXDataIter = ImageRecordIter
