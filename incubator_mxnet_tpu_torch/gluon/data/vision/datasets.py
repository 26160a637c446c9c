"""Vision datasets (counterpart of
``incubator_mxnet_tpu/gluon/data/vision/datasets.py``).

They read local files only, in the standard formats: nothing is
downloaded.  Where the files are absent, a dataset holds the JAX
package's seeded synthetic set instead (the same values; ``.synthetic``
is True).  Images are uint8 HWC tensors on the CPU and labels int32
numpy values; ``ImageFolderDataset`` decodes each file at read time on
its ``device`` (``cuda:0`` unless given: nvJPEG there, cv2/PIL on the
CPU).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self.synthetic = False
        self._data = None
        self._label = None
        self._get_data()

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        data = self._data[idx]
        if self._transform is not None:
            return self._transform(data, self._label[idx])
        return data, self._label[idx]

    def _synthetic(self, shape, num_classes, n):
        rng = np.random.RandomState(42 if self._train else 43)
        self._data = torch.from_numpy(
            rng.randint(0, 255, size=(n,) + shape).astype("uint8"))
        self._label = rng.randint(0, num_classes, size=(n,)).astype("int32")
        self.synthetic = True


class MNIST(_DownloadedDataset):
    """MNIST from the idx files in ``root``, if present."""

    _files = {
        True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
    }

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None, synthetic_size=512):
        self._synthetic_size = synthetic_size
        super().__init__(root, train, transform)

    def _get_data(self):
        img_f, lbl_f = self._files[self._train]
        img_path = os.path.join(self._root, img_f)
        lbl_path = os.path.join(self._root, lbl_f)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = np.frombuffer(f.read(), dtype=np.uint8).astype(
                    "int32")
            with gzip.open(img_path, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                data = np.frombuffer(f.read(), dtype=np.uint8)
                data = data.reshape(n, rows, cols, 1)
            self._data = torch.from_numpy(data.copy())
            self._label = label
        else:
            self._synthetic((28, 28, 1), 10, self._synthetic_size)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None, synthetic_size=512):
        super().__init__(root, train, transform, synthetic_size)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the binary batches under ``root``, if present."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None, synthetic_size=512):
        self._synthetic_size = synthetic_size
        super().__init__(root, train, transform)

    def _get_data(self):
        batches = [f"data_batch_{i}.bin" for i in range(1, 6)] \
            if self._train else ["test_batch.bin"]
        paths = [os.path.join(self._root, "cifar-10-batches-bin", b)
                 for b in batches]
        if all(os.path.exists(p) for p in paths):
            data, labels = [], []
            for p in paths:
                with open(p, "rb") as f:
                    raw = np.frombuffer(f.read(), dtype=np.uint8)
                raw = raw.reshape(-1, 3073)
                labels.append(raw[:, 0].astype("int32"))
                data.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
            self._data = torch.from_numpy(np.concatenate(data))
            self._label = np.concatenate(labels)
        else:
            self._synthetic((32, 32, 3), 10, self._synthetic_size)


class CIFAR100(CIFAR10):
    """CIFAR-100: always the synthetic set, as in the JAX package (which
    reads no CIFAR-100 files)."""

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 transform=None, fine_label=True, synthetic_size=512):
        self._fine = fine_label
        super().__init__(root, train, transform, synthetic_size)

    def _get_data(self):
        self._synthetic((32, 32, 3), 100, self._synthetic_size)


class ImageFolderDataset(Dataset):
    """Images in one folder per class under ``root``: sample ``i`` is
    (the decoded image, its class index), decoded on ``device``."""

    def __init__(self, root, flag=1, transform=None, device=None):
        from ....context import resolve_device
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.device = resolve_device(device)
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.items.append((os.path.join(path, fname), label))

    @property
    def decodes_on_cuda(self):
        """Whether reading a sample uses the card (process workers of a
        ``DataLoader`` must not)."""
        return self.device.type == "cuda"

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from .... import image
        fname, label = self.items[idx]
        img = image.imread(fname, self._flag, device=self.device)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
