"""Dataset loaders (counterpart of ``hetu_tpu/data.py``), numpy-only: the
same seed gives the same arrays as ``hetu_tpu.data``.

Loads MNIST/CIFAR from the repository's ``datasets/`` directory when
present (the reference's file names); otherwise falls back to a
deterministic synthetic dataset with the same shapes and dtypes.
"""
from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "datasets")


def _find(path):
    if os.path.isabs(path) and os.path.exists(path):
        return path
    p = os.path.join(_DATA_DIR, path)
    return p if os.path.exists(p) else None


def convert_to_one_hot(vals, max_val=0):
    """One-hot encode int labels (reference data.py:212)."""
    vals = np.asarray(vals).astype(np.int64)
    if max_val == 0:
        max_val = vals.max() + 1
    one_hot = np.zeros((vals.size, max_val), dtype=np.float32)
    one_hot[np.arange(vals.size), vals.reshape(-1)] = 1.0
    return one_hot


def _synthetic_classification(n, feature_shape, num_classes, seed):
    """Deterministic, linearly-separable-ish synthetic data: class centroids +
    gaussian noise, so models measurably learn (loss decreases, acc >> chance)."""
    rng = np.random.RandomState(seed)
    dim = int(np.prod(feature_shape))
    centroids = rng.randn(num_classes, dim).astype(np.float32) * 2.0
    labels = rng.randint(0, num_classes, size=n)
    x = centroids[labels] + rng.randn(n, dim).astype(np.float32)
    x = (x - x.mean()) / (x.std() + 1e-6)
    return x.reshape((n,) + tuple(feature_shape)).astype(np.float32), labels


def mnist(dataset="mnist.pkl.gz", onehot=True):
    """Returns [(train_x, train_y), (valid_x, valid_y), (test_x, test_y)]
    with x: (N, 784) float32 (reference data.py:5)."""
    path = _find(dataset)
    if path is not None:
        with gzip.open(path, "rb") as f:
            train_set, valid_set, test_set = pickle.load(f, encoding="latin1")
        sets = [train_set, valid_set, test_set]
    else:
        sets = []
        for n, seed in ((50000, 1), (10000, 2), (10000, 3)):
            x, y = _synthetic_classification(n, (784,), 10, seed)
            sets.append((x, y))
    out = []
    for x, y in sets:
        y = convert_to_one_hot(y, max_val=10) if onehot else np.asarray(y)
        out.append((np.asarray(x, dtype=np.float32), y))
    return out


def _load_cifar_pickled(files, label_key):
    xs, ys = [], []
    for fname in files:
        with open(fname, "rb") as f:
            batch = pickle.load(f, encoding="latin1")
        xs.append(np.asarray(batch["data"], dtype=np.float32))
        ys.append(np.asarray(batch[label_key], dtype=np.int64))
    return np.concatenate(xs), np.concatenate(ys)


def cifar10(directory="CIFAR_10", onehot=True, num_class=10):
    root = _find(directory)
    if root is not None:
        train_files = [os.path.join(root, f"data_batch_{i}") for i in range(1, 6)]
        test_files = [os.path.join(root, "test_batch")]
        train_x, train_y = _load_cifar_pickled(train_files, "labels")
        test_x, test_y = _load_cifar_pickled(test_files, "labels")
        train_x = train_x.reshape(-1, 3, 32, 32)
        test_x = test_x.reshape(-1, 3, 32, 32)
    else:
        train_x, train_y = _synthetic_classification(50000, (3, 32, 32), num_class, 11)
        test_x, test_y = _synthetic_classification(10000, (3, 32, 32), num_class, 12)
    if onehot:
        train_y = convert_to_one_hot(train_y, max_val=num_class)
        test_y = convert_to_one_hot(test_y, max_val=num_class)
    return train_x, train_y, test_x, test_y


def cifar100(directory="CIFAR_100", onehot=True):
    return cifar10(directory, onehot, num_class=100)


def normalize_cifar(num_class=10, onehot=True):
    """Channel-normalized CIFAR (reference data.py:153): returns
    (train_x, train_y, valid_x, valid_y) in NCHW."""
    if num_class == 10:
        train_x, train_y, test_x, test_y = cifar10(onehot=onehot)
    else:
        train_x, train_y, test_x, test_y = cifar100(onehot=onehot)
    mean = train_x.mean(axis=(0, 2, 3), keepdims=True)
    std = train_x.std(axis=(0, 2, 3), keepdims=True) + 1e-7
    train_x = (train_x - mean) / std
    test_x = (test_x - mean) / std
    return (train_x.astype(np.float32), train_y,
            test_x.astype(np.float32), test_y)


# ---------------------------------------------------------------------------
# augmentation (reference data.py:129-173): host numpy. Each random helper
# draws from the ``np.random.RandomState`` it is given, where the reference
# falls back to numpy's global state.
# ---------------------------------------------------------------------------

def _image_crop(images, rng):
    """Each image shifted by a random crop of its 4-pixel zero padding."""
    n, c, h, w = images.shape
    pad = 4
    padded = np.pad(images, ((0, 0), (0, 0), (pad, pad), (pad, pad)),
                    "constant")
    out = np.empty_like(images)
    for i in range(n):
        top = rng.randint(0, 2 * pad + 1)
        left = rng.randint(0, 2 * pad + 1)
        out[i] = padded[i, :, top:top + h, left:left + w]
    return out


def _image_flip(images, rng):
    """About half of the images mirrored left to right."""
    flip = rng.rand(images.shape[0]) < 0.5
    out = images.copy()
    out[flip] = out[flip][:, :, :, ::-1]
    return out


def _image_whitening(images):
    """Each image to zero mean and unit variance (its deviation floored at
    1 / sqrt(its size))."""
    mean = images.mean(axis=(1, 2, 3), keepdims=True)
    std = np.maximum(images.std(axis=(1, 2, 3), keepdims=True),
                     1.0 / np.sqrt(np.prod(images.shape[1:])))
    return (images - mean) / std


def _image_noise(images, rng, mean=0, std=0.01):
    return images + rng.normal(mean, std, size=images.shape).astype(
        images.dtype)


def data_augmentation(images, mode="train", flip=False, crop=False,
                      whiten=False, noise=False, rng=None):
    """NCHW ``images`` cropped, flipped and noised (``mode="train"``) and
    whitened, as asked; ``rng`` is the ``np.random.RandomState`` the random
    steps draw from (a fresh one when None)."""
    rng = rng if rng is not None else np.random.RandomState()
    images = np.asarray(images, dtype=np.float32)
    if mode == "train":
        if crop:
            images = _image_crop(images, rng)
        if flip:
            images = _image_flip(images, rng)
    if whiten:
        images = _image_whitening(images)
    if noise and mode == "train":
        images = _image_noise(images, rng)
    return images
