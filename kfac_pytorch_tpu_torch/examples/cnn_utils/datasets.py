"""Data for the trainers: CIFAR-10 and ImageNet, or a synthetic stand-in.

Port of ``examples/cnn_utils/datasets.py``.  Each rank of
``torch.distributed`` loads its own interleaved shard of every epoch's
permutation (the ``DistributedSampler`` of the original torch library);
batches come out as numpy ``[N, H, W, C]`` float32 images and int32
labels, which the epoch loops move to the card.  CIFAR-10 is read from
the ``cifar-10-batches-py`` pickles and ImageNet from an ImageFolder
tree, decoded with PIL, which is imported only when such a tree exists.
Without the data both fall back to deterministic, class-separable
synthetic data of the same layout, so the trainers run anywhere.

Batches are gathered, cropped and flipped by the port's native data
kernels (:mod:`kfac_pytorch_tpu_torch._native.data`, C++ built with
``g++`` at first use), as the JAX package's loader does; the draws stay
in numpy, so the numpy twin, which runs when the library did not build,
gives the same bits.
"""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch.distributed as dist

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass
class ShardInfo:
    """This rank's slice of the data-parallel world."""

    index: int = 0
    count: int = 1

    @classmethod
    def from_world(cls) -> 'ShardInfo':
        """The rank and world of ``torch.distributed`` (0 of 1 when it is
        not initialized)."""
        if dist.is_available() and dist.is_initialized():
            return cls(dist.get_rank(), dist.get_world_size())
        return cls()


class ArrayLoader:
    """Epoch-shuffled minibatches of in-memory arrays.

    Every rank permutes the whole index set with the same per-epoch
    seed and takes its interleaved shard; ``batch_size`` is the rank's
    own batch, and :meth:`set_epoch` is ``DistributedSampler``'s.  With
    ``augment`` each image is reflect-padded by 4, randomly cropped back
    and randomly flipped (the CIFAR recipe).
    """

    PAD = 4

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        shard: ShardInfo | None = None,
        shuffle: bool = True,
        augment: bool = False,
        seed: int = 0,
        drop_last: bool = True,
    ) -> None:
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.shard = shard or ShardInfo()
        self.shuffle = shuffle
        self.augment = augment
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n_local = len(self.images) // self.shard.count
        if self.drop_last:
            return n_local // self.batch_size
        return -(-n_local // self.batch_size)

    def _draw_augment(self, n: int, rng: np.random.Generator):
        """One batch's crop offsets and flips, in the JAX loader's order."""
        p = self.PAD
        ys = rng.integers(0, 2 * p + 1, size=n)
        xs = rng.integers(0, 2 * p + 1, size=n)
        flips = rng.random(n) < 0.5
        return ys, xs, flips

    def _augment_numpy(self, batch, ys, xs, flips) -> np.ndarray:
        """The numpy twin of the native ``gather_crop_flip``."""
        n, h, w, _ = batch.shape
        p = self.PAD
        padded = np.pad(batch, ((0, 0), (p, p), (p, p), (0, 0)),
                        mode='reflect')
        out = np.empty_like(batch)
        for i in range(n):
            img = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
            out[i] = img[:, ::-1] if flips[i] else img
        return out

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        from kfac_pytorch_tpu_torch._native import data as native_data

        rng = np.random.default_rng((self.seed, self._epoch))
        order = (rng.permutation(len(self.images)) if self.shuffle
                 else np.arange(len(self.images)))
        local = order[self.shard.index::self.shard.count]
        for b in range(len(self)):
            idx = local[b * self.batch_size:(b + 1) * self.batch_size]
            if self.augment:
                ys, xs, flips = self._draw_augment(len(idx), rng)
                batch = native_data.gather_crop_flip(
                    self.images, idx, self.PAD, ys, xs, flips)
                if batch is None:
                    batch = self._augment_numpy(self.images[idx], ys, xs,
                                                flips)
            else:
                batch = native_data.gather(self.images, idx)
                if batch is None:
                    batch = self.images[idx]
            yield batch, self.labels[idx]


def _load_cifar_batches(data_dir: str) -> tuple | None:
    base = os.path.join(data_dir, 'cifar-10-batches-py')
    if not os.path.isdir(base):
        return None

    def read(name):
        with open(os.path.join(base, name), 'rb') as f:
            d = pickle.load(f, encoding='bytes')
        imgs = d[b'data'].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return imgs, np.asarray(d[b'labels'], np.int32)

    train = [read(f'data_batch_{i}') for i in range(1, 6)]
    test_x, test_y = read('test_batch')
    train_x = np.concatenate([t[0] for t in train])
    train_y = np.concatenate([t[1] for t in train])
    return train_x, train_y, test_x, test_y


def _normalize(x: np.ndarray, mean: np.ndarray, std: np.ndarray):
    return ((x.astype(np.float32) / 255.0) - mean) / std


def synthetic_dataset(
    n_train: int,
    n_test: int,
    shape: tuple[int, ...],
    classes: int,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic class-separable data: random unit-norm class means
    plus noise of standard deviation 0.5, so a model can learn it."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(classes,) + shape).astype(np.float32)
    means /= np.linalg.norm(means.reshape(classes, -1), axis=1).reshape(
        (classes,) + (1,) * len(shape))

    def make(n):
        y = np.arange(n, dtype=np.int32) % classes
        x = means[y] + 0.5 * rng.normal(size=(n,) + shape).astype(np.float32)
        return x, y

    train = make(n_train)
    test = make(n_test)
    return train[0], train[1], test[0], test[1]


def get_cifar(
    data_dir: str,
    batch_size: int,
    shard: ShardInfo | None = None,
    seed: int = 42,
) -> tuple[ArrayLoader, ArrayLoader]:
    """``(train_loader, test_loader)`` of CIFAR-10: the augmented,
    normalized train split and the normalized test split, or 4096 and
    1024 synthetic 32x32 images of 10 classes without the pickles."""
    raw = _load_cifar_batches(data_dir)
    if raw is None:
        train_x, train_y, test_x, test_y = synthetic_dataset(
            4096, 1024, (32, 32, 3), 10, seed=0,
        )
    else:
        train_x, train_y, test_x, test_y = raw
        train_x = _normalize(train_x, CIFAR_MEAN, CIFAR_STD)
        test_x = _normalize(test_x, CIFAR_MEAN, CIFAR_STD)
    train = ArrayLoader(train_x, train_y, batch_size, shard, shuffle=True,
                        augment=raw is not None, seed=seed)
    test = ArrayLoader(test_x, test_y, batch_size, shard, shuffle=False,
                       augment=False, seed=seed)
    return train, test


class ImageFolderLoader:
    """ImageNet-style ``root/<class>/<image>`` tree decoded with PIL on a
    thread pool; per-rank sharded, epoch-shuffled, and for training
    resized, randomly cropped and flipped (center-cropped otherwise)."""

    def __init__(
        self,
        root: str,
        batch_size: int,
        shard: ShardInfo | None = None,
        train: bool = True,
        image_size: int = 224,
        seed: int = 42,
        workers: int = 8,
        drop_last: bool = True,
    ) -> None:
        self.root = root
        self.batch_size = batch_size
        self.shard = shard or ShardInfo()
        self.train = train
        self.image_size = image_size
        self.seed = seed
        self.workers = workers
        self.drop_last = drop_last
        self._epoch = 0
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(('.jpeg', '.jpg', '.png')):
                    self.samples.append(
                        (os.path.join(cdir, fname), self.class_to_idx[c]))

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.samples) // self.shard.count
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _decode(self, path: str, rng: np.random.Generator) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert('RGB')
        s = self.image_size
        if self.train:
            scale = rng.uniform(1.0, 1.15)
            short = int(s * scale)
            w, h = img.size
            ratio = short / min(w, h)
            img = img.resize((max(s, int(w * ratio)), max(s, int(h * ratio))))
            w, h = img.size
            x0 = rng.integers(0, w - s + 1)
            y0 = rng.integers(0, h - s + 1)
            img = img.crop((x0, y0, x0 + s, y0 + s))
            arr = np.asarray(img, np.uint8)
            if rng.random() < 0.5:
                arr = arr[:, ::-1]
        else:
            w, h = img.size
            ratio = int(s * 1.14) / min(w, h)
            img = img.resize((int(w * ratio), int(h * ratio)))
            w, h = img.size
            x0, y0 = (w - s) // 2, (h - s) // 2
            img = img.crop((x0, y0, x0 + s, y0 + s))
            arr = np.asarray(img, np.uint8)
        return _normalize(arr, IMAGENET_MEAN, IMAGENET_STD)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng((self.seed, self._epoch))
        order = (rng.permutation(len(self.samples)) if self.train
                 else np.arange(len(self.samples)))
        local = order[self.shard.index::self.shard.count]
        pool = ThreadPoolExecutor(self.workers)
        try:
            for b in range(len(self)):
                idx = local[b * self.batch_size:(b + 1) * self.batch_size]
                seeds = rng.integers(0, 2**31, size=len(idx))
                futs = [pool.submit(self._decode, self.samples[i][0],
                                    np.random.default_rng(sd))
                        for i, sd in zip(idx, seeds)]
                images = np.stack([f.result() for f in futs])
                labels = np.array([self.samples[i][1] for i in idx],
                                  np.int32)
                yield images, labels
        finally:
            pool.shutdown(wait=False)


def get_imagenet(
    data_dir: str,
    batch_size: int,
    shard: ShardInfo | None = None,
    image_size: int = 224,
    seed: int = 42,
):
    """``(train_loader, val_loader)`` of an ImageFolder tree with
    ``train/`` and ``val/``; without them, 2048 and 512 synthetic images
    of 100 classes at ``min(image_size, 64)`` square."""
    train_dir = os.path.join(data_dir, 'train')
    val_dir = os.path.join(data_dir, 'val')
    if not (os.path.isdir(train_dir) and os.path.isdir(val_dir)):
        side = min(image_size, 64)
        train_x, train_y, test_x, test_y = synthetic_dataset(
            2048, 512, (side, side, 3), 100, seed=0,
        )
        return (
            ArrayLoader(train_x, train_y, batch_size, shard, shuffle=True,
                        seed=seed),
            ArrayLoader(test_x, test_y, batch_size, shard, shuffle=False,
                        seed=seed),
        )
    return (
        ImageFolderLoader(train_dir, batch_size, shard, train=True,
                          image_size=image_size, seed=seed),
        ImageFolderLoader(val_dir, batch_size, shard, train=False,
                          image_size=image_size, seed=seed),
    )
