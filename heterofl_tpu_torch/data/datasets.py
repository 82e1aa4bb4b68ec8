"""Vision datasets: the deterministic synthetic generator and per-dataset
normalisation statistics.

Port of the synthetic branch of ``heterofl_tpu/data/datasets.py:405-501``.
The numpy RNG calls are the reference's, in the same order, so the arrays
are identical for the same seed.  On-disk loaders are not ported yet:
``fetch_dataset`` needs ``synthetic=True``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..config import MNIST_LIKE

DATASET_STATS = {
    "MNIST": ((0.1307,), (0.3081,)),
    "FashionMNIST": ((0.2860,), (0.3530,)),
    "CIFAR10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "CIFAR100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
}

_EMNIST_CLASSES = {"byclass": 62, "bymerge": 47, "balanced": 47, "letters": 26,
                   "digits": 10, "mnist": 10}


@dataclass
class ArrayDataset:
    """In-memory labelled image dataset (NHWC uint8)."""

    data: np.ndarray
    target: np.ndarray
    classes_size: int
    data_name: str
    augment: bool = False  # train split of CIFAR: random crop + flip on device

    def __len__(self) -> int:
        return len(self.data)


def _emnist_subset(subset) -> str:
    if subset in ("label", None, ""):
        return "balanced"
    if subset not in _EMNIST_CLASSES:
        raise ValueError(f"Not valid EMNIST subset: {subset!r} (one of {sorted(_EMNIST_CLASSES)})")
    return subset


def synthetic_vision(data_name: str, split: str, n: Optional[int] = None, seed: int = 0,
                     subset: str = "balanced") -> ArrayDataset:
    """Class-conditional random images: mean brightness and two per-class
    stripes depend on the label, so a model can learn from them."""
    shape = (28, 28, 1) if data_name in MNIST_LIKE else (32, 32, 3)
    if data_name == "EMNIST":
        classes = _EMNIST_CLASSES[_emnist_subset(subset)]
    else:
        classes = {"CIFAR100": 100}.get(data_name, 10)
    if n is None:
        n = 2000 if split == "train" else 500
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    labels = rng.integers(0, classes, size=n).astype(np.int64)
    imgs = rng.integers(0, 96, size=(n,) + shape).astype(np.int64)
    h, w = shape[0], shape[1]
    lab = labels[:, None, None, None]
    row = np.arange(h)[None, :, None, None]
    col = np.arange(w)[None, None, :, None]
    imgs = (imgs
            + 40 * (row == lab % h)
            + 40 * (col == (lab * 7 + 3) % w)
            + 8 * (lab % 8))
    return ArrayDataset(np.clip(imgs, 0, 255).astype(np.uint8), labels, classes, data_name,
                        augment=(split == "train" and data_name.startswith("CIFAR")))


def fetch_dataset(data_name: str, data_dir: str = "./data", synthetic: bool = False,
                  seed: int = 0, synthetic_sizes: Optional[Dict[str, int]] = None,
                  subset: str = "label") -> Dict[str, Any]:
    """``{'train': dataset, 'test': dataset}`` from the synthetic generator."""
    if not synthetic:
        raise NotImplementedError(
            "on-disk datasets (synthetic=False, data_dir) are not ported to "
            "heterofl_tpu_torch yet; pass synthetic=1")
    return {split: synthetic_vision(data_name, split, n=(synthetic_sizes or {}).get(split),
                                    seed=seed, subset=subset)
            for split in ("train", "test")}
