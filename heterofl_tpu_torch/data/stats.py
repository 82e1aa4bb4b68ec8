"""Per-channel mean and standard deviation of a dataset's train images.

Port of ``heterofl_tpu/data/stats.py`` (the reference's ``make_stats``):
batches of 100 images, scaled to [0, 1] as ``ToTensor`` does, merged with
the pooled-variance update in float64, and cached to
``{data_dir}/stats/{name}.npz`` (keys ``mean`` and ``std``, float32), the
file the reference writes, so each package reads the other's cache.  Used
for a dataset without a ``DATASET_STATS`` entry (EMNIST).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


class Stats:
    """Mergeable per-channel mean and (unbiased) standard deviation, the
    channel the last axis."""

    def __init__(self):
        self.n = 0
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def update(self, batch: np.ndarray) -> None:
        x = batch.reshape(-1, batch.shape[-1]).astype(np.float64)
        n, mean = x.shape[0], x.mean(0)
        std = x.std(0, ddof=1) if n > 1 else np.zeros_like(mean)
        if self.n == 0:
            self.n, self.mean, self.std = n, mean, std
            return
        m = float(self.n)
        tot = m + n
        new_mean = m / tot * self.mean + n / tot * mean
        self.std = np.sqrt(m / tot * self.std ** 2 + n / tot * std ** 2
                           + m * n / tot ** 2 * (self.mean - mean) ** 2)
        self.mean = new_mean
        self.n += n


def compute_stats(data: np.ndarray, batch: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """Channel statistics of a uint8 NHWC image array -> float32 ``(mean,
    std)``."""
    st = Stats()
    for i in range(0, len(data), batch):
        st.update(data[i: i + batch].astype(np.float32) / 255.0)
    return st.mean.astype(np.float32), st.std.astype(np.float32)


def stats_path(name: str, data_dir: str) -> str:
    return os.path.join(data_dir, "stats", f"{name}.npz")


def dataset_stats(name: str, data: np.ndarray, data_dir: str = "./data"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The cached statistics of dataset ``name``, computed from ``data``
    and written to the cache when there is none."""
    path = stats_path(name, data_dir)
    if os.path.exists(path):
        z = np.load(path)
        return z["mean"], z["std"]
    mean, std = compute_stats(data)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, mean=mean, std=std)
    return mean, std
