"""On-device data augmentation and normalisation.

Port of ``heterofl_tpu/ops/augment.py``: CIFAR train batches get
RandomCrop(32, padding=4) + RandomHorizontalFlip on the device, from raw
uint8 NHWC shards.  Draws come from an explicit ``torch.Generator`` on the
batch's device; ``offsets``/``flips`` inject them instead (tests hand in the
reference's draws, which ``jax.random`` makes and torch cannot reproduce).
A level's G clients (the grouped engine) go through one call over their
``G * B`` images, each client's draws made by its own generator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def normalize_image(x: torch.Tensor, mean: Sequence[float] | torch.Tensor,
                    std: Sequence[float] | torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 normalised (ToTensor + Normalize).  The step
    loop passes ``mean``/``std`` as tensors already on the device, so no
    host-to-device copy happens per step."""
    x = x.to(torch.float32) / 255.0
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def augment_draws(n: int, generator: torch.Generator, device) -> tuple:
    """``(offsets int64 [n, 2] in [0, 8], flips bool [n])`` for one batch."""
    offsets = torch.randint(0, 9, (n, 2), generator=generator, device=device)
    flips = torch.rand(n, generator=generator, device=device) < 0.5
    return offsets, flips


def augment_cifar(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  offsets: Optional[torch.Tensor] = None,
                  flips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RandomCrop(pad=4) + RandomHorizontalFlip on an NHWC batch, as one
    gather: ``out[i, r, c] = pad(x)[i, r + oy_i, col_i(c)]`` with the column
    reversed where the flip is drawn."""
    n, h, w, _ = x.shape
    if offsets is None or flips is None:
        offsets, flips = augment_draws(n, generator, x.device)
    pad = 4
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    ar_h = torch.arange(h, device=x.device)
    ar_w = torch.arange(w, device=x.device)
    rows = offsets[:, 0:1] + ar_h                                   # [n, h]
    cols = torch.where(flips[:, None], (w - 1) - ar_w, ar_w) + offsets[:, 1:2]  # [n, w]
    i = torch.arange(n, device=x.device)[:, None, None]
    return xp[i, rows[:, :, None], cols[:, None, :]]
