"""The federated round engine on one GPU.

Port of ``heterofl_tpu/parallel/round_engine.py`` (``train_round`` ->
``_round_core`` -> ``_local_train_vision``, masked strategy, fix-mode
rates, vision).  The reference runs a round as one XLA program with the
clients under ``vmap``; here the clients train one after another in a
Python loop (batching them is later work), each through:

* its width mask applied to the global params (distribute);
* per local epoch a shuffle, then a stable sort that puts real samples
  first, ``ceil(N/B)`` steps per epoch, all-padding batches gated off by
  ``has``;
* per step the model forward/backward on leaf views of ONE flat params
  buffer (weighted-SUM loss), the per-leaf gradients packed into one flat
  buffer, and the fused masked-SGD epilogue over the flat params, momentum,
  gradient and hoisted width mask (ops/fused_update.py) -- or, with
  ``fused_update=False``, the per-leaf reference chain on views of the same
  buffers;
* aggregation in the flat domain: ``sum += trained * count_mask``,
  ``count += count_mask``, then the counted average with stale fallback.

The step loop never waits for the device: the batch weight sum, ``lr`` and
``has`` stay device tensors the kernel reads by pointer, and no value is
read back per step.  Per-client randomness (epoch permutations,
augmentation draws) comes from a ``torch.Generator`` on the device seeded
from (round seed, user id); ``jax.random`` streams are not reproducible in
torch, so tests hand in the reference's epoch permutations instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.datasets import DATASET_STATS
from ..fed.core import combine_counted, to_width_rates
from ..models.base import FedModel
from ..models.spec import param_mask
from ..ops.augment import augment_cifar, normalize_image
from ..ops.fused_update import FlatSpec, fused_sgd_flat, make_scal, resolve_fused_mode
from ..utils.optim import clip_by_global_norm, sgd_update


def client_seed(round_seed: int, uid: int) -> int:
    """Seed of one client's generator in one round."""
    return int(np.random.SeedSequence([int(round_seed), 13, int(uid)]).generate_state(1)[0])


class RoundEngine:
    """Local training and counted aggregation of one round, for one
    (model, cfg, device)."""

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device):
        self.model, self.cfg, self.device = model, cfg, device
        self.global_rate = cfg["global_model_rate"]
        ne = cfg["num_epochs"]
        self.local_epochs = ne["local"] if isinstance(ne, dict) else 1
        self.batch_size = cfg["batch_size"]["train"]
        stats = DATASET_STATS.get(cfg["data_name"])
        if stats is None:
            raise NotImplementedError(
                f"data_name={cfg['data_name']!r}: computed normalisation statistics "
                f"are not ported to heterofl_tpu_torch yet")
        self.norm_mean = torch.tensor(stats[0], dtype=torch.float32, device=device)
        self.norm_std = torch.tensor(stats[1], dtype=torch.float32, device=device)
        self.augment = cfg["data_name"].startswith("CIFAR")
        self.fix_rates = np.asarray(cfg["model_rate"], np.float32)
        self.fused_mode = resolve_fused_mode(cfg, device)
        self.momentum = float(cfg.get("momentum", 0.0))
        self.weight_decay = float(cfg.get("weight_decay", 0.0))
        self.spec = FlatSpec.of(dict(model.named_parameters()))
        self._label_axes = [(k, s.label_axis) for k, s in model.specs.items()
                            if s.label_axis is not None]
        # flat width masks per width rate, built once on the host and moved
        # to the device before any round starts (a copy mid-round would wait
        # for the device)
        self._masks: Dict[float, torch.Tensor] = {}
        for wr in sorted(set(to_width_rates(self.fix_rates, cfg).tolist())):
            self.param_mask_flat(wr)

    # -- flat buffers ----------------------------------------------------

    def flatten(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.spec.flatten({k: v.detach() for k, v in params.items()}).to(self.device)

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.spec.unflatten(flat)

    def param_mask_flat(self, wr: float) -> torch.Tensor:
        """Flat width mask of a client at width rate ``wr`` (the distribute
        mask and the gradient mask)."""
        if wr not in self._masks:
            m = {k: param_mask(s, self.model.specs[k], self.model.groups, wr)
                 for k, s in self.spec.shapes.items()}
            self._masks[wr] = self.spec.flatten(m).to(self.device)
        return self._masks[wr]

    def count_mask_flat(self, wr: float, label_mask: torch.Tensor) -> torch.Tensor:
        """Flat aggregation mask: the width mask with label-axis rows
        restricted to the client's labels (device ops only)."""
        cm = self.param_mask_flat(wr).clone()
        for k, axis in self._label_axes:
            leaf = self.spec.leaf(cm, k)
            view = [1] * leaf.ndim
            view[axis] = leaf.shape[axis]
            leaf.mul_(label_mask.reshape(view))
        return cm

    # -- one client --------------------------------------------------------

    def _prep(self, x_u8: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """uint8 NHWC batch -> normalised NCHW view (channels_last memory)."""
        if self.augment:
            x_u8 = augment_cifar(x_u8, gen)
        return normalize_image(x_u8, self.norm_mean, self.norm_std).permute(0, 3, 1, 2)

    def local_train(self, P: torch.Tensor, wr: float, x, y, sm, lm, gen: torch.Generator,
                    lr: torch.Tensor, raw_perms: Optional[np.ndarray] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of one client from the global flat params ``P`` ->
        ``(trained flat params, [loss_sum, correct_sum, n] device sums)``.

        ``raw_perms`` (``[E, N]``, test hook) replaces the generator's epoch
        permutations; the real-first sort still runs on them."""
        spec, model, B, E = self.spec, self.model, self.batch_size, self.local_epochs
        dev = P.device
        N = x.shape[0]
        S = math.ceil(N / B)
        SB = S * B
        mask = self.param_mask_flat(wr)
        p = P * mask
        buf = torch.zeros_like(p)
        g = torch.empty_like(p)
        if raw_perms is None:
            perms = torch.stack([torch.randperm(N, generator=gen, device=dev) for _ in range(E)])
        else:
            perms = torch.as_tensor(np.asarray(raw_perms), dtype=torch.int64).to(dev)
        order = torch.sort(-sm[perms], dim=1, stable=True).indices
        perms = torch.gather(perms, 1, order)
        wpad = torch.ones(SB, dtype=torch.float32, device=dev)
        if SB > N:
            perms = perms.repeat(1, math.ceil(SB / N))[:, :SB]
            wpad[N:] = 0.0
        acc = torch.zeros(3, dtype=torch.float32, device=dev)
        for t in range(E * S):
            e, s = divmod(t, S)
            ids = perms[e, s * B:(s + 1) * B]
            w = wpad[s * B:(s + 1) * B] * sm[ids]
            n_glob = w.sum()
            labels = y[ids]
            img = self._prep(x[ids], gen)
            leaves = {k: v.requires_grad_() for k, v in spec.unflatten(p).items()}
            score, loss = model(img, labels, params=leaves, width_rate=wr, scaler_rate=wr,
                                label_mask=lm, sample_weight=w)
            lsum = loss * n_glob  # weighted-SUM form, as the reference
            grads = torch.autograd.grad(lsum, [leaves[k] for k in spec.names])
            del leaves
            correct = ((score.detach().argmax(-1) == labels).to(torch.float32) * w).sum()
            if self.fused_mode is None:
                self._reference_step(p, buf, grads, mask, n_glob, lr)
            else:
                torch.cat([gr.reshape(-1) for gr in grads], out=g)
                fused_sgd_flat(g, p, buf, mask, make_scal(n_glob, lr), momentum=self.momentum,
                               weight_decay=self.weight_decay, max_norm=1.0)
            del grads
            acc += torch.stack([lsum.detach(), correct, n_glob])
        return p, acc

    def _reference_step(self, p, buf, grads, mask, n_glob, lr) -> None:
        """``fused_update=False``: the unfused per-leaf optimizer chain
        (ref round_engine.py:622-634) -- mean-normalise, width mask,
        global-norm clip, SGD, ``has`` gate -- in place on leaf views of the
        flat ``p`` and ``buf``."""
        spec = self.spec
        pt, bt, mt = spec.unflatten(p), spec.unflatten(buf), spec.unflatten(mask)
        denom = n_glob.clamp_min(1e-6)
        gm = {k: (gr / denom) * mt[k] for k, gr in zip(spec.names, grads)}
        gm, _ = clip_by_global_norm(gm, 1.0)
        new_p, new_b = sgd_update(pt, gm, bt, lr, self.momentum, self.weight_decay)
        has = n_glob > 0  # all-padding batch: skip the step entirely
        for k in spec.names:
            pt[k].copy_(torch.where(has, new_p[k], pt[k]))
            bt[k].copy_(torch.where(has, new_b[k], bt[k]))

    # -- one round ---------------------------------------------------------

    def train_round(self, P: torch.Tensor, lr: float, user_idx: Sequence[int],
                    data: Tuple[torch.Tensor, ...], round_seed: int,
                    epoch_perms: Optional[Dict[int, np.ndarray]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One round from the global flat params ``P``.

        ``data``: device stacks ``(x [U, N, H, W, C] uint8, y [U, N],
        sample_mask [U, N], label_mask [U, classes])``.  Returns the new
        global flat params and per-client metric sums (device tensors
        ``loss_sum``, ``score_sum``, ``n``; host ``rate``).
        ``epoch_perms`` (test hook): ``{uid: [E, N]}`` raw permutations."""
        x_all, y_all, sm_all, lm_all = data
        user_idx = np.asarray(user_idx, np.int64)
        rates_abs = self.fix_rates[user_idx]
        wrs = to_width_rates(rates_abs, self.cfg)
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=P.device)
        summed = torch.zeros_like(P)
        counts = torch.zeros_like(P)
        rows = []
        for slot, uid in enumerate(user_idx.tolist()):
            gen = torch.Generator(device=P.device)
            gen.manual_seed(client_seed(round_seed, uid))
            wr = float(wrs[slot])
            trained, acc = self.local_train(
                P, wr, x_all[uid], y_all[uid], sm_all[uid], lm_all[uid], gen, lr_t,
                None if epoch_perms is None else epoch_perms[uid])
            cm = self.count_mask_flat(wr, lm_all[uid])
            summed += trained * cm
            counts += cm
            rows.append(acc)
        acc = torch.stack(rows)
        ms = {"loss_sum": acc[:, 0], "score_sum": acc[:, 1], "n": acc[:, 2],
              "rate": rates_abs}
        return combine_counted(P, summed, counts), ms
