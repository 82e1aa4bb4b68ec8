"""sBN recalibration and Local/Global evaluation on one GPU.

Port of the host-loop (``superstep_rounds=1``) path of
``heterofl_tpu/parallel/evaluation.py::Evaluator``.  Federated training runs
BN on batch statistics only; before an evaluation the global model makes
one no-grad pass over the train set in ``"collect"`` mode and averages each
BN site's per-batch ``(mean, unbiased var)`` (a cumulative average, the
reference's momentum=None BN).  "Local" evaluates each user's test shard
under that user's label mask; "Global" the whole test set without one.
Both run the BN sites in ``"running"`` mode on the sBN statistics.  A
masked LM (``evaluation.py:141-155, 230-250``) has no BN and no Local: its
Global pass runs the test set's bptt windows, each window with a positive
weight adding ``CE * R``, ``exp(CE) * R`` (Perplexity's sum) and ``R``
rows; its corruption draws come from a generator seeded from (experiment
seed, the global stream, epoch), so evaluating a checkpoint again at the
epoch it was logged at reproduces the logged value on the same device.

The reference scans batches inside one XLA program (users under ``vmap``);
here batches run one after another in a Python loop of no-grad forwards on
the device, and the metric sums stay on the device until the one fetch at
the end of each method.  Operands are device tensors staged once by the
caller (``entry/common.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.base import FedModel
from .round_engine import norm_stats_tensors, prep_image

BnState = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


#: stream id of the Global evaluation's draws (the reference's
#: ``fold_in(key(seed), 1)``)
GLOBAL_STREAM = 1


def eval_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The generator of one Global evaluation's draws: seeded from the
    experiment seed, the global stream and the epoch."""
    state = np.random.SeedSequence([int(seed), GLOBAL_STREAM, int(epoch)]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class Evaluator:
    """Evaluation programs of one (model, cfg, device); ``seed`` is the
    experiment's (the LM's corruption draws descend from it)."""

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device,
                 seed: int = 0):
        self.model, self.device, self.seed = model, device, seed
        self.is_lm = model.meta["kind"] == "transformer"
        if not self.is_lm:
            self.norm = norm_stats_tensors(cfg, device)

    def _img(self, x_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC batch -> normalised NCHW view (channels_last memory)."""
        return prep_image(x_u8, self.norm)

    @torch.no_grad()
    def sbn_stats(self, params: Dict[str, torch.Tensor], x_batches: torch.Tensor,
                  w_batches: torch.Tensor) -> BnState:
        """Cumulative-average BN statistics over ``[S, B, H, W, C]`` uint8
        train batches with sample weights ``[S, B]``: each batch with a
        positive weight adds its sites' ``(mean, unbiased var)``, and the
        sums are divided by ``max(batches, 1)`` -> ``{site: (mean, var)}``."""
        if self.is_lm or self.model.norm != "bn":
            return {}
        sums: Dict[str, list] = {}
        n = torch.zeros((), dtype=torch.float32, device=self.device)
        labels = torch.zeros(x_batches.shape[1], dtype=torch.int64, device=self.device)
        for t in range(x_batches.shape[0]):
            w = w_batches[t]
            has = (w.sum() > 0).to(torch.float32)
            col: BnState = {}
            self.model(self._img(x_batches[t]), labels, params=params, bn_mode="collect",
                       sample_weight=w, bn_collect=col)
            for site, (m, v) in col.items():
                if site not in sums:
                    sums[site] = [torch.zeros_like(m), torch.zeros_like(v)]
                sums[site][0] += m * has
                sums[site][1] += v * has
            n += has
        d = n.clamp_min(1.0)
        return {site: (m / d, v / d) for site, (m, v) in sums.items()}

    def _batch_metrics(self, params, bn_state: BnState, x, y, w, lm=None) -> torch.Tensor:
        """``[loss_sum, correct, n]`` of one batch, on the device."""
        score, loss = self.model(self._img(x), y, params=params, bn_mode="running",
                                 bn_state=bn_state, label_mask=lm, sample_weight=w)
        n = w.sum()
        correct = ((score.argmax(-1) == y).to(torch.float32) * w).sum()
        return torch.stack([loss * n, correct, n])

    @torch.no_grad()
    def eval_users(self, params, bn_state: BnState, x: torch.Tensor, y: torch.Tensor,
                   m: torch.Tensor, lm: torch.Tensor) -> Dict[str, np.ndarray]:
        """"Local" metric sums per user: batched test shards ``x [U, S, B,
        H, W, C]``, ``y``/``m`` ``[U, S, B]``, label masks ``lm [U,
        classes]`` -> ``{loss_sum, score_sum, n}``, each ``[U]``."""
        acc = torch.zeros((x.shape[0], 3), dtype=torch.float32, device=self.device)
        for u in range(x.shape[0]):
            for t in range(x.shape[1]):
                acc[u] += self._batch_metrics(params, bn_state, x[u, t], y[u, t], m[u, t], lm[u])
        host = acc.cpu().numpy()
        return {"loss_sum": host[:, 0], "score_sum": host[:, 1], "n": host[:, 2]}

    @torch.no_grad()
    def eval_global(self, params, bn_state: BnState, *batched: torch.Tensor, epoch: int = 0,
                    draws: Optional[Callable[[int], Dict[str, Any]]] = None
                    ) -> Dict[str, float]:
        """"Global" metric sums over the batched test set -> ``{loss_sum,
        score_sum, n}``: vision ``(x [S, B, H, W, C], y [S, B], w [S,
        B])``; LM ``(windows [S, R, bptt], position weights [S, R, bptt])``
        with the corruption drawn from :func:`eval_generator` at ``epoch``
        (``draws(t)``, a test hook, gives window ``t``'s instead)."""
        acc = torch.zeros(3, dtype=torch.float32, device=self.device)
        if self.is_lm:
            rows, w = batched
            gen = eval_generator(self.seed, epoch, self.device)
            rows_n = torch.full((), float(rows.shape[1]), dtype=torch.float32,
                                device=self.device)
            for t in range(rows.shape[0]):
                _, loss = self.model(rows[t], params=params, sample_weight=w[t], train=False,
                                     gen=gen, draws=None if draws is None else draws(t))
                has = (w[t].sum() > 0).to(torch.float32)
                acc += torch.stack([loss * rows_n, torch.exp(loss) * rows_n, rows_n]) * has
        else:
            x, y, w = batched
            for t in range(x.shape[0]):
                acc += self._batch_metrics(params, bn_state, x[t], y[t], w[t])
        loss_sum, score_sum, n = acc.tolist()
        return {"loss_sum": loss_sum, "score_sum": score_sum, "n": n}
