"""The sliced strategy: the grouped engine's host-orchestrated twin.

Port of ``heterofl_tpu/fed/sliced.py`` (``SlicedFederation``): each
level's dense sub-model is cut from the global params on the host
(``fed.core.extract_sliced``), each of its clients trains one after another
through the one-client engine of that sub-model (``RoundEngine.local_train``
at width rate 1, the Scaler at the level's rate; the unbatched kernels),
and the trained sub-models are scattered back into zero global tensors
(``fed.core.embed_sliced``) and counted on the host, then averaged with the
stale fallback.  Every client keeps the masked engine's generator
(``client_seed(round_seed, uid)``), so sliced equals masked up to float
association, and the grouped engine (its clients batched, the batched
kernels) equals this twin: the check that holds every batched kernel
against the one-client kernels end to end.  Slow by design (host copies a
client); a lossy wire codec is refused (``compress.resolve_codec_cfg``),
and so is a schedule other than lockstep (``sched.resolve_schedule_cfg``)
and ``client_failure_rate`` (the reference's twin ignores the rate).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compress import resolve_codec_cfg
from ..models import make_model
from ..models.base import FedModel
from ..models.spec import count_masks
from ..ops.fused_update import FlatSpec
from ..sched import resolve_schedule_cfg
from ..parallel.round_engine import FlatParams, RoundEngine, client_seed, cohort_rates
from .core import combine_counted, embed_sliced, extract_sliced, snap_to_levels


class SlicedFederation(FlatParams):
    """Host-orchestrated round over true sliced sub-models, for one
    (global model, cfg, device)."""

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device):
        resolve_codec_cfg(dict(cfg, strategy="sliced"))  # a codec is refused
        resolve_schedule_cfg(dict(cfg, strategy="sliced"))  # and so is a scenario
        if float(cfg.get("client_failure_rate", 0.0) or 0.0) > 0.0:
            raise ValueError(
                "client_failure_rate needs a mesh-native strategy ('masked' or 'grouped'): the "
                "sliced debug twin replays the reference host loop, which draws no failures")
        self.model, self.cfg, self.device = model, cfg, device
        self.global_rate = cfg["global_model_rate"]
        self.is_lm = model.meta["kind"] == "transformer"
        self.spec = FlatSpec.of(dict(model.named_parameters()))
        level_cfg = dict(cfg, model_rate=[self.global_rate], model_split_mode="fix",
                         schedule=None)
        self.levels: Dict[float, RoundEngine] = {
            rate: RoundEngine(make_model(cfg, rate), level_cfg, device)
            for rate in sorted({float(r) for r in cfg["model_rate"]}, reverse=True)}

    def train_round(self, P: torch.Tensor, lr: float, user_idx: Sequence[int],
                    data: Tuple[torch.Tensor, ...], round_seed: int,
                    epoch_perms: Optional[Dict[int, np.ndarray]] = None,
                    lm_draws: Optional[Callable[[int, int], Dict[str, Any]]] = None,
                    rates: Optional[Sequence[float]] = None,
                    aug_draws: Optional[Callable[[int, int], Tuple[Any, Any]]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One round from the global flat params ``P``; arguments, hooks and
        results as ``RoundEngine.train_round``'s (no codec)."""
        gm = self.model
        user_idx = np.asarray(user_idx, np.int64).reshape(-1)
        rates_abs = cohort_rates(self.cfg, user_idx, round_seed, rates)
        snapped = snap_to_levels(rates_abs, self.levels)
        gp = {k: v.detach().cpu().numpy() for k, v in self.spec.unflatten(P).items()}
        summed = {k: np.zeros(s, np.float32) for k, s in self.spec.shapes.items()}
        counts = {k: np.zeros(s, np.float32) for k, s in self.spec.shapes.items()}
        lm_all = data[-1]
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=P.device)
        acc = [None] * len(user_idx)
        for rate in sorted(set(snapped.tolist()), reverse=True):
            eng = self.levels[rate]
            wr = rate / self.global_rate
            sub = extract_sliced(gp, gm.specs, gm.groups, wr)
            P_l = eng.spec.flatten({k: torch.from_numpy(v) for k, v in sub.items()}).to(P.device)
            for pos in np.flatnonzero(snapped == rate).tolist():
                uid = int(user_idx[pos])
                gen = torch.Generator(device=P.device).manual_seed(client_seed(round_seed, uid))
                if self.is_lm:
                    trained, acc[pos] = eng.local_train_lm(
                        P_l, 1.0, data[0][uid], lm_all[uid], gen, lr_t,
                        None if lm_draws is None else (lambda t, u=uid: lm_draws(u, t)),
                        scaler_rate=wr)
                else:
                    trained, acc[pos] = eng.local_train(
                        P_l, 1.0, data[0][uid], data[1][uid], data[2][uid], lm_all[uid], gen,
                        lr_t, None if epoch_perms is None else epoch_perms[uid],
                        None if aug_draws is None else (lambda t, u=uid: aug_draws(u, t)),
                        scaler_rate=wr)
                small = {k: v.cpu().numpy() for k, v in eng.spec.unflatten(trained).items()}
                back = embed_sliced(small, gm.specs, gm.groups, wr, self.spec.shapes)
                cm = count_masks(self.spec.shapes, gm.specs, gm.groups, wr, lm_all[uid])
                for k in self.spec.names:
                    c = cm[k].numpy()
                    summed[k] += back[k] * c
                    counts[k] += c
        to_flat = lambda tree: self.spec.flatten(  # noqa: E731
            {k: torch.from_numpy(v) for k, v in tree.items()}).to(P.device)
        acc = torch.stack(acc) if acc else P.new_zeros((0, 3))
        ms = {"loss_sum": acc[:, 0], "score_sum": acc[:, 1], "n": acc[:, 2], "rate": rates_abs}
        return combine_counted(P, to_flat(summed), to_flat(counts)), ms
