"""The federated round engine on one GPU.

Port of ``heterofl_tpu/parallel/round_engine.py`` (``train_round`` ->
``_round_core`` -> ``_local_train_vision`` / ``_local_train_lm``, masked
strategy, ``fix`` and ``dynamic`` rates).  The reference runs a round as one
XLA program with the clients under ``vmap``; here the clients train one after another
in a Python loop (batching them is later work), each through:

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
* a masked-LM client (:meth:`RoundEngine.local_train_lm`) instead runs
  ``E * ceil(T / bptt)`` steps over its token rows' bptt windows in order
  (zero position weights on the padded tail), through the same fused
  epilogue; its draws (token corruption, dropout) come from its generator;
* aggregation in the flat domain: ``sum += trained * count_mask``,
  ``count += count_mask``, then the counted average with stale fallback.
  With a lossy ``wire_codec`` the flat ``(sum, count)`` pair goes through
  the codec first (compress/codecs.py: encode, the sum over participants,
  decode), and the codec's error-feedback residual is carried on the device
  from round to round (the reference's ``_WireCodecCarry``).

The step loop never waits for the device: the batch weight sum, ``lr`` and
``has`` stay device tensors the kernel reads by pointer, and no value is
read back per step.  Per-client randomness (epoch permutations,
augmentation draws) comes from a ``torch.Generator`` on the device seeded
from (round seed, user id), and a ``dynamic`` round's rates from
``fed.core.round_rates`` on the host; ``jax.random`` streams are not
reproducible in torch, so tests hand in the reference's rates, epoch
permutations and augmentation draws (and an LM client's corruption and
dropout draws) instead.  Every width mask a round can need is on the device
before the first round.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compress import make_codec, resolve_codec_cfg
from ..compress.codecs import compressed_sum
from ..data.datasets import DATASET_STATS
from ..fed.core import combine_counted, round_rates, to_width_rates
from ..models.base import FedModel
from ..models.spec import label_vector, param_mask
from ..ops.augment import augment_cifar, normalize_image
from ..ops.fused_update import FlatSpec, fused_sgd_flat, make_scal, resolve_fused_mode
from ..utils.optim import clip_by_global_norm, sgd_update


def norm_stats_tensors(cfg: Dict[str, Any], device: torch.device
                       ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The vision normalisation ``(mean, std)`` on the device, in the
    reference's order: the computed statistics (``cfg['norm_stats']``,
    ``entry.common._maybe_compute_norm_stats``), else the dataset's
    ``DATASET_STATS`` entry, else None (the images go in as floats of
    their bytes, as in the reference)."""
    stats = cfg.get("norm_stats") or DATASET_STATS.get(cfg["data_name"])
    if stats is None:
        return None
    return tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in stats)


def prep_image(x_u8: torch.Tensor, norm) -> torch.Tensor:
    """uint8 NHWC batch -> normalised NCHW view (channels_last memory)."""
    x = normalize_image(x_u8, *norm) if norm is not None else x_u8.to(torch.float32)
    return x.permute(0, 3, 1, 2)


def cohort_rates(cfg: Dict[str, Any], user_idx: np.ndarray, round_seed: int,
                 rates: Optional[Sequence[float]] = None) -> np.ndarray:
    """The cohort's absolute rates (float32): ``rates`` when given, else each
    user's own in ``fix`` mode and the round's draw (``fed.core.round_rates``
    at ``round_seed``) in ``dynamic`` mode."""
    if rates is not None:
        out = np.asarray(rates, np.float32).reshape(-1)
    elif cfg["model_split_mode"] == "fix":
        out = np.asarray(cfg["model_rate"], np.float32)[user_idx]
    else:
        out = round_rates(round_seed, cfg, user_idx)
    if out.shape != user_idx.shape:
        raise ValueError(f"{out.size} rates for {user_idx.size} users")
    return out


def client_seed(round_seed: int, uid: int) -> int:
    """Seed of one client's generator in one round."""
    return int(np.random.SeedSequence([int(round_seed), 13, int(uid)]).generate_state(1)[0])


class FlatParams:
    """What the experiment loop reads of a round engine: the global params
    as one flat buffer (``spec``, on ``device``) and the wire codec's
    residual carry (none without a codec)."""

    spec: FlatSpec
    device: torch.device
    codec = None

    def flatten(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.spec.flatten({k: v.detach() for k, v in params.items()}).to(self.device)

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.spec.unflatten(flat)

    def wire_resid_host(self) -> Optional[np.ndarray]:
        return None


class RoundEngine(FlatParams):
    """Local training and counted aggregation of one round, for one
    (model, cfg, device)."""

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device):
        self.model, self.cfg, self.device = model, cfg, device
        self.global_rate = cfg["global_model_rate"]
        ne = cfg["num_epochs"]
        self.local_epochs = ne["local"] if isinstance(ne, dict) else 1
        self.batch_size = cfg["batch_size"]["train"]
        self.is_lm = model.meta["kind"] == "transformer"
        if self.is_lm:
            self.bptt = cfg["bptt"]
        else:
            self.norm = norm_stats_tensors(cfg, device)
            self.augment = cfg["data_name"].startswith("CIFAR")
        # fix mode: every user's rate; dynamic: the rates are drawn per round
        self.fix_rates = np.asarray(cfg["model_rate"], np.float32) \
            if cfg["model_split_mode"] == "fix" else None
        self.fused_mode = resolve_fused_mode(cfg, device)
        self.momentum = float(cfg.get("momentum", 0.0))
        self.weight_decay = float(cfg.get("weight_decay", 0.0))
        self.spec = FlatSpec.of(dict(model.named_parameters()))
        # wire codec: one participant (one GPU); 'dense' builds no codec and
        # no residual, and leaves the round as it was
        name, ef = resolve_codec_cfg(cfg)
        self.codec = make_codec(name, self.spec, 1, error_feedback=ef)
        self._resid: Optional[torch.Tensor] = None  # [resid_slots, total] EF carry
        self._label_axes = [(k, s.label_axis) for k, s in model.specs.items()
                            if s.label_axis is not None]
        # flat width masks (and the group norms' channel masks) per width
        # rate a round can draw -- every user's in fix mode, every mode
        # rate in dynamic mode -- built once on the host and moved to the
        # device before any round starts (a copy mid-round would wait for
        # the device)
        self._masks: Dict[float, torch.Tensor] = {}
        for wr in sorted(set(to_width_rates(cfg["model_rate"], cfg).tolist())):
            self.param_mask_flat(wr)
            model.prepare_width(wr, device)

    # -- flat buffers ----------------------------------------------------

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
            leaf.mul_(label_vector(label_mask, leaf.shape[axis]).reshape(view))
        return cm

    # -- one client --------------------------------------------------------

    def _prep(self, x_u8: torch.Tensor, gen: torch.Generator, draw=None) -> torch.Tensor:
        """uint8 NHWC batch -> normalised NCHW view (channels_last memory);
        ``draw``, when given, the augmentation's ``(offsets, flips)``."""
        if self.augment:
            x_u8 = augment_cifar(x_u8, gen, *(draw or (None, None)))
        return prep_image(x_u8, self.norm)

    def local_train(self, P: torch.Tensor, wr: float, x, y, sm, lm, gen: torch.Generator,
                    lr: torch.Tensor, raw_perms: Optional[np.ndarray] = None,
                    aug: Optional[Callable[[int], Tuple[Any, Any]]] = None,
                    scaler_rate: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of one client from the global flat params ``P`` ->
        ``(trained flat params, [loss_sum, correct_sum, n] device sums)``.
        ``scaler_rate`` (default ``wr``): the Scaler's rate, which a dense
        level sub-model trained at ``wr = 1`` takes from its level (the
        sliced twin).

        Test hooks: ``raw_perms`` (``[E, N]``) replaces the generator's epoch
        permutations (the real-first sort still runs on them); ``aug(t)``
        gives local step ``t``'s augmentation ``(offsets [B, 2], flips
        [B])`` instead of the generator."""
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
            img = self._prep(x[ids], gen, None if aug is None else
                             tuple(torch.as_tensor(np.array(a)).to(dev) for a in aug(t)))
            leaves = {k: v.requires_grad_() for k, v in spec.unflatten(p).items()}
            score, loss = model(img, labels, params=leaves, width_rate=wr,
                                scaler_rate=wr if scaler_rate is None else scaler_rate,
                                label_mask=lm, sample_weight=w)
            lsum = loss * n_glob  # weighted-SUM form, as the reference
            grads = torch.autograd.grad(lsum, [leaves[k] for k in spec.names])
            del leaves
            correct = ((score.detach().argmax(-1) == labels).to(torch.float32) * w).sum()
            self._step(p, buf, g, grads, mask, n_glob, lr)
            del grads
            acc += torch.stack([lsum.detach(), correct, n_glob])
        return p, acc

    def local_train_lm(self, P: torch.Tensor, wr: float, rows: torch.Tensor, lm: torch.Tensor,
                       gen: torch.Generator, lr: torch.Tensor,
                       draws: Optional[Callable[[int], Dict[str, Any]]] = None,
                       scaler_rate: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local SGD of one masked-LM client on its token rows ``[R, T]``
        from the global flat params ``P`` -> ``(trained flat params,
        [loss_sum, score_sum, n] device sums)``.

        Step ``t`` trains on window ``t % S`` of the ``S = ceil(T / bptt)``
        windows, the loss the weighted SUM over its positions; each step
        adds ``R`` rows to ``n``, ``window CE * R`` to the loss and
        ``exp(window CE) * R`` to the score (Perplexity's sum; ref
        round_engine.py:740-815).  ``draws(t)`` (test hook) gives step
        ``t``'s corruption and dropout draws instead of ``gen``;
        ``scaler_rate`` as in :meth:`local_train`."""
        spec, model, bptt, E = self.spec, self.model, self.bptt, self.local_epochs
        dev = P.device
        R, T = rows.shape
        S = math.ceil(T / bptt)
        pad = S * bptt - T
        rows_p = torch.nn.functional.pad(rows, (0, pad))
        wpos = torch.ones((R, S * bptt), dtype=torch.float32, device=dev)
        if pad:
            wpos[:, T:] = 0.0
        n_win = wpos.view(R, S, bptt).sum((0, 2))  # each window's weight sum
        mask = self.param_mask_flat(wr)
        p = P * mask
        buf = torch.zeros_like(p)
        g = torch.empty_like(p)
        acc = torch.zeros(3, dtype=torch.float32, device=dev)
        rows_n = torch.full((), float(R), dtype=torch.float32, device=dev)
        for t in range(E * S):
            s = t % S
            lab, w = rows_p[:, s * bptt:(s + 1) * bptt], wpos[:, s * bptt:(s + 1) * bptt]
            n_glob = n_win[s]
            leaves = {k: v.requires_grad_() for k, v in spec.unflatten(p).items()}
            _, loss = model(lab, params=leaves, width_rate=wr,
                            scaler_rate=wr if scaler_rate is None else scaler_rate, label_mask=lm,
                            sample_weight=w, train=True, gen=gen,
                            draws=None if draws is None else draws(t))
            lsum = loss * n_glob  # weighted-SUM form, as the reference
            grads = torch.autograd.grad(lsum, [leaves[k] for k in spec.names])
            del leaves
            self._step(p, buf, g, grads, mask, n_glob, lr)
            del grads
            wl = lsum.detach() / n_glob.clamp_min(1e-6)
            acc += torch.stack([wl * rows_n, torch.exp(wl) * rows_n, rows_n])
        return p, acc

    def _step(self, p, buf, g, grads, mask, n_glob, lr) -> None:
        """The optimizer tail of one local step, in place on ``p`` and
        ``buf``: the fused epilogue over the flat buffers (its gradient
        packed into ``g``), or the per-leaf chain."""
        if self.fused_mode is None:
            self._reference_step(p, buf, grads, mask, n_glob, lr)
        else:
            torch.cat([gr.reshape(-1) for gr in grads], out=g)
            fused_sgd_flat(g, p, buf, mask, make_scal(n_glob, lr), momentum=self.momentum,
                           weight_decay=self.weight_decay, max_norm=1.0)

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

    # -- the wire codec's error-feedback carry ----------------------------

    def _ensure_resid(self, device: torch.device) -> torch.Tensor:
        """The residual carry, zeros on first use."""
        if self._resid is None:
            self._resid = torch.zeros((self.codec.resid_slots, self.spec.total),
                                      dtype=torch.float32, device=device)
        return self._resid

    def wire_resid_host(self) -> Optional[np.ndarray]:
        """Host copy of the residual carry ``[resid_slots, total]`` (for a
        checkpoint); None under ``dense`` or before the first compressed
        round."""
        return None if self._resid is None else self._resid.cpu().numpy()

    def set_wire_resid(self, arr) -> None:
        """Restore the residual carry (from a checkpoint) onto the device."""
        host = torch.as_tensor(np.asarray(arr, np.float32))
        want = (self.codec.resid_slots, self.spec.total)
        if tuple(host.shape) != want:
            raise ValueError(f"wire residual of shape {tuple(host.shape)}, want {want}")
        self._resid = host.to(self.device)

    def reset_carries(self) -> None:
        """Drop the residual carry; the next compressed round starts from
        zeros unless one is restored first."""
        self._resid = None

    # -- one round ---------------------------------------------------------

    def train_round(self, P: torch.Tensor, lr: float, user_idx: Sequence[int],
                    data: Tuple[torch.Tensor, ...], round_seed: int,
                    epoch_perms: Optional[Dict[int, np.ndarray]] = None,
                    codec_noise: Optional[torch.Tensor] = None,
                    topk_offset: Optional[int] = None,
                    lm_draws: Optional[Callable[[int, int], Dict[str, Any]]] = None,
                    rates: Optional[Sequence[float]] = None,
                    aug_draws: Optional[Callable[[int, int], Tuple[Any, Any]]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One round from the global flat params ``P``.

        ``data``: device stacks ``(x [U, N, H, W, C] uint8, y [U, N],
        sample_mask [U, N], label_mask [U, classes])``, or for a masked LM
        ``(token rows [U, R, T], label_mask [U, num_tokens])``.  Returns the new
        global flat params and per-client metric sums (device tensors
        ``loss_sum``, ``score_sum``, ``n``; host ``rate``, the users'
        absolute rates).  ``rates``: the users' absolute rates; without
        them a ``dynamic`` round draws them (``fed.core.round_rates`` at
        ``round_seed``) and a ``fix`` round takes each user's own.  An empty
        cohort leaves ``P`` as it is (the stale-value fallback everywhere)
        and sends nothing through a wire codec.  Test hooks, which replace
        a draw from the round seed: ``epoch_perms`` ``{uid: [E, N]}`` raw
        permutations; ``aug_draws(uid, t)`` a CIFAR client's augmentation
        ``(offsets [B, 2], flips [B])`` of local step ``t``; ``codec_noise``
        the int8 codec's rounding noise ``[total]`` (flat layout of
        ``self.spec``); ``topk_offset`` the topk codec's block offset;
        ``lm_draws(uid, t)`` an LM client's corruption and dropout draws of
        local step ``t``."""
        lm_all = data[-1]
        user_idx = np.asarray(user_idx, np.int64).reshape(-1)
        rates_abs = cohort_rates(self.cfg, user_idx, round_seed, rates)
        wrs = to_width_rates(rates_abs, self.cfg)
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=P.device)
        summed = torch.zeros_like(P)
        counts = torch.zeros_like(P)
        rows = []
        for slot, uid in enumerate(user_idx.tolist()):
            gen = torch.Generator(device=P.device)
            gen.manual_seed(client_seed(round_seed, uid))
            wr = float(wrs[slot])
            if self.is_lm:
                draws = None if lm_draws is None else (lambda t, u=uid: lm_draws(u, t))
                trained, acc = self.local_train_lm(P, wr, data[0][uid], lm_all[uid], gen, lr_t,
                                                   draws)
            else:
                trained, acc = self.local_train(
                    P, wr, data[0][uid], data[1][uid], data[2][uid], lm_all[uid], gen, lr_t,
                    None if epoch_perms is None else epoch_perms[uid],
                    None if aug_draws is None else (lambda t, u=uid: aug_draws(u, t)))
            cm = self.count_mask_flat(wr, lm_all[uid])
            summed += trained * cm
            counts += cm
            rows.append(acc)
        acc = torch.stack(rows) if rows else P.new_zeros((0, 3))
        ms = {"loss_sum": acc[:, 0], "score_sum": acc[:, 1], "n": acc[:, 2],
              "rate": rates_abs}
        if self.codec is not None and rows:
            draw = {"int8": codec_noise, "topk": topk_offset}.get(self.codec.name)
            if draw is None:
                draw = self.codec.draw(round_seed, P.device)
            summed, counts, self._resid = compressed_sum(
                self.codec, P, summed, counts, self._ensure_resid(P.device), draw,
                len(user_idx))
        return combine_counted(P, summed, counts), ms
