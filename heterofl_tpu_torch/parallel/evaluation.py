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

:meth:`Evaluator.fused` builds the superstep's evaluation
(:class:`FusedEval`, ref evaluation.py:309-435): the same sBN, Local and
Global passes on the rounds the superstep's eval mask names, each batch a
replay of one captured no-grad forward per batch shape
(``parallel/step_graph.py``; the sBN train batches, the per-user Local
batches, the Global test batches or LM windows), reading its batch through
a device counter and adding into static sums, so the results stay on the
device until the superstep's one fetch and equal :meth:`Evaluator.sbn_stats`,
:meth:`~Evaluator.eval_users` and :meth:`~Evaluator.eval_global` bit for
bit.  A rolling Local-eval window (``eval_cohort``) is copied into the same
device operands (:meth:`FusedEval.set_local`), so no forward is captured
again per window.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.base import FedModel
from ..ops.fused_update import FlatSpec
from .round_engine import norm_stats_tensors, prep_image
from .step_graph import StepGraphs, device_counter

BnState = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


#: stream id of the Global evaluation's draws (the reference's
#: ``fold_in(key(seed), 1)``)
GLOBAL_STREAM = 1


def eval_seed(seed: int, epoch: int) -> int:
    """The seed of one Global evaluation's draws: from the experiment seed,
    the global stream and the epoch."""
    return int(np.random.SeedSequence([int(seed), GLOBAL_STREAM, int(epoch)]
                                      ).generate_state(1)[0])


def eval_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The generator of one Global evaluation's draws (:func:`eval_seed`)."""
    return torch.Generator(device=device).manual_seed(eval_seed(seed, epoch))


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
        for t in range(x_batches.shape[0]):
            self._sbn_batch(params, x_batches[t], w_batches[t], sums, n)
        d = n.clamp_min(1.0)
        return {site: (m / d, v / d) for site, (m, v) in sums.items()}

    def _sbn_batch(self, params, x, w, sums: Dict[str, list], n: torch.Tensor) -> None:
        """One sBN train batch: with a positive weight, its sites' ``(mean,
        unbiased var)`` added into ``sums`` (made on first use) and one
        into the batch count ``n``."""
        has = (w.sum() > 0).to(torch.float32)
        col: BnState = {}
        labels = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        self.model(self._img(x), labels, params=params, bn_mode="collect", sample_weight=w,
                   bn_collect=col)
        for site, (m, v) in col.items():
            if site not in sums:
                sums[site] = [torch.zeros_like(m), torch.zeros_like(v)]
            sums[site][0] += m * has
            sums[site][1] += v * has
        n += has

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
                acc += self._lm_window(params, rows[t], w[t], rows_n, gen,
                                       None if draws is None else draws(t))
        else:
            x, y, w = batched
            for t in range(x.shape[0]):
                acc += self._batch_metrics(params, bn_state, x[t], y[t], w[t])
        loss_sum, score_sum, n = acc.tolist()
        return {"loss_sum": loss_sum, "score_sum": score_sum, "n": n}

    def _lm_window(self, params, rows, w, rows_n, gen, draws=None) -> torch.Tensor:
        """``[CE * R, exp(CE) * R, R]`` of one LM test window ``rows [R,
        bptt]`` with position weights ``w``, zero when no weight is
        positive; ``draws`` replaces the generator's corruption draws."""
        _, loss = self.model(rows, params=params, sample_weight=w, train=False, gen=gen,
                             draws=draws)
        has = (w.sum() > 0).to(torch.float32)
        return torch.stack([loss * rows_n, torch.exp(loss) * rows_n, rows_n]) * has

    def fused(self, spec: FlatSpec, sbn_batches=None, local_eval=None, global_eval=None
              ) -> "FusedEval":
        """The superstep's evaluation over the staged operands (the host
        path's device tensors): ``spec`` the engine's flat layout,
        ``sbn_batches`` ``(x, w)``, ``local_eval`` ``(x, y, m, lm)`` (vision),
        ``global_eval`` the batched test set (always)."""
        if global_eval is None:
            raise ValueError("fused eval needs the global-eval operands "
                             "(the reference evaluates Global every pass)")
        return FusedEval(self, spec, sbn_batches, local_eval, global_eval)


class FusedEval:
    """The evaluation inside a superstep: :meth:`run` evaluates flat params
    ``P`` at an epoch into device sums, :meth:`assemble` turns the fetched
    sums into the host path's results."""

    def __init__(self, evaluator: Evaluator, spec: FlatSpec, sbn_batches, local_eval,
                 global_eval):
        ev, dev = evaluator, evaluator.device
        self.ev, self.spec = ev, spec
        self.has_sbn = (not ev.is_lm and sbn_batches is not None and ev.model.norm == "bn")
        self.has_local = not ev.is_lm and local_eval is not None
        self.sbn, self.local, self.glob = sbn_batches, local_eval, global_eval
        self.n_users = int(local_eval[0].shape[0]) if self.has_local else 0
        self.graphs = StepGraphs(dev)
        self.P = torch.zeros(spec.total, dtype=torch.float32, device=dev)
        self.params = spec.unflatten(self.P)
        self.t = device_counter(dev)
        self.sums: Dict[str, list] = {}
        self.n = torch.zeros((), dtype=torch.float32, device=dev)
        self.bn: BnState = {}
        self.acc_local = torch.zeros((self.n_users, 3), dtype=torch.float32, device=dev)
        self.acc_global = torch.zeros(3, dtype=torch.float32, device=dev)
        self.gen = torch.Generator(device=dev)

    def set_local(self, local) -> None:
        """Copy a rolling Local-eval window's operands ``(x, y, m, lm)``
        (arrays of this evaluation's Local shapes) into the device buffers
        its captured forwards read, so every window replays the same graphs
        (the driver pads each window to the population's largest test
        shard)."""
        if not self.has_local:
            raise ValueError("set_local: this evaluation has no Local operands")
        for dst, src in zip(self.local, local):
            src = torch.as_tensor(np.ascontiguousarray(src))
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(f"set_local: a window operand of {tuple(src.shape)} "
                                 f"{src.dtype}, the evaluation's is {tuple(dst.shape)} "
                                 f"{dst.dtype}")
            dst.copy_(src)

    @torch.no_grad()
    def _sbn_batch(self) -> None:
        """One sBN batch (``Evaluator.sbn_stats``'s loop body)."""
        (xs, ws), t = self.sbn, self.t.view(1)
        self.ev._sbn_batch(self.params, xs.index_select(0, t)[0], ws.index_select(0, t)[0],
                           self.sums, self.n)
        self.t += 1

    @torch.no_grad()
    def _local_batch(self) -> None:
        """One Local batch of one user (``Evaluator.eval_users``'s loop
        body): flat batch ``i`` of ``[U * S]`` is user ``i // S``'s."""
        ev, (x, y, m, lm) = self.ev, self.local
        S = x.shape[1]
        i = self.t.view(1)
        u = torch.div(i, S, rounding_mode="floor")
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:])).index_select(0, i)[0]  # noqa: E731
        out = ev._batch_metrics(self.params, self.bn, flat(x), flat(y), flat(m),
                                lm.index_select(0, u)[0])
        self.acc_local.index_add_(0, u, out.view(1, 3))
        self.t += 1

    @torch.no_grad()
    def _global_batch(self) -> None:
        """One Global batch or LM window (``Evaluator.eval_global``'s loop
        body)."""
        ev, t = self.ev, self.t.view(1)
        if ev.is_lm:
            rows, w = self.glob
            rows_n = torch.full((), float(rows.shape[1]), dtype=torch.float32,
                                device=rows.device)
            self.acc_global += ev._lm_window(self.params, rows.index_select(0, t)[0],
                                             w.index_select(0, t)[0], rows_n, self.gen)
        else:
            x, y, w = self.glob
            self.acc_global += ev._batch_metrics(self.params, self.bn, x.index_select(0, t)[0],
                                                 y.index_select(0, t)[0],
                                                 w.index_select(0, t)[0])
        self.t += 1

    def _replay(self, key: str, body, batches: int, zero=(), generators=(),
                seed: Optional[int] = None) -> None:
        """Capture ``body`` at ``key`` on first use (its warm-up writes into
        the sums), then zero the sums ``zero`` and the counter, reseed the
        generators, and replay it ``batches`` times."""
        step = self.graphs.get(key, body, self.t.zero_, generators)
        for z in zero:
            z.zero_()
        self.t.zero_()
        for gen in generators:
            gen.manual_seed(seed)
        for _ in range(batches):
            step.replay()

    def run(self, P: torch.Tensor, epoch: int) -> Dict[str, Any]:
        """sBN, Local and Global on the flat params ``P`` at ``epoch`` ->
        device sums ``{"bn": {site: (mean, var)}, "local": [U, 3],
        "global": [3]}`` (new tensors; no value is read back)."""
        self.P.copy_(P)
        if self.has_sbn:
            if not self.sums:  # the sites' shapes: one eager batch makes the sums
                self.t.zero_()
                self._sbn_batch()
            self._replay("sbn", self._sbn_batch, self.sbn[0].shape[0],
                         [self.n] + [x for mv in self.sums.values() for x in mv])
            d = self.n.clamp_min(1.0)
            if not self.bn:
                self.bn.update({site: (torch.empty_like(m), torch.empty_like(v))
                                for site, (m, v) in self.sums.items()})
            for site, (m, v) in self.sums.items():
                torch.div(m, d, out=self.bn[site][0])
                torch.div(v, d, out=self.bn[site][1])
        out: Dict[str, Any] = {"bn": {site: (m.clone(), v.clone())
                                      for site, (m, v) in self.bn.items()}}
        if self.has_local:
            self._replay("local", self._local_batch, self.n_users * self.local[0].shape[1],
                         [self.acc_local])
            out["local"] = self.acc_local.clone()
        self._replay("global", self._global_batch, self.glob[0].shape[0], [self.acc_global],
                     [self.gen] if self.ev.is_lm else (), eval_seed(self.ev.seed, epoch))
        out["global"] = self.acc_global.clone()
        return out

    def assemble(self, host: list, eval_epochs) -> list:
        """The fetched evaluations as the host path gives them: per epoch
        ``{"epoch", "bn", "local": {loss_sum, score_sum, n} per user,
        "global": {loss_sum, score_sum, n} floats}``."""
        out = []
        for ep, h in zip(eval_epochs, host):
            local = {}
            if self.has_local:
                a = h["local"]
                local = {"loss_sum": a[:, 0], "score_sum": a[:, 1], "n": a[:, 2]}
            g = [float(v) for v in h["global"]]
            out.append({"epoch": int(ep), "bn": dict(h["bn"]), "local": local,
                        "global": {"loss_sum": g[0], "score_sum": g[1], "n": g[2]}})
        return out
