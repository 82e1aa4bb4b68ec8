"""The streaming client store of the PyTorch/CUDA port
(``heterofl_tpu_torch/parallel/staging.py``: ``ClientStore``,
``CohortStager``; ``data/partition.py::span_population``;
``fed/sampling.py::ScheduleCommitment``; the store's configuration keys)
against the JAX reference on the CPU, and the cohort ring and the rolling
Local-eval window of the port.

Contracts:

* the store's gathers (ragged CSR shards, span windows, LM token rows,
  label masks, ``-1`` padding slots) equal the reference ``ClientStore``'s
  and the eager stacks, bit for bit; ``span_population`` equals the
  reference's (the stride bumped to one coprime to ``hi``), bit for bit;
* ``ScheduleCommitment``'s ``may_draw``, ``state_for`` and
  ``committed_through`` equal the reference's over a dispatch-and-fetch
  sequence;
* every refusal of ``client_store``, ``stream_prefetch_depth``,
  ``eval_cohort`` and ``sample_horizon`` raises the reference's
  ``ValueError`` message;
* staging a cohort of a 200,000-user span population takes the
  reference's host-memory bounds against a 2,000-user one
  (tests/test_streaming.py:349-381), and the same cohort bytes;
* the cohort ring never changes a committed cohort: a slot is refilled only
  after its cohort was released, at depth 1 and 2;
* the rolling Local-eval window's users equal the reference's
  ``_eval_cohort_users``, and the window's fused Local sums equal the host
  Local evaluation over those users bit for bit.
"""

import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.data import span_population as r_span_population
from heterofl_tpu.entry.common import FedExperiment as RFedExperiment
from heterofl_tpu.fed import sampling as RS
from heterofl_tpu.parallel.staging import ClientStore as RClientStore
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.data import (label_split_masks, span_population, stack_client_shards,
                                     stack_client_token_rows)
from heterofl_tpu_torch.entry.common import FedExperiment, stage_local_eval
from heterofl_tpu_torch.fed import sampling as S
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import RoundEngine
from heterofl_tpu_torch.parallel.staging import ClientStore, CohortStager
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()


def _ragged():
    """Raw arrays and a ragged CSR split of 3 users (17, 3 and 40 samples)."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 255, (60, 4, 4, 1)).astype(np.uint8)
    target = rng.integers(0, 10, 60)
    split = {0: list(range(17)), 1: list(range(17, 20)), 2: list(range(20, 60))}
    lsplit = {0: [0, 3], 1: [5], 2: list(range(10))}
    return data, target, split, lsplit


def _fill(store, ids, classes=10):
    n = store.shard_max
    x = np.empty((len(ids), n) + store.data.shape[1:], store.data.dtype)
    y = np.empty((len(ids), n), store.target.dtype)
    m = np.empty((len(ids), n), np.float32)
    lm = np.empty((len(ids), classes), np.float32)
    store.fill_vision(np.asarray(ids), x, y, m)
    store.fill_labels(np.asarray(ids), lm)
    return x, y, m, lm


# --- the store ----------------------------------------------------------------------

def test_csr_store_matches_reference_and_eager_stack():
    """Ragged CSR shards: images, targets (the repeat-first-items padding),
    sample masks and label masks equal the reference store's and the eager
    stacks; a ``-1`` slot gathers user 0's shard."""
    data, target, split, lsplit = _ragged()
    store = ClientStore.from_split(data, target, split, lsplit, 10)
    ref = RClientStore.from_split(data, target, split, lsplit, 10)
    assert (store.shard_max, store.num_users) == (ref.shard_max, ref.num_users) == (40, 3)
    assert store.metadata_nbytes == ref.metadata_nbytes
    ids = [2, 0, -1, 1, 1]
    got, want = _fill(store, ids), _fill(ref, ids)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x, y, m = stack_client_shards(data, target, split, [0, 1, 2])
    lm = label_split_masks(lsplit, 3, 10)
    for got_a, eager in zip(got, (x, y, m, lm)):
        np.testing.assert_array_equal(got_a, eager[[2, 0, 0, 1, 1]])
    print("parity ClientStore CSR fill: max_abs_err 0 (bit for bit)")


def test_span_store_matches_reference():
    """Span windows onto a shared pool: the rows are the raw slices, an iid
    store's label masks all ones, the metadata O(U) and the reference's."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 255, (100, 2, 2, 1)).astype(np.uint8)
    target = rng.integers(0, 10, 100)
    starts, sizes = span_population(100, 5000, 16)
    store = ClientStore.from_spans(data, target, starts, sizes, 10)
    ref = RClientStore.from_spans(data, target, starts, sizes, 10)
    ids = [7, 4999, -1, 12]
    for a, b in zip(_fill(store, ids), _fill(ref, ids)):
        np.testing.assert_array_equal(a, b)
    x = _fill(store, ids)[0]
    lo = int(starts[4999])
    np.testing.assert_array_equal(x[1], data[lo:lo + 16])
    assert (_fill(store, ids)[3] == 1.0).all()
    assert store.metadata_nbytes == ref.metadata_nbytes == starts.nbytes + sizes.nbytes


def test_lm_store_matches_reference_and_eager_rows():
    """Batchified token rows: a user's rows and label masks equal the
    reference store's and ``stack_client_token_rows``; unequal row counts
    are refused as the eager stack refuses them."""
    rng = np.random.default_rng(1)
    token = rng.integers(0, 50, (12, 30)).astype(np.int64)
    split = {0: [3, 7, 1], 1: [0, 2, 4], 2: [5, 6, 8], 3: [9, 10, 11]}
    lsplit = {u: np.unique(token[split[u]]).tolist() for u in split}
    store = ClientStore.from_split(token, None, split, lsplit, 50, kind="lm")
    ref = RClientStore.from_split(token, None, split, lsplit, 50, kind="lm")
    ids = np.array([3, -1, 1])
    rows, r_rows = (np.empty((3,) + s.row_shape, token.dtype) for s in (store, ref))
    lm, r_lm = (np.empty((3, 50), np.float32) for _ in range(2))
    store.fill_lm(ids, rows)
    ref.fill_lm(ids, r_rows)
    store.fill_labels(ids, lm)
    ref.fill_labels(ids, r_lm)
    np.testing.assert_array_equal(rows, r_rows)
    np.testing.assert_array_equal(lm, r_lm)
    eager = stack_client_token_rows(token, split, [0, 1, 2, 3])
    np.testing.assert_array_equal(rows, eager[[3, 0, 1]])
    np.testing.assert_array_equal(lm, label_split_masks(lsplit, 4, 50)[[3, 0, 1]])
    with pytest.raises(ValueError, match="row counts"):
        ClientStore.from_split(token, None, {0: [0, 1], 1: [2]}, None, 50, kind="lm")


@pytest.mark.parametrize("items,users,shard", [(10472, 1000, 500), (16, 10, 16), (100, 5000, 16),
                                               (15000, 10_000, 500), (15000, 1_000_000, 500),
                                               (60, 7, 1)])
def test_span_population_matches_reference(items, users, shard):
    """The windows' starts and sizes, bit for bit (10,472 / 1,000 / 500:
    the default stride 9,973 equals ``hi`` and is bumped; 16 / 10 / 16:
    ``hi`` 1, every start 0)."""
    got, ref = span_population(items, users, shard), r_span_population(items, users, shard)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    if (items, users, shard) == (10472, 1000, 500):
        assert len(np.unique(got[0])) == 1000
    with pytest.raises(ValueError):
        span_population(items, users, items + 1)


# --- the schedule commitment ----------------------------------------------------------

@pytest.mark.parametrize("horizon", [0, 1, 2])
def test_schedule_commitment_matches_reference(horizon):
    """``may_draw``, ``state_for`` and ``committed_through`` over the
    driver's sequence (dispatch 1, prefetch, fetch 1, dispatch 2, ...),
    a prefetch queue of 2, equal to the reference's at every step."""
    mine, ref = S.ScheduleCommitment(horizon), RS.ScheduleCommitment(horizon)
    seen = []
    for n in range(1, 9):
        for idx in range(n, n + 3):  # the dispatch and two prefetches
            assert mine.may_draw(idx) == ref.may_draw(idx)
            assert mine.state_for(idx) == ref.state_for(idx)
            seen.append(mine.may_draw(idx))
        if n % 3:  # some fetches come late, two at once
            continue
        for f in range(mine.committed_through + 1, n + 1):
            mine.commit(f, state={"superstep": f})
            ref.commit(f, state={"superstep": f})
            assert mine.committed_through == ref.committed_through == f
    assert True in seen and False in seen
    spec = S.resolve_sampler_cfg({"sample_horizon": horizon})
    assert spec.committed and spec.horizon == horizon
    assert not S.resolve_sampler_cfg({}).committed


# --- the refusals -------------------------------------------------------------------

def _cfg(mod, **over):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name("1_8_0.5_iid_fix_a1-b1_bn_1_1")
    cfg.update({"data_name": "MNIST", "model_name": "conv", **over})
    return cfg


REFUSALS = [
    {"client_store": "mmap"},
    {"client_store": "stream", "strategy": "sliced"},
    {"client_store": "stream", "metrics_fetch_every": 2},
    {"client_store": "stream", "stream_prefetch_depth": 0},
    {"client_store": "stream", "stream_prefetch_depth": True},
    {"client_store": "stream", "stream_prefetch_depth": "2"},
    {"eval_cohort": 0, "client_store": "stream"},
    {"eval_cohort": True, "client_store": "stream"},
    {"eval_cohort": 9, "client_store": "stream"},
    {"eval_cohort": 4},
    {"eval_cohort": 4, "client_store": "stream", "model_name": "transformer",
     "data_name": "WikiText2"},
    {"sample_horizon": -1},
    {"sample_horizon": 1.5},
]


@pytest.mark.parametrize("over", REFUSALS, ids=[str(sorted(o.items())) for o in REFUSALS])
def test_store_refusals_match_reference(over):
    """Each refusal of the store's keys raises the reference's
    ``ValueError`` and message: the reference raises in ``process_control``;
    the port in ``process_control``, or (``metrics_fetch_every`` at K=1) in
    ``resolve_superstep_cfg``, which the experiment calls at construction."""
    with pytest.raises(ValueError) as r:
        RC.process_control(_cfg(RC, **over))

    def port():
        PC.resolve_superstep_cfg(PC.process_control(_cfg(PC, **over)))

    with pytest.raises(ValueError) as p:
        port()
    assert str(p.value) == str(r.value)


def test_store_keys_accepted_and_validated():
    """The keys the reference accepts pass, with its values; a
    ``stream_prefetch`` that is not a bool is refused (the reference takes
    ``bool()`` of it); ``stream_prefetch_depth`` None means 1."""
    ok = dict(client_store="stream", stream_prefetch=False, stream_prefetch_depth=3,
              sample_horizon=1, eval_cohort=4)
    done = PC.process_control(_cfg(PC, **ok))
    assert {k: done[k] for k in ok} == ok
    assert PC.resolve_prefetch_depth({"stream_prefetch_depth": None}) == 1
    assert PC.resolve_store_cfg({}) == "eager"
    with pytest.raises(ValueError, match="stream_prefetch"):
        PC.process_control(_cfg(PC, client_store="stream", stream_prefetch="no"))


# --- population independence, and the ring --------------------------------------------

def _engine():
    cfg = PC.process_control(_cfg(PC, override={"num_epochs": {"local": 1},
                                                "conv": {"hidden_size": [4, 8]}}))
    cfg["classes_size"] = 10
    return RoundEngine(make_model(cfg), cfg, torch.device("cpu")), cfg


def test_stage_memory_scales_with_cohort_not_population():
    """Staging a cohort allocates O(k x A x shard) host bytes whatever the
    population: the ``tracemalloc`` peaks at 2,000 and 200,000 span users
    hold the reference's bounds (tests/test_streaming.py:349-381), the
    cohort's buffers have the same bytes, and the store's metadata is
    ``2 x U x 8`` bytes."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 255, (400, 28, 28, 1)).astype(np.uint8)
    target = rng.integers(0, 10, 400)
    k, A, shard = 2, 4, 16

    def staged_peak(users, seed):
        eng, _ = _engine()
        starts, sizes = span_population(400, users, shard)
        store = ClientStore.from_spans(data, target, starts, sizes, 10)
        sched = np.random.default_rng(seed).integers(0, users, (k, A))
        tracemalloc.start()
        coh = eng.stage_cohort(store, sched)
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        return peak, store, sum(t.numel() * t.element_size() for t in coh.data)

    peak_small, _, bytes_small = staged_peak(2_000, 1)
    peak_large, store_large, bytes_large = staged_peak(200_000, 3)
    cohort_bytes = k * A * shard * (28 * 28 * 1 + 8 + 4)  # x + y + m
    eager_stack_bytes = 200_000 * shard * 28 * 28 * 1
    print(f"parity stage_cohort host peak: {peak_small} B at 2,000 users, {peak_large} B at "
          f"200,000 (cohort {cohort_bytes} B, eager stack {eager_stack_bytes} B)")
    assert peak_large < 50 * cohort_bytes < eager_stack_bytes / 100
    assert peak_large < 4 * max(peak_small, 1 << 20)
    assert bytes_small == bytes_large
    assert store_large.metadata_nbytes == 2 * 200_000 * 8


@pytest.mark.parametrize("depth", [1, 2])
def test_ring_never_changes_a_committed_cohort(depth):
    """``depth + 1`` cohorts staged ahead of any training each keep the
    host gather's bytes; staging one more raises (its slot's cohort was
    neither trained nor released); once the first is released its slot
    takes the next cohort and the others stay as they were."""
    data, target, split, lsplit = _ragged()
    store = ClientStore.from_split(data, target, split, lsplit, 10)
    eng, _ = _engine()
    eng.cfg = dict(eng.cfg, stream_prefetch_depth=depth)
    scheds = [np.array([[i % 3, (i + 1) % 3], [-1, (i + 2) % 3]]) for i in range(depth + 2)]
    cohorts = [eng.stage_cohort(store, s) for s in scheds[:depth + 1]]
    assert eng.cohort_stager().depth == depth

    def check(coh, sched):
        for got, want in zip(coh.data, _fill(store, sched.reshape(-1))):
            np.testing.assert_array_equal(got.numpy(), want)

    for coh, sched in zip(cohorts, scheds):
        check(coh, sched)
    with pytest.raises(RuntimeError, match="still holds a staged cohort"):
        eng.stage_cohort(store, scheds[-1])
    cohorts[0].release()
    last = eng.stage_cohort(store, scheds[-1])
    check(last, scheds[-1])
    for coh, sched in zip(cohorts[1:], scheds[1:]):
        check(coh, sched)
    with pytest.raises(ValueError, match="already trained or released"):
        cohorts[0].open("masked", 2)


def test_stager_is_population_free_on_cpu():
    """The ring's buffers are the cohort's layout and nothing else."""
    data, target, split, lsplit = _ragged()
    store = ClientStore.from_split(data, target, split, lsplit, 10)
    st = CohortStager(torch.device("cpu"), depth=1)
    coh = st.stage("k", store, "masked", np.array([0, 2]), np.array([[0, 2]]), None,
                   np.array([[0, 1]]))
    assert [tuple(t.shape) for t in coh.data] == [(2, 40, 4, 4, 1), (2, 40), (2, 40), (2, 10)]


# --- the rolling Local-eval window ----------------------------------------------------

def _stream_exp(tmp_path, ec=3):
    cfg = PC.process_control(_cfg(
        PC, device="cpu", synthetic=True, synthetic_sizes={"train": 80, "test": 50},
        client_store="stream", eval_cohort=ec, output_dir=str(tmp_path),
        override={"num_epochs": {"global": 2, "local": 1}, "conv": {"hidden_size": [4, 8]}}))
    exp = FedExperiment(cfg, 0)
    split, lsplit = exp.make_splits()
    # ragged test shards: the window pads to the population's largest
    split["test"][5] = split["test"][5][:2]
    exp.stage(split, lsplit)
    return exp, split, lsplit


@pytest.mark.parametrize("widx", [0, 1, 2, 5])
def test_eval_cohort_window_matches_reference_and_host_local(tmp_path, widx):
    """The window's users are the reference's ``_eval_cohort_users`` (a
    window of 3 of 8 users, wrapping), and its fused Local sums equal the
    host Local evaluation over those users' own shards, bit for bit."""
    exp, split, lsplit = _stream_exp(tmp_path)
    users = exp._eval_cohort_users(widx)
    ref = RFedExperiment._eval_cohort_users(SimpleNamespace(eval_cohort=3,
                                                            cfg={"num_users": 8}), widx)
    assert users == ref
    fused = exp._fused_eval(widx)
    params = exp.engine.unflatten(exp.engine.flatten(exp.model.params()))
    out = fused.run(exp.engine.flatten(exp.model.params()), 1)
    te = exp.dataset["test"]
    xu, yu, mu = stack_client_shards(te.data, te.target, split["test"], users)
    ops = stage_local_eval(xu, yu, mu, exp.cfg["batch_size"]["test"]) + (
        label_split_masks({i: lsplit[u] for i, u in enumerate(users)}, 3, 10),)
    host = exp.evaluator.eval_users(params, out["bn"], *map(torch.from_numpy, ops))
    local = fused.assemble([{"bn": {}, "local": out["local"].numpy(),
                             "global": out["global"].numpy()}], [1])[0]["local"]
    for name in ("loss_sum", "score_sum", "n"):
        np.testing.assert_array_equal(local[name], host[name], err_msg=name)
    assert fused.n_users == 3
    # a second window reuses the same operands and graphs
    again = exp._fused_eval(widx + 1)
    assert again is fused and exp._eval_widx == widx + 1
