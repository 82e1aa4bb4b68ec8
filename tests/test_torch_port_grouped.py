"""The grouped engine of the PyTorch/CUDA port (``strategy='grouped'``, each
level's clients batched through its dense sub-model) and its sliced twin
against the JAX reference's ``GroupedRoundEngine.train_round`` on the CPU
(``make_mesh(1, 1)``; Pallas BN in interpret mode where the case asks for
it): the same initial params, users and rates, the reference's epoch
permutations, augmentation draws and LM corruption and dropout draws
handed in (the reference's grouped clients draw from the masked engine's
client keys, so ``reference_draws`` gives them; an LM client's dropout has
its level's widths).  Cases: the conv net with levels a-e and two clients
at level a (batched BN kernels' plain versions), ResNet-18 with CIFAR
augmentation (the plain two-pass BN), rates from a dynamic draw, and the
LM at levels a-c.  Tolerances are the masked-round parity tests': new
params atol 5e-5, the metric sums rtol/atol 1e-4, ``n`` and rates exact.
Within the port, grouped equals masked and sliced at rtol 5e-4, atol 5e-5
(the reference's own contract, tests/test_grouped.py:72-82); the
refusals; and the entry point end to end, resumed equal to an
uninterrupted run."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.compress import resolve_codec_cfg as r_resolve_codec
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import label_split_masks as r_lsm
from heterofl_tpu.data import split_dataset as r_split
from heterofl_tpu.data import stack_client_shards as r_stack
from heterofl_tpu.fed.core import client_stream_keys
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.parallel import GroupedRoundEngine as RGroupedRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress import resolve_codec_cfg
from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
from heterofl_tpu_torch.entry import train_classifier_fed
from heterofl_tpu_torch.entry.common import FedExperiment
from heterofl_tpu_torch.fed.sliced import SlicedFederation
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from test_torch_port_lm import BPTT, SMALL, V, draws_of
from test_torch_port_lm import _cfg as lm_cfg
from test_torch_port_round import reference_draws

few_threads = thread_limit_fixture()

LR = 0.05
TOL_GROUPED = (5e-4, 5e-5)  # rtol, atol of grouped == masked == sliced (reference contract)


def _cfg(mod, control, model_name="conv", data_name="MNIST", pallas=False, local=2):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(control)
    cfg["data_name"], cfg["model_name"], cfg["pallas_norm"] = data_name, model_name, pallas
    cfg["override"] = {"num_epochs": {"local": local}, "conv": {"hidden_size": [8, 16]},
                       "resnet": {"hidden_size": [8, 16, 16, 16]}}
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def _vision_data(data_name, users, n_train, short=None):
    ds = r_fetch(data_name, synthetic=True, seed=0,
                 synthetic_sizes={"train": n_train, "test": 10})
    split, lsplit = r_split(ds, users, "iid", np.random.default_rng(0), classes_size=10)
    if short is not None:  # a client with a half-padding and an all-padding batch
        uid, n = short
        split["train"][uid] = split["train"][uid][:n]
    return r_stack(ds["train"].data, ds["train"].target, split["train"], list(range(users))) + \
        (r_lsm(lsplit, users, 10),)


def _reference_grouped(rcfg, arrays, users, rates, key=3, lr=LR, params_np=None):
    """One ``GroupedRoundEngine.train_round`` of the reference from its own
    init (key 0) or ``params_np`` -> (initial params, new params, sums)."""
    rmodel = r_make_model(rcfg)
    if params_np is None:
        params_np = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    eng = RGroupedRoundEngine(rcfg, make_mesh(1, 1))
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in params_np.items()},
                                  np.asarray(users, np.int32), np.asarray(rates, np.float32),
                                  tuple(jnp.asarray(a) for a in arrays), lr,
                                  jax.random.key(key))
    return (params_np, {k: np.asarray(v) for k, v in r_new.items()},
            {k: np.asarray(v) for k, v in r_ms.items()})


def _port_round(engine, pcfg, params_np, arrays, users, **hooks):
    """The port's round of ``engine`` from the reference's params -> (new
    params in the reference's layout, metric sums)."""
    model = make_model(pcfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(params_np, perms))
    eng = engine(model, pcfg, torch.device("cpu"))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    new, ms = eng.train_round(eng.flatten(model.params()), LR, users, data, round_seed=0,
                              **hooks)
    return params_to_jax(eng.unflatten(new), perms), ms


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).ravel() for k in sorted(tree)])


def assert_grouped_matches(case, p_new, ms, r_new, r_ms):
    assert sorted(p_new) == sorted(r_new)
    assert_close(f"{case}: new global params", _flat(p_new), _flat(r_new), rtol=0, atol=5e-5)
    assert_close(f"{case}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
    for k in ("loss_sum", "score_sum"):
        assert_close(f"{case}: {k}", ms[k], r_ms[k], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ms["rate"], r_ms["rate"])


CONV = "1_6_1_iid_fix_a2-b1-c1-d1-e1_bn_1_1"  # users 0, 1 at level a; then b, c, d, e


@pytest.fixture(scope="module")
def conv_round():
    """The reference's grouped round of the conv net (Pallas BN in
    interpret mode), 6 users, one with a short shard, and its draws."""
    rcfg = _cfg(RC, CONV, pallas=True)
    arrays = _vision_data("MNIST", 6, 360, short=(1, 45))
    users = np.arange(6)
    rates = np.asarray(rcfg["model_rate"], np.float32)[users]
    params_np, r_new, r_ms = _reference_grouped(rcfg, arrays, users, rates)
    perms, _ = reference_draws(jax.random.key(3), users, 2, arrays[0].shape[1])
    return params_np, arrays, users, perms, r_new, r_ms


@pytest.fixture(scope="module")
def conv_grouped(conv_round):
    """The port's grouped round of the same case."""
    params_np, arrays, users, perms, _, _ = conv_round
    return _port_round(GroupedRoundEngine, _cfg(PC, CONV, pallas=True), params_np, arrays,
                       users, epoch_perms=perms)


def test_grouped_conv_round_matches_reference(conv_round, conv_grouped):
    """Conv net, levels a-e, two clients batched at level a (the batched BN
    and fused SGD kernels' plain versions): the port's grouped round equals
    the reference's at the round's tolerance; the short client's all-padding
    batches are gated off (its ``n`` is its real samples)."""
    r_new, r_ms = conv_round[4:]
    p_new, ms = conv_grouped
    assert_grouped_matches("grouped conv round (levels a-e, G=2 at a)", p_new, ms, r_new, r_ms)
    assert ms["n"][1].item() == 45.0 * 2


@pytest.mark.parametrize("engine", ["masked", "sliced"])
def test_grouped_equals_masked_and_sliced(conv_round, conv_grouped, engine):
    """Within the port, from the same params and draws: the grouped round
    equals the masked engine's and the sliced twin's at rtol 5e-4, atol
    5e-5, and their ``n`` exactly."""
    params_np, arrays, users, perms, _, _ = conv_round
    pcfg = _cfg(PC, CONV, pallas=True)
    g_new, g_ms = conv_grouped
    other = {"masked": RoundEngine, "sliced": SlicedFederation}[engine]
    o_new, o_ms = _port_round(other, pcfg, params_np, arrays, users, epoch_perms=perms)
    assert_close(f"port grouped vs port {engine}: new global params", _flat(g_new),
                 _flat(o_new), rtol=TOL_GROUPED[0], atol=TOL_GROUPED[1])
    assert_close(f"port grouped vs port {engine}: loss_sum", g_ms["loss_sum"], o_ms["loss_sum"],
                 rtol=1e-4, atol=1e-4)
    assert torch.equal(g_ms["n"], o_ms["n"])


def test_grouped_resnet18_round_with_augmentation_matches_reference():
    """ResNet-18 (8/16/16/16, the plain two-pass BN), two level-a clients
    and one level-e client, 4 local steps each, CIFAR augmentation on: with
    the reference's permutations and crop/flip draws, the port's grouped
    round equals the reference's grouped round.  (At 60 images, 2 steps a
    client, both packages' rounds part by 1.6e-4 on params through a ReLU
    gate that float32 rounding sets either way:
    ``test_resnet18_60_image_gap_is_one_relu_gate``.)"""
    control = "1_3_1_iid_fix_a2-e1_bn_1_1"
    rcfg = _cfg(RC, control, "resnet18", "CIFAR10", local=1)
    arrays = _vision_data("CIFAR10", 3, 120)
    users = np.arange(3)
    rates = np.asarray(rcfg["model_rate"], np.float32)[users]
    B, N = rcfg["batch_size"]["train"], arrays[0].shape[1]
    assert math.ceil(N / B) == 4
    params_np, r_new, r_ms = _reference_grouped(rcfg, arrays, users, rates)
    perms, aug = reference_draws(jax.random.key(3), users, 1, N, B, 4)
    p_new, ms = _port_round(GroupedRoundEngine, _cfg(PC, control, "resnet18", "CIFAR10", local=1),
                            params_np, arrays, users, epoch_perms=perms, aug_draws=aug)
    assert_grouped_matches("grouped ResNet-18 round, augmentation on", p_new, ms, r_new, r_ms)


# the pre-activation of ``layer2.0.n1`` (NCHW index) that sits 1.5e-6 above zero in
# the first step of client 0 below, and the value the reference computes for it
GATE_SITE, GATE_AT, GATE_REF = "layer2.0.n1", (3, 0, 13, 1), -3.3664085e-06


def test_resnet18_60_image_gap_is_one_relu_gate(monkeypatch):
    """At 60 images (control ``1_3_1_iid_fix_a2-e1_bn_1_1``, 20 a client,
    2 steps) the port's ResNet-18 round, masked or grouped, ends 1.6e-4 from
    the reference's on params, above the round's 5e-5 (clients 0 and 1;
    client 1's first step shows the same pattern, a bias gradient alone
    apart at ``layer2.1.n2`` and ``layer0.0.n2``, not pinned here).  The
    cause in client 0's first step is one ReLU gate: a pre-activation of
    ``layer2.0.n1`` is 1.5e-6 above zero in float64, so the float32
    rounding of either package's sums (1e-5 apart at that depth) decides
    whether the gate opens.  The port opens it, as float64 does; the
    reference closes it, and that one element moves the site's bias
    gradient by 4e-3.  Held here on that step's gradient: the port's
    float32 gradient equals its float64 one; against the reference's it
    differs on that bias beyond the gradient tolerance (the gap); with that
    one element set to the reference's value, it equals the reference's at
    the gradient tolerance (1e-3, 2e-5)."""
    import heterofl_tpu_torch.models.resnet as port_resnet

    control = "1_3_1_iid_fix_a2-e1_bn_1_1"
    rcfg = _cfg(RC, control, "resnet18", "CIFAR10", local=1)
    pcfg = _cfg(PC, control, "resnet18", "CIFAR10", local=1)
    x, y, sm, lm = _vision_data("CIFAR10", 3, 60)
    rmodel = r_make_model(rcfg)
    params_np = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    perms, aug = reference_draws(jax.random.key(3), np.arange(3), 1, 20, 10, 2)
    perm = perms[0][0]
    ids = perm[np.argsort(-sm[0][perm], kind="stable")][:10]  # client 0's first batch
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params_np))
    eng = RoundEngine(model, pcfg, torch.device("cpu"))
    img = eng._prep(torch.from_numpy(x[0][ids]), None,
                    tuple(torch.as_tensor(np.array(a)) for a in aug(0, 0)))

    def ref_grads():
        def loss_fn(p):
            out, _ = rmodel.apply(p, {"img": jnp.asarray(img.permute(0, 2, 3, 1).numpy()),
                                      "label": jnp.asarray(y[0][ids])}, train=True,
                                  label_mask=jnp.asarray(lm[0]), sample_weight=jnp.ones(10),
                                  rng=jax.random.key(1))
            return out["loss"] * 10
        g = jax.grad(loss_fn)({k: jnp.asarray(v) for k, v in params_np.items()})
        return {k: np.asarray(v) for k, v in g.items()}

    seen = {}

    def port_grads(dtype, gate=None):
        leaves = {k: v.detach().to(dtype).clone().requires_grad_()
                  for k, v in model.params().items()}
        apply_norm = port_resnet.apply_norm

        def norm(kind, xs, g, b, **kw):
            out, st = apply_norm(kind, xs, g, b, **kw)
            if g is leaves[f"{GATE_SITE}.g"]:
                seen[dtype] = float(out[GATE_AT])
                if gate is not None:  # that element only, the gradient unchanged
                    one = torch.zeros_like(out)
                    one[GATE_AT] = 1.0
                    out = out + one * (gate - out.detach())
            return out, st

        monkeypatch.setattr(port_resnet, "apply_norm", norm)
        _, loss = model(img.to(dtype), torch.from_numpy(y[0][ids]), params=leaves,
                        label_mask=torch.from_numpy(lm[0]).to(dtype),
                        sample_weight=torch.ones(10, dtype=dtype))
        grads = torch.autograd.grad(loss * 10, list(leaves.values()))
        monkeypatch.setattr(port_resnet, "apply_norm", apply_norm)
        return params_to_jax({k: g.to(torch.float32) for k, g in zip(leaves, grads)})

    ref = ref_grads()
    p32, p64 = port_grads(torch.float32), port_grads(torch.float64)
    assert 0.0 < seen[torch.float64] < 1e-5 and 0.0 < seen[torch.float32] < 1e-5, seen
    assert_close("ResNet-18 60 images, step-0 gradient: port float32 vs float64", _flat(p32),
                 _flat(p64), rtol=1e-3, atol=2e-5)
    bias = f"{GATE_SITE}.b"
    gap = float(np.abs(p32[bias] - ref[bias]).max())
    print(f"parity ResNet-18 60 images, step-0 {bias} gradient, port vs reference: "
          f"max_abs_err {gap:.3e} (the open gate)")
    assert gap > 1e-3
    closed = port_grads(torch.float32, gate=GATE_REF)
    assert_close("ResNet-18 60 images, step-0 gradient, the gate set as the reference's",
                 _flat(closed), _flat(ref), rtol=1e-3, atol=2e-5)


def test_grouped_dynamic_round_matches_reference():
    """A ``dynamic`` control with the rates of a draw (two clients at level
    c, none at b) handed to both engines: the port's grouped round equals
    the reference's."""
    control = "1_4_1_iid_dynamic_a1-b1-c1-e1_bn_1_1"
    rcfg = _cfg(RC, control)
    arrays = _vision_data("MNIST", 4, 400)
    users = np.array([2, 0, 3, 1])
    rates = np.asarray([0.25, 1.0, 0.25, 0.0625], np.float32)
    params_np, r_new, r_ms = _reference_grouped(rcfg, arrays, users, rates)
    perms, _ = reference_draws(jax.random.key(3), users, 2, arrays[0].shape[1])
    p_new, ms = _port_round(GroupedRoundEngine, _cfg(PC, control), params_np, arrays, users,
                            epoch_perms=perms, rates=rates)
    assert_grouped_matches("grouped dynamic round", p_new, ms, r_new, r_ms)


def _lm_rows():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, V, size=(4, 2, 40)).astype(np.int64)
    lm = np.ones((4, V), np.float32)
    lm[3, ::4] = 0.0
    return rows, lm


def test_grouped_lm_round_matches_reference():
    """The LM at levels a (two clients), b and c, dropout 0.2: with the
    reference's corruption and dropout draws at each level's widths, the
    port's grouped round equals the reference's grouped round; and the
    port's sliced twin equals its grouped round."""
    control = "1_4_1_iid_fix_a2-b1-c1_bn_1_1"
    rcfg = lm_cfg(RC, control)
    rows, lm = _lm_rows()
    users = np.arange(4)
    rates = np.asarray(rcfg["model_rate"], np.float32)[users]
    rmodel = r_make_model(rcfg)
    params_np = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    _, r_new, r_ms = _reference_grouped(rcfg, (rows, lm), users, rates, key=7, lr=LR,
                                        params_np=params_np)
    slot_keys = client_stream_keys(jax.random.key(7), jnp.asarray(users))
    t = SMALL["transformer"]
    cache = {}

    def lm_draws(uid, step):
        if (uid, step) not in cache:
            r = float(rates[uid])
            cache[uid, step] = draws_of(jax.random.fold_in(slot_keys[uid], 5000 + step),
                                        rows.shape[1], BPTT,
                                        width=math.ceil(t["embedding_size"] * r),
                                        ffn=math.ceil(t["hidden_size"] * r))
        return cache[uid, step]

    pcfg = lm_cfg(PC, control)
    model = make_model(pcfg)
    perms = model.jax_perms()
    out = {}
    for name, engine in (("grouped", GroupedRoundEngine), ("sliced", SlicedFederation)):
        model.load_state_dict(params_from_jax(params_np, perms))
        eng = engine(model, pcfg, torch.device("cpu"))
        new, ms = eng.train_round(eng.flatten(model.params()), LR, users,
                                  (torch.from_numpy(rows), torch.from_numpy(lm)), round_seed=0,
                                  lm_draws=lm_draws)
        out[name] = (params_to_jax(eng.unflatten(new), perms), ms)
    assert_grouped_matches("grouped LM round (levels a-c)", *out["grouped"], r_new, r_ms)
    assert_close("port grouped vs port sliced LM round: new global params",
                 _flat(out["grouped"][0]), _flat(out["sliced"][0]), rtol=TOL_GROUPED[0],
                 atol=TOL_GROUPED[1])
    np.testing.assert_array_equal(out["grouped"][0]["embedding.tok.w"][V],
                                  params_np["embedding.tok.w"][V])


def test_grouped_lm_round_equals_masked_without_dropout():
    """With dropout 0 the LM's only draws are the token corruption, whose
    shape has no width: the port's grouped LM round equals its masked one
    at rtol 5e-4, atol 5e-5."""
    control = "1_4_1_iid_fix_a2-b1-c1_bn_1_1"
    pcfg = lm_cfg(PC, control, transformer={**SMALL["transformer"], "dropout": 0.0})
    rows, lm = _lm_rows()
    model = make_model(pcfg).init_(torch.Generator().manual_seed(0))
    data = (torch.from_numpy(rows), torch.from_numpy(lm))
    out = []
    for engine in (GroupedRoundEngine, RoundEngine):
        eng = engine(model, pcfg, torch.device("cpu"))
        out.append(eng.train_round(eng.flatten(model.params()), LR, [0, 1, 2, 3], data, 5)[0])
    assert_close("port grouped vs port masked LM round, dropout 0: new global params", out[0],
                 out[1], rtol=TOL_GROUPED[0], atol=TOL_GROUPED[1])


# --- refusals and the entry point ------------------------------------------------------

def test_grouped_refusals_match_reference():
    """A lossy codec with ``grouped`` at K=1 and a codec with ``sliced`` are
    refused by both packages (``ValueError``, the reference experiment loop's
    reasons); so is an unknown strategy; ``level_placement='slices'`` is
    accepted with ``grouped`` and refused with another strategy, in both
    packages; the engines refuse a codec too."""
    base = {"wire_codec": "int8"}
    for strategy, match in (("grouped", "K=1 host-orchestrated path"), ("sliced", "sliced")):
        cfg = dict(base, strategy=strategy)
        with pytest.raises(ValueError, match=match):
            r_resolve_codec(cfg)
        with pytest.raises(ValueError, match=match):
            resolve_codec_cfg(cfg)
    lossy_map = {"wire_codec": {"1.0": "int8", "0.0625": "dense"}, "strategy": "grouped"}
    for resolve in (r_resolve_codec, resolve_codec_cfg):
        with pytest.raises(ValueError, match="K=1 host-orchestrated path"):
            resolve(lossy_map)
    assert resolve_codec_cfg({"wire_codec": {"1.0": "dense"}, "strategy": "grouped"})[0] \
        == "dense"
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name(CONV)
    with pytest.raises(ValueError, match="strategy"):
        RC.resolve_strategy_cfg(dict(cfg, strategy="banded"))
    with pytest.raises(ValueError, match="strategy"):
        PC.process_control(dict(cfg, strategy="banded"))
    assert PC.process_control(dict(cfg, strategy="grouped", level_placement="slices"))[
        "level_placement"] == "slices"
    for mod in (PC, RC):
        with pytest.raises(ValueError, match="level_placement='slices' with strategy='sliced'"):
            mod.resolve_placement_cfg(dict(cfg, strategy="sliced", level_placement="slices"))
    pcfg = dict(_cfg(PC, CONV), wire_codec="int8")
    model = make_model(pcfg)
    for engine, match in ((GroupedRoundEngine, "K=1 host-orchestrated path"),
                          (SlicedFederation, "sliced")):
        with pytest.raises(ValueError, match=match):
            engine(model, pcfg, torch.device("cpu"))


COHORTS = {1: [0, 2, 3], 2: [1, 3, 0], 3: [2, 1, 3]}


def _argv(out_dir, rounds, *extra):
    return ["--device", "cpu", "--output_dir", str(out_dir), "--strategy", "grouped",
            "--control_name", "1_4_1_iid_fix_a2-c1-e1_bn_1_1", "--data_name", "MNIST",
            "--model_name", "conv", "--synthetic", "1", "--pallas_norm", "1",
            "--synthetic_sizes", '{"train": 200, "test": 40}',
            "--override", json_override(rounds), *extra]


def json_override(rounds):
    return ('{"num_epochs": {"global": %d, "local": 1}, "conv": {"hidden_size": [8, 16]}}'
            % rounds)


def test_grouped_entry_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """``train_classifier_fed --strategy grouped --device cpu``: three rounds
    in one run, and two rounds then a resumed third (cohorts pinned, a
    resumed run restarts the numpy stream): the resumed run trains round 3
    only and its params and logger history equal the uninterrupted run's
    bit for bit; every round is finite and levels a, c and e train."""
    monkeypatch.setattr(FedExperiment, "sample_users",
                        lambda self, epoch: np.array(COHORTS[epoch], np.int64))
    (full,) = train_classifier_fed.main(_argv(tmp_path / "full", 3))
    assert isinstance(FedExperiment(dict(PC.process_control(dict(
        PC.default_cfg(), control=PC.parse_control_name("1_4_1_iid_fix_a2-c1-e1_bn_1_1"),
        data_name="MNIST", model_name="conv", strategy="grouped", device="cpu",
        synthetic=True, synthetic_sizes={"train": 200, "test": 40}))), 0).engine,
        GroupedRoundEngine)
    train_classifier_fed.main(_argv(tmp_path / "cut", 2))
    (res,) = train_classifier_fed.main(_argv(tmp_path / "cut", 3, "--resume_mode", "1"))
    assert [r["epoch"] for r in res["history"]] == [3]
    for k, v in full["params"].items():
        assert torch.equal(res["params"][k], v), k
    hist = lambda r: {k: list(v) for k, v in r["logger"].history.items()}  # noqa: E731
    assert hist(res) == hist(full) and len(hist(res)["train/Local-Loss"]) == 3
    assert all(math.isfinite(r["loss"]) and r["n"] > 0 for r in full["history"])
    assert sorted({x for r in full["history"] for x in r["rates"]}) == [0.0625, 0.25, 1.0]
    print("parity grouped entry, resumed round 3 vs uninterrupted: max_abs_err 0 (bit for bit)")
