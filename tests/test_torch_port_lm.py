"""The masked-LM path of the PyTorch/CUDA port against the JAX reference on
the CPU: the token data (synthetic stream, batchify, bptt windows, the iid
split of token rows, the on-disk reader), the per-head width masks and the
count mask, the layout-aware conversion, the transformer's forward and
gradients, one LM round, the Global-Perplexity evaluation and two
centralised epochs.

Small config: vocabulary 50, E 128, 4 heads, FFN 64, 2 layers, bptt 16,
dropout 0.2, mask rate 0.15. E 128, not 32: level e (rate 0.0625) keeps
``ceil(E / 16)`` embedding dims, and at E 32 that is 2 -- the reference's
attention temperature ``sqrt(floor(k_emb / H))`` is then 0 with four heads
(NaN in both packages), and with two heads a round is chaotic (the Scaler's
x16 on q and k saturates the attention, and the layer norms run over 2
dims): a one-ulp change of the params moves the port's own round by 2e-5 in
three steps. At E 128 level e keeps 8 dims (2 a head). The reference's
``jax.random`` draws (token corruption ``fold_in(rng, 0)``, dropout
``fold_in(fold_in(rng, 1), site)``) are handed to the port, so both sides
see the same masks. Tolerances: the vision parity tests' (the model: scores
and loss rtol 1e-4, atol 1e-5, gradients rtol 1e-3, atol 2e-5; params atol
5e-5, sums rtol/atol 1e-4, counts exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.data import datasets as rds
from heterofl_tpu.data import pipeline as rpipe
from heterofl_tpu.data.partition import iid as r_iid
from heterofl_tpu.entry.central import CentralEngine as RCentralEngine
from heterofl_tpu.fed.core import client_stream_keys
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.models.spec import mask_params as r_mask_params
from heterofl_tpu.models.spec import param_mask as r_param_mask
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu.parallel.evaluation import Evaluator as REvaluator
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import (flat_from_jax, flat_to_jax, params_from_jax,
                                        params_to_jax)
from heterofl_tpu_torch.data import datasets as pds
from heterofl_tpu_torch.data import pipeline as ppipe
from heterofl_tpu_torch.data.partition import iid as p_iid
from heterofl_tpu_torch.entry.central import CentralEngine
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.models.spec import mask_params, param_mask
from heterofl_tpu_torch.parallel import Evaluator, RoundEngine
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture

few_threads = thread_limit_fixture()

V, E, H, F, L, BPTT, DROP, MR = 50, 128, 4, 64, 2, 16, 0.2, 0.15
SMALL = {"transformer": {"embedding_size": E, "num_heads": H, "hidden_size": F,
                         "num_layers": L, "dropout": DROP}, "bptt": BPTT}
CONTROL = "1_4_1_iid_fix_a1-b1-c1-e1_bn_1_1"  # rates 1, 0.5, 0.25, 0.0625
LR = 0.1


def _cfg(mod, control=CONTROL, **override):
    """The small config; the LM control's own single local epoch."""
    cfg = mod.default_cfg()
    cfg.update(control=mod.parse_control_name(control), data_name="WikiText2",
               model_name="transformer", override={**SMALL, **override})
    cfg = mod.process_control(cfg)
    cfg["num_tokens"] = cfg["classes_size"] = V
    return cfg


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


def draws_of(rng, n, s, train=True, width=E, ffn=F):
    """The reference transformer's draws for one forward with key ``rng``
    (heterofl_tpu/models/transformer.py:130-154), as the port's ``draws``."""
    out = {"corrupt": torch.from_numpy(np.array(
        jax.random.bernoulli(jax.random.fold_in(rng, 0), MR, (n, s))))}
    if train:
        base = jax.random.fold_in(rng, 1)
        out["keep"] = {
            site: torch.from_numpy(np.array(jax.random.bernoulli(
                jax.random.fold_in(base, site), 1.0 - DROP,
                (n, s, ffn if site % 3 == 2 else width))))
            for site in range(1 + 3 * L)}
    return out


# --- configuration and data --------------------------------------------------------

@pytest.mark.parametrize("control", ["1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1",
                                     "1_1_1_none_fix_a1_bn_1_1"])
def test_process_control_lm_matches_reference(control):
    """The LM block: optimizer, lr, momentum, wd, MultiStepLR milestones,
    bptt 64, mask rate 0.15, epochs and batch sizes, and the transformer's
    architecture table."""
    out = []
    for mod in (PC, RC):
        cfg = mod.default_cfg()
        cfg.update(control=mod.parse_control_name(control), data_name="WikiText2",
                   model_name="transformer")
        out.append(mod.process_control(cfg))
    keys = ("num_epochs", "batch_size", "milestones", "lr", "optimizer_name", "momentum",
            "weight_decay", "scheduler_name", "factor", "bptt", "mask_rate", "transformer",
            "model_rate", "global_model_rate")
    assert {k: out[0][k] for k in keys} == {k: out[1][k] for k in keys}
    with pytest.raises(ValueError, match="data_split_mode"):
        cfg = PC.default_cfg()
        cfg.update(control=PC.parse_control_name("1_100_0.1_non-iid-2_fix_a1_bn_1_1"),
                   data_name="WikiText2")
        PC.process_control(cfg)


@pytest.mark.parametrize("split,n,vocab,seed", [("train", 5003, 50, 0), ("test", 4097, 512, 3),
                                                ("train", 1, 512, 1)])
def test_synthetic_lm_and_windows_exact(split, n, vocab, seed):
    """The synthetic stream element for element, then ``batchify``,
    ``bptt_windows`` and ``stack_windows`` (the zero-weighted short tail)."""
    ref = rds.synthetic_lm("WikiText2", split, n, vocab, seed)
    port = pds.synthetic_lm("WikiText2", split, n, vocab, seed)
    assert_close(f"synthetic_lm {split} n={n} vocab={vocab}: tokens", port.token, ref.token,
                 rtol=0, atol=0)
    assert port.token.dtype == ref.token.dtype and len(port.vocab) == len(ref.vocab)
    assert port.vocab.index_to_symbol == ref.vocab.index_to_symbol
    if n < 8:
        return
    rows = ppipe.batchify(port.token, 7)
    np.testing.assert_array_equal(rows, rpipe.batchify(ref.token, 7))
    for a, b in zip(ppipe.bptt_windows(rows, BPTT), rpipe.bptt_windows(rows, BPTT)):
        np.testing.assert_array_equal(a, b)
    xs, ws = ppipe.stack_windows(ppipe.bptt_windows(rows, BPTT), BPTT)
    rxs, rws = rpipe.stack_windows(rpipe.bptt_windows(rows, BPTT), BPTT)
    assert_close(f"stack_windows n={n}: windows", xs, rxs, rtol=0, atol=0)
    assert_close(f"stack_windows n={n}: weights", ws, rws, rtol=0, atol=0)
    assert ws[-1].sum() == 7 * (rows.shape[1] % BPTT or BPTT)


def test_process_dataset_and_token_row_split_exact():
    """``process_dataset`` batchifies each split at its batch size and sets
    ``num_tokens``/``classes_size`` from the vocabulary; the iid split of
    the token rows (labels = the tokens of each user's rows) and
    ``stack_client_token_rows`` equal the reference's."""
    cfg = _cfg(PC)
    rcfg = _cfg(RC)
    sizes = {"train": 3000, "test": 700}
    port = pds.fetch_dataset("WikiText2", synthetic=True, seed=2, synthetic_sizes=sizes)
    ref = rds.fetch_dataset("WikiText2", synthetic=True, seed=2, synthetic_sizes=sizes)
    pcfg, pset = ppipe.process_dataset(cfg, port)
    rcfg, rset = rpipe.process_dataset(rcfg, ref)
    assert pcfg["num_tokens"] == rcfg["num_tokens"] == pcfg["classes_size"] == 512
    for s in ("train", "test"):
        np.testing.assert_array_equal(pset[s].token, rset[s].token)
    assert pset["train"].token.shape == (100, 30) and pset["test"].token.shape == (10, 70)
    users = 4
    p_ds, p_ls = p_iid(pset["train"], users, np.random.default_rng(5))
    r_ds, r_ls = r_iid(rset["train"], users, np.random.default_rng(5))
    assert p_ds == r_ds and p_ls == r_ls
    assert_close("iid split of token rows: stacked rows",
                 ppipe.stack_client_token_rows(pset["train"].token, p_ds, [0, 3]),
                 rpipe.stack_client_token_rows(rset["train"].token, r_ds, [0, 3]), rtol=0, atol=0)


def test_on_disk_token_reader_exact(tmp_path):
    """The WikiText2 reader on token files written here: whitespace tokens
    plus ``<eos>`` per line, the vocabulary from the train file only (a
    test-only symbol maps to ``<ukn>``), under ``wikitext-2/``."""
    root = tmp_path / "WikiText2" / "wikitext-2"
    root.mkdir(parents=True)
    (root / "wiki.train.tokens").write_text(" = Valkyria = \n the game began \n\n a game \n")
    (root / "wiki.test.tokens").write_text(" the Valkyria began unseen \n")
    port = pds.fetch_dataset("WikiText2", str(tmp_path))
    for split in ("train", "test"):
        ref = rds._load_lm(str(tmp_path / "WikiText2"), split, "WikiText2")
        assert_close(f"on-disk reader, {split}: tokens", port[split].token, ref.token, rtol=0,
                     atol=0)
        assert port[split].vocab.index_to_symbol == ref.vocab.index_to_symbol
    assert port["test"].token.tolist()[-2:] == [0, 1]  # "unseen" -> <ukn>, then <eos>
    with pytest.raises(FileNotFoundError, match="synthetic"):
        pds.fetch_dataset("WikiText2", str(tmp_path / "absent"))


# --- masks and conversion ------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_model():
    """The reference transformer at full width and its initial params."""
    rcfg = _cfg(RC)
    rmodel = r_make_model(rcfg)
    return rcfg, rmodel, _np(jax.jit(rmodel.init)(jax.random.key(0)))


@pytest.mark.parametrize("wr", [1.0, 0.5, 0.25, 0.0625])
def test_per_head_and_count_masks_exact(ref_model, wr):
    """Width masks (q/k/v per head) and count masks (a label mask shorter
    than the token embedding: its ``<mask>`` row counts zero) equal the
    reference's leaf for leaf, in its layout."""
    rcfg, rmodel, _ = ref_model
    model = make_model(_cfg(PC))
    assert model.groups["qkv"].kind == "per_head"
    lm = (np.random.default_rng(1).random(V) < 0.6).astype(np.float32)
    shapes = {k: tuple(p.shape) for k, p in model.params().items()}
    perms = model.jax_perms()
    pm = params_to_jax({k: param_mask(s, model.specs[k], model.groups, wr)
                        for k, s in shapes.items()}, perms)
    cm = params_to_jax({k: param_mask(s, model.specs[k], model.groups, wr, torch.from_numpy(lm))
                        for k, s in shapes.items()}, perms)
    names = sorted(pm)
    r_pm, r_cm = [], []
    for k in names:
        shape, spec = pm[k].shape, rmodel.specs[k]
        r_pm.append(np.asarray(r_param_mask(shape, spec, rmodel.groups, wr)).ravel())
        r_cm.append(np.asarray(r_param_mask(shape, spec, rmodel.groups, wr, jnp.asarray(lm),
                                            with_label=True)).ravel())
    assert_close(f"width masks at width {wr}", np.concatenate([pm[k].ravel() for k in names]),
                 np.concatenate(r_pm), rtol=0, atol=0)
    assert_close(f"count masks at width {wr}", np.concatenate([cm[k].ravel() for k in names]),
                 np.concatenate(r_cm), rtol=0, atol=0)
    assert not cm["embedding.tok.w"][V].any()  # the <mask> row
    hd = E // H
    q = pm["enc0.mha.q.w"][0]  # [E_out] in the reference's [in, out]
    keep = int(np.ceil(np.float32(hd) * np.float32(wr)))
    np.testing.assert_array_equal(q.reshape(H, hd)[:, :keep], 1.0)
    np.testing.assert_array_equal(q.reshape(H, hd)[:, keep:], 0.0)


def test_convert_transformer_exact(ref_model):
    """Params and a flat residual cross both ways exactly; the linear
    kernels are transposed, the embedding tables are not."""
    _, _, rp = ref_model
    model = make_model(_cfg(PC))
    perms = model.jax_perms()
    state = params_from_jax(rp, perms)
    model.load_state_dict(state)
    for k, v in params_to_jax(state, perms).items():
        np.testing.assert_array_equal(v, rp[k], err_msg=k)
    np.testing.assert_array_equal(state["embedding.tok.w"].numpy(), rp["embedding.tok.w"])
    np.testing.assert_array_equal(state["embedding.pos.w"].numpy(), rp["embedding.pos.w"])
    np.testing.assert_array_equal(state["dec.l2.w"].numpy(), rp["dec.l2.w"].T)
    assert tuple(state["dec.l2.w"].shape) == (V, E) and "embedding.tok.w" not in perms
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    flat = np.random.default_rng(0).normal(size=(2, sum(v.size for v in rp.values())))
    flat = flat.astype(np.float32)
    back = flat_to_jax(flat_from_jax(flat, shapes, perms), shapes, perms)
    assert_close("convert: flat residual round trip", back, flat, rtol=0, atol=0)
    port_flat = np.concatenate([state[k].numpy().ravel() for k in sorted(state)])
    ref_flat = np.concatenate([rp[k].ravel() for k in sorted(rp)])
    assert_close("convert: params to the reference's flat layout",
                 flat_to_jax(port_flat, shapes, perms), ref_flat, rtol=0, atol=0)


# --- the model ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_grads(ref_model):
    """The reference's training loss, scores and gradients, jitted once
    for every width."""
    rmodel = ref_model[1]

    def loss_fn(p, lab, wr, lm, w, key):
        out, _ = rmodel.apply(p, {"label": lab}, train=True, width_rate=wr, scaler_rate=wr,
                              label_mask=lm, sample_weight=w, rng=key)
        return out["loss"], out["score"]

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("wr", [1.0, 0.0625])
def test_transformer_forward_and_grads_match_reference(ref_model, ref_grads, wr):
    """One training forward and backward at level a and level e from the
    same masked params, label mask, position weights (a padded tail) and
    draws: scores and loss rtol 1e-4, atol 1e-5, every leaf's gradient rtol
    1e-3, atol 2e-5 (the vision models' parity tolerances)."""
    _, rmodel, rp = ref_model
    model = make_model(_cfg(PC))
    perms = model.jax_perms()
    rng = np.random.default_rng(3)
    lab = rng.integers(0, V, (3, BPTT))
    w = np.ones((3, BPTT), np.float32)
    w[2, 10:] = 0.0
    lm = (rng.random(V) < 0.7).astype(np.float32)
    key = jax.random.key(11)
    rmasked = r_mask_params({k: jnp.asarray(v) for k, v in rp.items()}, rmodel.specs,
                            rmodel.groups, wr)
    (r_loss, r_score), r_grads = ref_grads(
        rmasked, jnp.asarray(lab), jnp.float32(wr), jnp.asarray(lm), jnp.asarray(w), key)
    leaves = {k: v.requires_grad_() for k, v in
              mask_params(params_from_jax(rp, perms), model.specs, model.groups, wr).items()}
    score, loss = model(torch.from_numpy(lab), params=leaves, width_rate=wr, scaler_rate=wr,
                        label_mask=torch.from_numpy(lm), sample_weight=torch.from_numpy(w),
                        draws=draws_of(key, 3, BPTT))
    names = sorted(leaves)
    grads = params_to_jax(dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names]))),
                          perms)
    case = f"transformer forward (width {wr})"
    assert_close(f"{case}: scores", score, np.asarray(r_score), rtol=1e-4, atol=1e-5)
    assert_close(f"{case}: loss", loss, np.asarray(r_loss), rtol=1e-4, atol=1e-5)
    assert_close(f"{case}: gradients", np.concatenate([grads[k].ravel() for k in names]),
                 np.concatenate([np.asarray(r_grads[k]).ravel() for k in names]),
                 rtol=1e-3, atol=2e-5)


# --- one round -----------------------------------------------------------------------

def _round_data():
    """4 users x 2 token rows x 40 tokens (3 windows, the last 8 long) of
    the synthetic stream over 50 tokens, their iid split and label masks."""
    tok = rds.synthetic_lm("WikiText2", "train", 8 * 40, V, 4).token
    ds = rds.TokenDataset(rpipe.batchify(tok, 8), None, "WikiText2")
    split, lsplit = r_iid(ds, 4, np.random.default_rng(0))
    rows = rpipe.stack_client_token_rows(ds.token, split, [0, 1, 2, 3])
    return rows, rpipe.label_split_masks(lsplit, 4, V)


@pytest.fixture(scope="module")
def reference_round(ref_model):
    """One ``RoundEngine.train_round`` of the reference on the LM and the
    per-(user, step) draws it used."""
    _, _, rp = ref_model
    rcfg = _cfg(RC)
    rmodel = r_make_model(rcfg)
    rows, lm = _round_data()
    key, users = jax.random.key(7), np.array([0, 1, 2, 3])
    eng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in rp.items()}, key, LR, users,
                                  (jnp.asarray(rows), jnp.asarray(lm)))
    slot_keys = client_stream_keys(key, jnp.asarray(users))
    cache = {}

    def lm_draws(uid, t):
        if (uid, t) not in cache:
            rng = jax.random.fold_in(slot_keys[list(users).index(uid)], 5000 + t)
            cache[uid, t] = draws_of(rng, rows.shape[1], BPTT)
        return cache[uid, t]

    return rows, lm, users, lm_draws, _np(r_new), _np(r_ms)


@pytest.mark.parametrize("fused_update", [True, False])
def test_lm_round_matches_reference_round_engine(ref_model, reference_round, fused_update):
    """From the same params, users (levels a, b, c, e), label masks and
    draws, the port's LM round (the fused-SGD plain version, or the
    per-leaf chain) gives the new global params to atol 5e-5, ``loss_sum``
    and ``score_sum`` to rtol/atol 1e-4 and ``n`` exactly; the ``<mask>``
    row of the token embedding keeps its value bit for bit."""
    _, _, rp = ref_model
    rows, lm, users, lm_draws, r_new, r_ms = reference_round
    cfg = dict(_cfg(PC), fused_update=fused_update)
    model = make_model(cfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(rp, perms))
    eng = RoundEngine(model, cfg, torch.device("cpu"))
    P = eng.flatten(model.params())
    new, ms = eng.train_round(P, LR, users, (torch.from_numpy(rows), torch.from_numpy(lm)),
                              round_seed=0, lm_draws=lm_draws)
    p_new = params_to_jax(eng.unflatten(new), perms)
    names = sorted(r_new)
    case = f"one LM round (fused_update={fused_update})"
    assert_close(f"{case}: new global params", np.concatenate([p_new[k].ravel() for k in names]),
                 np.concatenate([r_new[k].ravel() for k in names]), rtol=0, atol=5e-5)
    assert_close(f"{case}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
    for k in ("loss_sum", "score_sum"):
        assert_close(f"{case}: {k}", ms[k], r_ms[k], rtol=1e-4, atol=1e-4)
    assert ms["n"].tolist() == [2.0 * 3] * 4  # R rows x S windows
    np.testing.assert_array_equal(p_new["embedding.tok.w"][V], rp["embedding.tok.w"][V])
    assert not np.array_equal(p_new["embedding.tok.w"][:V], rp["embedding.tok.w"][:V])


# --- evaluation and the centralised epochs ---------------------------------------------

def test_global_perplexity_matches_reference_evaluator(ref_model):
    """The Global sums over a test stream's windows (a padded tail) with
    the reference ``Evaluator``'s draws (seed 3, epoch 2): ``loss_sum`` and
    ``score_sum`` rtol/atol 1e-4, ``n`` exactly; the port's own generator
    repeats an epoch's value exactly and gives another epoch other draws."""
    _, rmodel, rp = ref_model
    tok = rds.synthetic_lm("WikiText2", "test", 4 * 70, V, 5).token
    xs, ws = rpipe.stack_windows(rpipe.bptt_windows(rpipe.batchify(tok, 4), BPTT), BPTT)
    rcfg = _cfg(RC)
    g_ref = REvaluator(rmodel, rcfg, make_mesh(1, 1), seed=3).eval_global(
        {k: jnp.asarray(v) for k, v in rp.items()}, {}, xs, ws, epoch=2)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(3), 1), 2)
    keys = jax.random.split(key, xs.shape[0])
    model = make_model(_cfg(PC))
    model.load_state_dict(params_from_jax(rp, model.jax_perms()))
    ev = Evaluator(model, _cfg(PC), torch.device("cpu"), seed=3)
    data = (torch.from_numpy(xs), torch.from_numpy(ws))
    g = ev.eval_global(model.params(), {}, *data, epoch=2,
                       draws=lambda t: draws_of(keys[t], 4, BPTT, train=False))
    for k in ("loss_sum", "score_sum"):
        assert_close(f"Global-Perplexity sums: {k}", g[k], g_ref[k], rtol=1e-4, atol=1e-4)
    assert g["n"] == g_ref["n"] == 4.0 * xs.shape[0]
    with torch.no_grad():
        again = [ev.eval_global(model.params(), {}, *data, epoch=e)["loss_sum"] for e in (2, 2, 3)]
    assert again[0] == again[1] != again[2]


def test_central_lm_epochs_match_reference(ref_model):
    """Two epochs of the centralised engine on the same windows (8 rows a
    step, a padded tail) from the same params with the reference
    ``CentralEngine``'s draws: params after each epoch to atol 5e-5, the
    momentum buffers to the same atol, the sums to rtol/atol 1e-4."""
    _, rmodel, rp = ref_model
    rcfg = _cfg(RC, "1_1_1_none_fix_a1_bn_1_1")
    tok = rds.synthetic_lm("WikiText2", "train", 8 * 40, V, 6).token
    xs, ws = rpipe.stack_windows(rpipe.bptt_windows(rpipe.batchify(tok, 8), BPTT), BPTT)
    reng = RCentralEngine(rmodel, rcfg, make_mesh(1, 1))
    rparams = {k: jnp.asarray(v) for k, v in rp.items()}
    ropt = reng.init_opt(rparams)
    cfg = _cfg(PC, "1_1_1_none_fix_a1_bn_1_1")
    model = make_model(cfg)
    perms = model.jax_perms()
    eng = CentralEngine(model, cfg, torch.device("cpu"))
    params = params_from_jax(rp, perms)
    opt = eng.init_opt(params)
    for epoch in (1, 2):
        key = jax.random.key(20 + epoch)
        rparams, ropt, rsums = reng.train_epoch(rparams, ropt, key, LR, jnp.asarray(xs),
                                                jnp.asarray(ws))

        def draws(t, key=key):
            return draws_of(jax.random.fold_in(jax.random.fold_in(key, t), 2), 8, BPTT)

        params, opt, acc = eng.train_epoch(params, opt, LR, torch.from_numpy(xs),
                                           torch.from_numpy(ws), draws=draws)
        case = f"central LM epoch {epoch}"
        got = params_to_jax(params, perms)
        names = sorted(got)
        assert_close(f"{case}: params", np.concatenate([got[k].ravel() for k in names]),
                     np.concatenate([np.asarray(rparams[k]).ravel() for k in names]),
                     rtol=0, atol=5e-5)
        bufs = params_to_jax(opt["slots"], perms)
        assert_close(f"{case}: momentum", np.concatenate([bufs[k].ravel() for k in names]),
                     np.concatenate([np.asarray(ropt.slots[k]).ravel() for k in names]),
                     rtol=0, atol=5e-5)
        assert_close(f"{case}: sums", acc, np.array([float(s) for s in rsums]),
                     rtol=1e-4, atol=1e-4)
    assert float(acc[2]) == 8.0 * xs.shape[0]
