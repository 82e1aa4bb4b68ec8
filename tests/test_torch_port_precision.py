"""bfloat16 compute and the im2col convolution of the PyTorch/CUDA port
against the JAX reference on the CPU.

``compute_dtype='bfloat16'`` casts each conv's and each linear's operands to
bf16, the op's result back to float32, and adds the bias after that cast
(ref ops/layers.py:29-87; the transformer's attention, ref
models/transformer.py:166-183).  ``conv_impl='im2col'`` computes a
convolution as patch extraction plus a matmul (ref ops/layers.py:52-63).

Contracts:

* **ops.**  From the same float32 inputs both packages round the same
  operands to bf16, their products are exact in float32 and only the sum
  order differs, so the bf16 result agrees to one bf16 rounding of the
  output: rtol 2^-7 (one bf16 ulp), atol 1e-6.  im2col against the
  reference's im2col and against the direct convolution at the
  reference's own 1e-5 (tests/test_models.py::
  test_conv2d_im2col_matches_direct), over its four kernel / stride /
  padding shapes.  The grouped engine's batched im2col against its
  grouped convolution at 1e-5.
* **models (bf16).**  A bf16 rounding of an intermediate that sits at a
  rounding boundary may go either way in the two packages (their float32
  inputs differ by summation order); a flipped rounding moves that value
  by one bf16 ulp (2^-7 relative) and what depends on it by less, and an
  output that is itself a bf16 product (a score, before its float32 bias)
  may take one more: scores within 2^-6 (two ulps) of the largest score,
  the loss rtol 2^-6.  The gradients are held as a whole: the flips that
  the forward absorbs add up in the weight gradients of the convolutions
  before a batch norm, whose sums over a batch cancel (ResNet-18 at
  8/16/16/16, batch 5: the reference's own bf16 gradients are 39% of
  their L2 norm from its float32 ones, the port's from the reference's
  22%), so the port's gradients must lie no farther from the reference's
  (L2 over all leaves) than the reference's bf16 gradients lie from its
  float32 ones.  The bf16 forward is also held to the float32 forward as
  the reference holds its own (loss within 0.05).
* **models (im2col).**  Forward and gradients against the reference's
  im2col model and the port's direct model at the model parity contract
  (scores/loss rtol 1e-4 / atol 1e-5, grads rtol 1e-3 / atol 2e-5).
* **the masked zero tail.**  Exactly zero through a bf16 forward and
  gradient (tests/test_models.py::test_bf16_compute_dtype_close_to_f32).
* **the engines.**  Grouped im2col == grouped direct == masked at the
  grouped contract (rtol 5e-4 / atol 5e-5), ``n`` exactly.
* **a bf16 round** against the reference's, ResNet-18 at 40 images with
  the reference's draws: params within 2^-7 of the largest param entry
  (the model contract carried through 2 SGD steps at lr 0.05), metric
  sums rtol 2^-6, ``n`` exactly.
* **the config.**  ``compute_dtype``, ``conv_impl`` and ``scan_unroll``
  are accepted and refused as the reference's parses do.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import label_split_masks as r_lsm
from heterofl_tpu.data import split_dataset as r_split
from heterofl_tpu.data import stack_client_shards as r_stack
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.models import parse_compute_dtype as r_parse_compute_dtype
from heterofl_tpu.models.spec import mask_params as r_mask_params
from heterofl_tpu.ops import layers as r_layers
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
from heterofl_tpu_torch.models import make_model, mask_params
from heterofl_tpu_torch.ops import layers
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from test_torch_port_grouped import CONV, TOL_GROUPED, _flat, _port_round, _vision_data
from test_torch_port_grouped import _cfg as grouped_cfg
from test_torch_port_lm import BPTT, V, draws_of
from test_torch_port_lm import _cfg as lm_cfg
from test_torch_port_round import LR, reference_draws, run_reference_round

few_threads = thread_limit_fixture()

BF16_ULP = 2.0 ** -7
SHAPES = ((3, 3, 1, 1), (3, 3, 2, 1), (1, 1, 1, 0), (1, 1, 2, 0))  # kh, kw, stride, padding
HIDDEN = {"conv": {"conv": {"hidden_size": [8, 16]}},
          "resnet18": {"resnet": {"hidden_size": [8, 16, 16, 16]}}}
DATA = {"conv": "MNIST", "resnet18": "CIFAR10"}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# --- the ops ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "k{}s{}p{}".format(*s[1:]))
@pytest.mark.parametrize("dtype,impl", [("float32", "im2col"), ("bfloat16", None),
                                        ("bfloat16", "im2col")])
def test_conv2d_matches_reference(shape, dtype, impl):
    """``conv2d`` under ``compute_dtype``/``impl`` against the reference's
    op with the same arguments, and im2col against the port's direct
    convolution."""
    kh, kw, stride, pad = shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    w = rng.normal(size=(kh, kw, 5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    r_cd, cd = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (None, None)
    ref = np.asarray(r_layers.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                                     padding=pad, compute_dtype=r_cd, impl=impl))
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    out = layers.conv2d(_nchw(x), wt, torch.from_numpy(b), stride=stride, padding=pad,
                        compute_dtype=cd, impl=impl)
    assert out.dtype == torch.float32
    case = f"conv2d {dtype} {impl or 'direct'} k{kh} s{stride} p{pad}"
    rtol, atol = (BF16_ULP, 1e-6) if cd is not None else (1e-5, 1e-5)
    assert_close(f"{case} vs reference", _nhwc(out), ref, rtol=rtol, atol=atol)
    if impl == "im2col":
        direct = layers.conv2d(_nchw(x), wt, torch.from_numpy(b), stride=stride, padding=pad,
                               compute_dtype=cd)
        assert_close(f"{case} vs the port's direct", out, direct, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "k{}s{}p{}".format(*s[1:]))
def test_conv2d_clients_im2col_matches_grouped_convolution(shape):
    """The grouped engine's batched im2col (patches shared, one batched
    matmul of each client's patches by its own weights) against the
    grouped convolution and against each client's own ``conv2d``, float32
    and bf16; the result is channels_last, as the BN kernels read it."""
    kh, kw, stride, pad = shape
    G, rng = 3, np.random.default_rng(1)
    x = _nchw(rng.normal(size=(2, 8, 8, G * 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(G, 7, 5, kh, kw)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(G, 7)).astype(np.float32))
    for cd, tol in ((None, (1e-5, 1e-5)), (torch.bfloat16, (BF16_ULP, 1e-6))):
        case = f"conv2d_clients {cd or 'float32'} k{kh} s{stride} p{pad}"
        im = layers.conv2d_clients(x, w, b, G, stride, pad, compute_dtype=cd, impl="im2col")
        assert im.is_contiguous(memory_format=torch.channels_last)
        direct = layers.conv2d_clients(x, w, b, G, stride, pad, compute_dtype=cd)
        assert_close(f"{case}: im2col vs grouped convolution", im, direct, rtol=tol[0],
                     atol=tol[1])
        own = torch.cat([layers.conv2d(x[:, g * 5:(g + 1) * 5], w[g], b[g], stride, pad,
                                       compute_dtype=cd) for g in range(G)], 1)
        assert_close(f"{case}: im2col vs each client's conv2d", im, own, rtol=tol[0],
                     atol=tol[1])


def test_linear_bf16_matches_reference():
    """``linear`` and ``linear_clients`` in bf16 against the reference's
    ``linear`` (the bias added in float32 after the cast)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6, 32)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)  # the reference's [in, out]
    b = rng.normal(size=(24,)).astype(np.float32)
    ref = np.asarray(r_layers.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     compute_dtype=jnp.bfloat16))
    wt = torch.from_numpy(w.T.copy())
    out = layers.linear(torch.from_numpy(x), wt, torch.from_numpy(b), torch.bfloat16)
    assert out.dtype == torch.float32
    assert_close("linear bf16 vs reference", out, ref, rtol=BF16_ULP, atol=1e-6)
    outc = layers.linear_clients(torch.from_numpy(x)[None].expand(2, -1, -1, -1),
                                 wt[None].expand(2, -1, -1), torch.from_numpy(b)[None].expand(2, -1),
                                 torch.bfloat16)
    assert_close("linear_clients bf16 vs reference", outc[1], ref, rtol=BF16_ULP, atol=1e-6)


# --- the models -------------------------------------------------------------------------

def _vision_cfgs(model_name, **extra):
    out = []
    for mod in (RC, PC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name("1_10_0.5_iid_fix_a1-b1-e1_bn_1_1")
        cfg["data_name"], cfg["model_name"] = DATA[model_name], model_name
        cfg["override"] = HIDDEN[model_name]
        cfg.update(extra)
        cfg = mod.process_control(cfg)
        cfg["classes_size"] = 10
        out.append(cfg)
    return out


def _vision_batch(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n,) + tuple(cfg["data_shape"])).astype(np.float32)
    label = rng.integers(0, 10, n)
    lm = np.zeros(10, np.float32)
    lm[[0, 2, 3, 5, 7, 9]] = 1.0
    sw = np.ones(n, np.float32)
    sw[-1] = 0.0  # one padding sample
    return img, label, lm, sw


def _vision_runs(model_name, wr, **extra):
    """The reference's and the port's (loss, scores, grads) of one training
    forward at width ``wr`` from the reference's masked init."""
    rcfg, pcfg = _vision_cfgs(model_name, **extra)
    rmodel = r_make_model(rcfg)
    params = r_mask_params(rmodel.init(jax.random.key(0)), rmodel.specs, rmodel.groups, wr)
    img, label, lm, sw = _vision_batch(rcfg)

    def loss_fn(p):
        out, _ = rmodel.apply(p, {"img": jnp.asarray(img), "label": jnp.asarray(label)},
                              train=True, width_rate=wr, scaler_rate=wr,
                              label_mask=jnp.asarray(lm), sample_weight=jnp.asarray(sw))
        return out["loss"], out["score"]

    (r_loss, r_score), r_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    score, loss = model(_nchw(img), torch.from_numpy(label), width_rate=wr, scaler_rate=wr,
                        label_mask=torch.from_numpy(lm), sample_weight=torch.from_numpy(sw))
    names = sorted(params)
    grads = params_to_jax(dict(zip(names, torch.autograd.grad(
        loss, [model.get_parameter(k) for k in names]))))
    ref = (float(r_loss), np.asarray(r_score), {k: np.asarray(v) for k, v in r_grads.items()})
    return ref, (float(loss.detach()), score.detach().numpy(), grads)


def _assert_bf16_model(case, port, ref, ref_f32_grads):
    names = sorted(ref[2])
    assert_close(f"{case}: scores", port[1], ref[1], rtol=0,
                 atol=2 * BF16_ULP * float(np.abs(ref[1]).max()))
    assert_close(f"{case}: loss", port[0], ref[0], rtol=2 * BF16_ULP, atol=0)
    g, r_g, r_f32 = (np.concatenate([d[k].ravel() for k in names])
                     for d in (port[2], ref[2], ref_f32_grads))
    off, bf16_off = float(np.linalg.norm(g - r_g)), float(np.linalg.norm(r_g - r_f32))
    print(f"parity {case}: gradients (all leaves): L2 from the reference's bf16 {off:.3e}, the "
          f"reference's bf16 from its float32 {bf16_off:.3e} (ratio {off / bf16_off:.3f}, at "
          f"most 1); the reference's L2 {float(np.linalg.norm(r_g)):.3e}", flush=True)
    assert off <= bf16_off, case


@pytest.mark.parametrize("model_name", ["conv", "resnet18"])
@pytest.mark.parametrize("wr", [1.0, 0.0625])
def test_vision_model_bf16_matches_reference(model_name, wr):
    """The conv net and ResNet-18 forward and gradients under bf16, and the
    bf16 loss against the float32 one (the reference's own check)."""
    ref, port = _vision_runs(model_name, wr, compute_dtype="bfloat16")
    ref_f32, f32 = _vision_runs(model_name, wr)
    _assert_bf16_model(f"{model_name} bf16 (width {wr})", port, ref, ref_f32[2])
    assert abs(port[0] - f32[0]) < 0.05


@pytest.mark.parametrize("model_name", ["conv", "resnet18"])
def test_vision_model_im2col_matches_reference_and_direct(model_name):
    """The im2col model's forward and gradients against the reference's
    im2col model and the port's direct one."""
    ref, port = _vision_runs(model_name, 0.5, conv_impl="im2col")
    _, direct = _vision_runs(model_name, 0.5, conv_impl="direct")
    names = sorted(ref[2])
    for other, what in ((ref, "reference im2col"), (direct, "port direct")):
        case = f"{model_name} im2col vs {what}"
        assert_close(f"{case}: scores", port[1], other[1], rtol=1e-4, atol=1e-5)
        assert_close(f"{case}: loss", port[0], other[0], rtol=1e-4, atol=1e-5)
        assert_close(f"{case}: gradients (all leaves)",
                     np.concatenate([port[2][k].ravel() for k in names]),
                     np.concatenate([other[2][k].ravel() for k in names]), rtol=1e-3,
                     atol=2e-5)


@pytest.mark.parametrize("wr", [1.0, 0.0625])
def test_transformer_bf16_matches_reference(wr):
    """The transformer's training forward and gradients under bf16 (the
    attention's casts as the reference's), same masked params, label mask,
    position weights and draws."""
    rcfg, pcfg = (lm_cfg(mod, compute_dtype="bfloat16") for mod in (RC, PC))
    rmodel, rmodel_f32 = r_make_model(rcfg), r_make_model(lm_cfg(RC))
    rp = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    rng = np.random.default_rng(3)
    lab = rng.integers(0, V, (3, BPTT))
    w = np.ones((3, BPTT), np.float32)
    w[2, 10:] = 0.0
    lm = (rng.random(V) < 0.7).astype(np.float32)
    key = jax.random.key(11)
    rmasked = r_mask_params({k: jnp.asarray(v) for k, v in rp.items()}, rmodel.specs,
                            rmodel.groups, wr)

    def loss_fn(p, m):
        out, _ = m.apply(p, {"label": jnp.asarray(lab)}, train=True, width_rate=wr,
                         scaler_rate=wr, label_mask=jnp.asarray(lm),
                         sample_weight=jnp.asarray(w), rng=key)
        return out["loss"], out["score"]

    (r_loss, r_score), r_grads = jax.value_and_grad(loss_fn, has_aux=True)(rmasked, rmodel)
    r_f32_grads = jax.grad(lambda p: loss_fn(p, rmodel_f32)[0])(rmasked)
    model = make_model(pcfg)
    assert model.compute_dtype == torch.bfloat16
    perms = model.jax_perms()
    leaves = {k: v.requires_grad_() for k, v in
              mask_params(params_from_jax(rp, perms), model.specs, model.groups, wr).items()}
    score, loss = model(torch.from_numpy(lab), params=leaves, width_rate=wr, scaler_rate=wr,
                        label_mask=torch.from_numpy(lm), sample_weight=torch.from_numpy(w),
                        draws=draws_of(key, 3, BPTT))
    names = sorted(leaves)
    grads = params_to_jax(dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names]))),
                          perms)
    _assert_bf16_model(f"transformer bf16 (width {wr})",
                       (float(loss.detach()), score.detach().numpy(), grads),
                       (float(r_loss), np.asarray(r_score),
                        {k: np.asarray(v) for k, v in r_grads.items()}),
                       {k: np.asarray(v) for k, v in r_f32_grads.items()})


def test_masked_zero_tail_stays_zero_under_bf16():
    """A width-0.25 sub-model's masked suffix: its scores and loss equal the
    ones of the full params masked again, and the gradient of every masked
    entry is exactly zero through the bf16 forward and backward."""
    _, pcfg = _vision_cfgs("resnet18", compute_dtype="bfloat16")
    model = make_model(pcfg)
    model.init_(torch.Generator().manual_seed(0))
    img, label, lm, sw = _vision_batch(pcfg, n=4)
    wr = 0.25
    leaves = {k: v.requires_grad_() for k, v in
              mask_params(model.params(), model.specs, model.groups, wr).items()}
    _, loss = model(_nchw(img), torch.from_numpy(label), params=leaves, width_rate=wr,
                    scaler_rate=wr, sample_weight=torch.from_numpy(sw))
    names = sorted(leaves)
    grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
    ones = mask_params({k: torch.ones_like(v) for k, v in leaves.items()}, model.specs,
                       model.groups, wr)
    tail = torch.cat([grads[k][ones[k] == 0] for k in names])
    assert tail.numel() > 0 and bool(torch.all(tail == 0))
    assert bool(torch.all(grads["layer3.1.conv2.w"][:, 4:] == 0))  # the reference's check
    assert bool(torch.isfinite(loss))


# --- the engines --------------------------------------------------------------------------

def test_grouped_im2col_equals_grouped_direct_and_masked():
    """The conv net's round (levels a-e, two clients batched at level a,
    a short client) with ``conv_impl='im2col'``: the grouped engine against
    its direct twin and against the masked engine, from the same params
    and draws, at the grouped contract."""
    users = np.arange(6)
    arrays = _vision_data("MNIST", 6, 360, short=(1, 45))
    rcfg = grouped_cfg(RC, CONV, pallas=True)
    params_np = {k: np.asarray(v) for k, v in r_make_model(rcfg).init(jax.random.key(0)).items()}
    perms, _ = reference_draws(jax.random.key(3), users, 2, arrays[0].shape[1])
    runs = {}
    for engine, impl in ((GroupedRoundEngine, "im2col"), (GroupedRoundEngine, None),
                         (RoundEngine, "im2col")):
        pcfg = grouped_cfg(PC, CONV, pallas=True)
        pcfg["conv_impl"] = impl
        runs[engine.__name__, impl] = _port_round(engine, pcfg, params_np, arrays, users,
                                                  epoch_perms=perms)
    g_new, g_ms = runs["GroupedRoundEngine", "im2col"]
    for key in (("GroupedRoundEngine", None), ("RoundEngine", "im2col")):
        o_new, o_ms = runs[key]
        case = f"grouped im2col vs {key[0]} {key[1] or 'direct'}"
        assert_close(f"{case}: new global params", _flat(g_new), _flat(o_new),
                     rtol=TOL_GROUPED[0], atol=TOL_GROUPED[1])
        assert_close(f"{case}: loss_sum", g_ms["loss_sum"], o_ms["loss_sum"], rtol=1e-4,
                     atol=1e-4)
        assert torch.equal(g_ms["n"], o_ms["n"])


def test_bf16_resnet18_round_matches_reference():
    """A bf16 ResNet-18 round (widths 8/16/16/16) of a level-a and a
    level-e client, 2 local steps each on 40 CIFAR10 images, augmentation
    on, the reference's draws handed in (40 images: at 60 one ReLU gate
    sits in float32 noise, ROADMAP Queue 3)."""
    ds = r_fetch("CIFAR10", synthetic=True, seed=0, synthetic_sizes={"train": 40, "test": 10})
    split, lsplit = r_split(ds, 2, "iid", np.random.default_rng(0), classes_size=10)
    arrays = r_stack(ds["train"].data, ds["train"].target, split["train"], [0, 1]) + \
        (r_lsm(lsplit, 2, 10),)
    users = np.array([0, 1])
    rcfg, pcfg = _round_cfgs()
    B, N = rcfg["batch_size"]["train"], arrays[0].shape[1]
    steps = math.ceil(N / B)
    assert steps == 2
    params_np, r_new, r_ms = run_reference_round(rcfg, arrays, users)
    perms, aug = reference_draws(jax.random.key(3), users, 1, N, B, steps)
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params_np))
    eng = RoundEngine(model, pcfg, torch.device("cpu"))
    new, ms = eng.train_round(eng.flatten(model.params()), LR, users,
                              tuple(torch.from_numpy(a) for a in arrays), round_seed=0,
                              epoch_perms=perms, aug_draws=aug)
    p_new = params_to_jax(eng.unflatten(new))
    names = sorted(r_new)
    p, r = (np.concatenate([d[k].ravel() for k in names]) for d in (p_new, r_new))
    case = "bf16 ResNet-18 round"
    assert_close(f"{case}: new global params", p, r, rtol=0,
                 atol=BF16_ULP * float(np.abs(r).max()))
    assert_close(f"{case}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
    for k in ("loss_sum", "score_sum"):
        assert_close(f"{case}: {k}", ms[k], r_ms[k], rtol=2 * BF16_ULP, atol=2 ** -10)


def _round_cfgs():
    out = []
    for mod in (RC, PC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name("1_2_1_iid_fix_a1-e1_bn_1_1")
        cfg.update(data_name="CIFAR10", model_name="resnet18", compute_dtype="bfloat16",
                   override={"num_epochs": {"local": 1}, **HIDDEN["resnet18"]})
        cfg = mod.process_control(cfg)
        cfg["classes_size"] = 10
        out.append(cfg)
    return out


def test_central_entry_takes_bf16_and_im2col(tmp_path):
    """``train_classifier`` (the centralised baseline, conv twin at 8/16,
    one epoch of 5 steps) with ``--conv_impl im2col`` ends within the
    round contract (atol 5e-5) of the direct run, and with
    ``--compute_dtype bfloat16`` builds its model in bf16 and logs a finite
    loss within 0.05 of float32's (the reference's bf16 check)."""
    from heterofl_tpu_torch.entry import train_classifier
    from test_torch_port_central import _argv

    runs = {}
    for name, flags in (("direct", ()), ("im2col", ("--conv_impl", "im2col")),
                        ("bf16", ("--compute_dtype", "bfloat16"))):
        (runs[name],) = train_classifier.main(_argv(tmp_path / name, 1, *flags))
    names = sorted(runs["direct"]["params"])
    flat = {k: np.concatenate([runs[k]["params"][n].detach().numpy().ravel() for n in names])
            for k in runs}
    assert_close("central entry: im2col vs direct params after an epoch", flat["im2col"],
                 flat["direct"], rtol=0, atol=5e-5)
    loss = {k: runs[k]["logger"].history["train/Loss"][-1] for k in runs}
    assert math.isfinite(loss["bf16"]) and abs(loss["bf16"] - loss["direct"]) < 0.05
    assert np.isfinite(flat["bf16"]).all()


# --- the config --------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["bfloat16", "bf16", "float32", "f32", "fp32", None,
                                   "float16", "int8"])
def test_compute_dtype_parse_matches_reference(value):
    """Accepted and refused as the reference's ``parse_compute_dtype``, with
    its message; ``check_ported`` takes every accepted value."""
    try:
        r_out = r_parse_compute_dtype(value)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")
                           .replace("|", r"\|")):
            PC.parse_compute_dtype(value)
        with pytest.raises(ValueError):
            PC.check_ported(dict(PC.default_cfg(), compute_dtype=value))
        return
    out = PC.parse_compute_dtype(value)
    assert (out is None) == (r_out is None)
    assert out in (None, torch.bfloat16)
    PC.check_ported(dict(PC.default_cfg(), compute_dtype=value))


@pytest.mark.parametrize("value", [None, "direct", "im2col", "winograd"])
def test_conv_impl_parse_matches_reference(value):
    """``direct`` means None; anything but None/direct/im2col raises the
    reference's ``ValueError("Not valid conv_impl: ...")``, from the config
    check and from ``make_model``."""
    rcfg, pcfg = _vision_cfgs("conv")
    try:
        r_make_model(dict(rcfg, conv_impl=value))
    except ValueError as e:
        assert "Not valid conv_impl" in str(e)
        for call in (lambda: PC.check_ported(dict(pcfg, conv_impl=value)),
                     lambda: make_model(dict(pcfg, conv_impl=value))):
            with pytest.raises(ValueError, match="Not valid conv_impl"):
                call()
        return
    PC.check_ported(dict(pcfg, conv_impl=value))
    assert make_model(dict(pcfg, conv_impl=value)).conv_impl == \
        (None if value == "direct" else value)


@pytest.mark.parametrize("value", [1, 4, 0, None, "2", -1])
def test_scan_unroll_is_accepted_as_a_no_op(value):
    """``scan_unroll`` parses as the reference's ``int(cfg.get("scan_unroll",
    1) or 1)``; any value >= 1 is accepted (the port has no scan), below 1
    raises ``ValueError``."""
    cfg = dict(PC.default_cfg(), scan_unroll=value)
    want = int(value or 1)
    if want < 1:
        with pytest.raises(ValueError, match="scan_unroll"):
            PC.check_ported(cfg)
        return
    PC.check_ported(cfg)
    assert PC.parse_scan_unroll(cfg) == want
