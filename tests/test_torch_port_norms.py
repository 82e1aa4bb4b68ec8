"""The ``in``, ``ln`` and ``gn`` norms and the Bottleneck ResNets of the
PyTorch/CUDA port against the JAX reference on the CPU: each norm per op
(forward and gradients, width masks on, levels a and e), one conv round per
norm against ``RoundEngine.train_round``, ResNet-50's forward and gradients
at widths 8/16/16/16 (batch norm through the reference's Pallas kernels in
interpret mode and the port's plain versions), the conversion round trip of
its leaves, and the parameter shapes of ResNet-50/101/152."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_round import (assert_round_matches, reference_draws,
                                   run_reference_round)

from heterofl_tpu import config as RC
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import label_split_masks as r_lsm
from heterofl_tpu.data import split_dataset as r_split
from heterofl_tpu.data import stack_client_shards as r_stack
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.models.norms import apply_norm as r_apply_norm
from heterofl_tpu.models.spec import Group as RGroup
from heterofl_tpu.models.spec import mask_params as r_mask_params
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
from heterofl_tpu_torch.models import make_model, mask_params
from heterofl_tpu_torch.models.norms import apply_norm
from heterofl_tpu_torch.models.spec import Group
from heterofl_tpu_torch.ops.layers import group_onehot
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture

few_threads = thread_limit_fixture()

NORMS = ("in", "ln", "gn")
LEVELS = {"a": 1.0, "e": 0.0625}
# the models' stated tolerances (tests/test_torch_port_models.py): outputs
# rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 2e-5
TOL_Y, TOL_G = (1e-4, 1e-5), (1e-3, 2e-5)
# ResNet-50's gradients, each leaf divided by its scale (its largest
# reference entry, at least 1): rtol 1e-3, and an atol of twice the
# reference's own float32 error against a float64 evaluation of the same
# function (measured on each run, and itself at most TOL_REF_F64), at least
# 1e-4.  The stem's gradient goes back through 16 bottleneck blocks and 49
# BN sites (ResNet-18: 8 and 17) and reaches 29 at level e, where the
# 8/16/16/16 widths keep 1 to 4 channels a site: float32 rounding alone
# moves the reference's gradients by 2.5e-5 (level a) and 1.0e-3 (level e)
# of their scale.
TOL_G_DEEP = (1e-3, 1e-4)
TOL_REF_F64 = 1e-2


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_norm_op_matches_reference(norm, level):
    """One norm site of 64 channels at level a (64 active) and e (4
    active, one per ``gn`` group): the output and the gradients of a
    weighted sum of it with respect to x, g and b, the inactive channels
    zero on input as in a masked model."""
    wr, C = LEVELS[level], 64
    rng = np.random.default_rng(7)
    mask = RGroup("h", C).mask(wr)
    k = RGroup("h", C).active_count(wr)
    m = np.asarray(mask)
    x = rng.normal(size=(3, 5, 6, C)).astype(np.float32) * m          # NHWC
    g = (1.0 + 0.5 * rng.normal(size=C)).astype(np.float32) * m
    b = rng.normal(size=C).astype(np.float32) * m
    r = rng.normal(size=x.shape).astype(np.float32)

    def ref(x_, g_, b_):
        y, _ = r_apply_norm(norm, x_, g_, b_, mask=mask, k=k)
        return jnp.sum(y * r), y

    (_, y_ref), grads_ref = jax.value_and_grad(ref, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    grp = Group("h", C)
    pk = grp.active_count(wr)
    pmask = grp.mask(wr)
    assert pk == int(k)
    ops = (pmask, pk, group_onehot(C, {"ln": 1, "gn": 4}.get(norm, 1), pmask, pk))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()     # NCHW view
    gt, bt = torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y, _ = apply_norm(norm, xt, gt, bt, group_ops=ops)
    loss = (y * torch.from_numpy(r).permute(0, 3, 1, 2)).sum()
    dx, dg, db = torch.autograd.grad(loss, [xt, gt, bt])
    case = f"{norm} norm op, level {level} (k {pk})"
    assert_close(f"{case}: y", y.permute(0, 2, 3, 1), y_ref, rtol=TOL_Y[0], atol=TOL_Y[1])
    for name, got, want in (("dx", dx.permute(0, 2, 3, 1), grads_ref[0]),
                            ("dg", dg, grads_ref[1]), ("db", db, grads_ref[2])):
        assert_close(f"{case}: {name}", got, want, rtol=TOL_G[0], atol=TOL_G[1])
    assert not torch.any(y.permute(0, 2, 3, 1)[..., pk:])  # masked channels stay zero


def _conv_cfg(mod, norm):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(f"1_2_1_iid_fix_a1-e1_{norm}_1_1")
    cfg["data_name"], cfg["model_name"] = "MNIST", "conv"
    cfg["override"] = {"num_epochs": {"local": 1}, "conv": {"hidden_size": [16, 32]}}
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


@pytest.mark.parametrize("norm", NORMS)
def test_norm_round_matches_reference(norm):
    """One conv round (hidden 16/32) of a level-a and a level-e client, 4
    local steps each, under each norm, with the reference's epoch
    permutations: the port's round equals ``RoundEngine.train_round`` at
    the round's stated tolerance."""
    ds = r_fetch("MNIST", synthetic=True, seed=1, synthetic_sizes={"train": 80, "test": 10})
    split, lsplit = r_split(ds, 2, "iid", np.random.default_rng(1), classes_size=10)
    arrays = r_stack(ds["train"].data, ds["train"].target, split["train"], [0, 1]) + \
        (r_lsm(lsplit, 2, 10),)
    users = np.array([0, 1])
    params_np, r_new, r_ms = run_reference_round(_conv_cfg(RC, norm), arrays, users)
    perms, _ = reference_draws(jax.random.key(3), users, 1, arrays[0].shape[1])
    assert_round_matches(f"conv round, norm {norm}", params_np, _conv_cfg(PC, norm), arrays,
                         users, r_new, r_ms, epoch_perms=perms)


def _resnet_cfgs(model_name="resnet50", pallas=True, hidden=(8, 16, 16, 16)):
    out = []
    for mod in (RC, PC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name("1_10_0.5_iid_fix_a1-e1_bn_1_1")
        cfg["data_name"], cfg["model_name"], cfg["pallas_norm"] = "CIFAR10", model_name, pallas
        cfg["override"] = {"resnet": {"hidden_size": list(hidden)}}
        cfg = mod.process_control(cfg)
        cfg["classes_size"] = 10
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def resnet50_reference():
    """ResNet-50 (8/16/16/16) of the reference with ``pallas_norm`` (its
    Pallas BN kernels in interpret mode): init, and per level the masked
    params, scores, loss and gradients on one batch."""
    rcfg, pcfg = _resnet_cfgs()
    model = r_make_model(rcfg)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    img = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    label = rng.integers(0, 10, 4)
    lm = np.ones(10, np.float32)
    lm[[1, 4]] = 0.0
    sw = np.array([1, 1, 1, 0], np.float32)  # one padding sample

    def loss_fn(p, wr):
        out, _ = model.apply(p, {"img": jnp.asarray(img), "label": jnp.asarray(label)},
                             train=True, width_rate=wr, scaler_rate=wr,
                             label_mask=jnp.asarray(lm), sample_weight=jnp.asarray(sw))
        return out["loss"], out["score"]

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    runs = {}
    for level, wr in LEVELS.items():
        masked = r_mask_params(params, model.specs, model.groups, wr)
        (loss, score), grads = vg(masked, jnp.float32(wr))
        runs[level] = ({k: np.asarray(v) for k, v in masked.items()}, float(loss),
                       np.asarray(score), {k: np.asarray(v) for k, v in grads.items()})
    return pcfg, (img, label, lm, sw), runs


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_resnet50_matches_reference(resnet50_reference, level):
    """ResNet-50's scores and loss (rtol 1e-4 / atol 1e-5) and every leaf's
    gradient (``TOL_G_DEEP``) at levels a and e, from the
    reference's masked params: the reference's batch norm through its
    Pallas kernels in interpret mode, the port's through the fused route's
    plain versions (``pallas_norm``, CPU tensors)."""
    pcfg, (img, label, lm, sw), runs = resnet50_reference
    masked, r_loss, r_score, r_grads = runs[level]
    wr = LEVELS[level]
    names = sorted(masked)
    scale = {k: max(float(np.abs(r_grads[k]).max()), 1.0) for k in names}
    flat = lambda d: np.concatenate([np.asarray(d[k], np.float64).ravel() / scale[k]  # noqa: E731
                                     for k in names])
    case = f"ResNet-50 (8/16/16/16) level {level}"
    for dtype in (torch.float64, torch.float32):
        model = make_model(pcfg).to(dtype)
        model.load_state_dict(params_from_jax(masked))
        cast = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
        score, loss = model(cast(img).permute(0, 3, 1, 2), torch.from_numpy(label),
                            width_rate=wr, scaler_rate=wr, label_mask=cast(lm),
                            sample_weight=cast(sw))
        grads = params_to_jax({k: g.float() for k, g in zip(names, torch.autograd.grad(
            loss, [model.get_parameter(k) for k in names]))})
        if dtype == torch.float64:
            # the reference's own float32 error sets the gradients' atol
            err_ref = assert_close(f"{case}: reference grads vs float64 port, each leaf over "
                                   f"its scale", flat(r_grads), flat(grads), rtol=0,
                                   atol=TOL_REF_F64)[0]
            atol = max(TOL_G_DEEP[1], 2 * err_ref)
            continue
        assert_close(f"{case}: scores", score, r_score, rtol=TOL_Y[0], atol=TOL_Y[1])
        assert_close(f"{case}: loss", loss, r_loss, rtol=TOL_Y[0], atol=TOL_Y[1])
        assert_close(f"{case}: grads, each leaf over its scale", flat(grads), flat(r_grads),
                     rtol=TOL_G_DEEP[0], atol=atol)


def test_bottleneck_conversion_round_trip(resnet50_reference):
    """The Bottleneck leaves (``conv3``, the 1x1 shortcut, ``n3``) and every
    other one survive ``params_to_jax(params_from_jax(p))`` exactly, at the
    port model's shapes, and the port's width masks equal the reference's
    on every leaf at every level."""
    pcfg, _, runs = resnet50_reference
    full = runs["a"][0]
    assert {"layer0.0.conv3.w", "layer0.0.shortcut.w", "layer3.2.n3.g"} <= set(full)
    back = params_to_jax(params_from_jax(full))
    assert set(back) == set(full)
    for k in full:
        np.testing.assert_array_equal(back[k], full[k], err_msg=k)
    model = make_model(pcfg)
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == \
        {k: tuple(v.shape) for k, v in params_from_jax(full).items()}
    rmodel = r_make_model(_resnet_cfgs()[0])
    ones = {k: np.ones(v.shape, np.float32) for k, v in full.items()}
    for wr in (1.0, 0.5, 0.25, 0.125, 0.0625):
        r_pm = r_mask_params({k: jnp.asarray(v) for k, v in ones.items()}, rmodel.specs,
                             rmodel.groups, wr)
        p_pm = params_to_jax(mask_params(params_from_jax(ones), model.specs, model.groups, wr))
        for k in full:
            np.testing.assert_array_equal(p_pm[k], np.asarray(r_pm[k]), err_msg=f"{k}@{wr}")


@pytest.mark.parametrize("model_name", ["resnet50", "resnet101", "resnet152"])
def test_bottleneck_resnets_have_reference_shapes(model_name):
    """``make_model`` builds ResNet-50/101/152 at full width with the
    reference's leaves at its shapes (the reference's abstract init)."""
    rcfg, pcfg = _resnet_cfgs(model_name, pallas=False, hidden=(64, 128, 256, 512))
    rmodel = r_make_model(rcfg)
    r_shapes = {k: tuple(v.shape) for k, v in
                jax.eval_shape(rmodel.init, jax.random.key(0)).items()}
    model = make_model(pcfg)
    perms = model.jax_perms()
    p_shapes = {k: tuple(v.shape[a] for a in perms[k]) if k in perms else tuple(v.shape)
                for k, v in model.named_parameters()}
    assert p_shapes == r_shapes
    assert set(model.groups) == set(rmodel.groups)
    assert all(model.groups[g].size == rmodel.groups[g].size for g in model.groups)
