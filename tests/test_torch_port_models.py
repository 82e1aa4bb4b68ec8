"""Model parity of the PyTorch/CUDA port against the JAX reference on the
CPU: conv net and ResNet-18 at narrow widths, loaded from the reference's
own init through ``params_from_jax``, compared on scores, loss and grads at
width rates 1, 0.5 and 0.0625 with the fused-BN route off and on (the
reference's Pallas kernels in interpret mode, the port's plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.models.spec import count_masks as r_count_masks
from heterofl_tpu.models.spec import mask_params as r_mask_params
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
from heterofl_tpu_torch.models import count_masks, make_model, mask_params
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture

few_threads = thread_limit_fixture()

HIDDEN = {"conv": {"conv": {"hidden_size": [8, 16]}},
          "resnet18": {"resnet": {"hidden_size": [8, 16, 16, 16]}}}
DATA = {"conv": "MNIST", "resnet18": "CIFAR10"}
RATES = (1.0, 0.5, 0.0625)


def _cfgs(model_name, pallas):
    out = []
    for mod in (RC, PC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name("1_10_0.5_iid_fix_a1-b1-e1_bn_1_1")
        cfg["data_name"], cfg["model_name"] = DATA[model_name], model_name
        cfg["pallas_norm"] = pallas
        cfg["override"] = HIDDEN[model_name]
        cfg = mod.process_control(cfg)
        cfg["classes_size"] = 10
        out.append(cfg)
    return out


def _batch(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n,) + tuple(cfg["data_shape"])).astype(np.float32)
    label = rng.integers(0, 10, n)
    lm = np.zeros(10, np.float32)
    lm[[0, 2, 3, 5, 7, 9]] = 1.0
    sw = np.ones(n, np.float32)
    sw[-1] = 0.0  # one padding sample
    return img, label, lm, sw


@pytest.fixture(scope="module")
def reference_runs():
    """Reference scores/loss/grads per (model, pallas, rate), computed once."""
    cache = {}

    def get(model_name, pallas):
        key = (model_name, pallas)
        if key not in cache:
            rcfg, pcfg = _cfgs(model_name, pallas)
            model = r_make_model(rcfg)
            params = model.init(jax.random.key(0))
            img, label, lm, sw = _batch(rcfg)

            def loss_fn(p, wr):
                out, _ = model.apply(p, {"img": jnp.asarray(img), "label": jnp.asarray(label)},
                                     train=True, width_rate=wr, scaler_rate=wr,
                                     label_mask=jnp.asarray(lm), sample_weight=jnp.asarray(sw))
                return out["loss"], out["score"]

            vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
            runs = {}
            for wr in RATES:
                masked = r_mask_params(params, model.specs, model.groups, wr)
                (loss, score), grads = vg(masked, jnp.float32(wr))
                runs[wr] = ({k: np.asarray(v) for k, v in masked.items()}, float(loss),
                            np.asarray(score), {k: np.asarray(v) for k, v in grads.items()})
            cache[key] = (rcfg, pcfg, runs, model)
        return cache[key]

    return get


@pytest.mark.parametrize("model_name", ["conv", "resnet18"])
@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("wr", RATES)
def test_model_matches_reference(reference_runs, model_name, pallas, wr):
    """Scores and loss to rtol 1e-4 / atol 1e-5, grads to rtol 1e-3 / atol
    2e-5 (float32 convolutions and reductions in another order)."""
    rcfg, pcfg, runs, _ = reference_runs(model_name, pallas)
    masked, r_loss, r_score, r_grads = runs[wr]
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(masked))
    img, label, lm, sw = _batch(rcfg)
    score, loss = model(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(label),
                        width_rate=wr, scaler_rate=wr, label_mask=torch.from_numpy(lm),
                        sample_weight=torch.from_numpy(sw))
    names = sorted(masked)
    grads = torch.autograd.grad(loss, [model.get_parameter(k) for k in names])
    case = f"{model_name} pallas_norm={int(pallas)} width {wr}"
    assert_close(f"{case} scores", score, r_score, rtol=1e-4, atol=1e-5)
    assert_close(f"{case} loss", loss, r_loss, rtol=1e-4, atol=1e-5)
    port_grads = params_to_jax(dict(zip(names, grads)))
    for k in names:
        np.testing.assert_allclose(port_grads[k], r_grads[k], rtol=1e-3, atol=2e-5, err_msg=k)
    assert_close(f"{case} grads (all leaves)", np.concatenate([port_grads[k].ravel() for k in names]),
                 np.concatenate([r_grads[k].ravel() for k in names]), rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("model_name", ["conv", "resnet18"])
def test_conversion_round_trip_and_masks(reference_runs, model_name):
    """``params_to_jax(params_from_jax(p)) == p`` exactly; the port's width
    and count masks (on its own axes) equal the reference's after
    conversion, at every rate level."""
    rcfg, pcfg, runs, rmodel = reference_runs(model_name, False)
    full = runs[1.0][0]
    back = params_to_jax(params_from_jax(full))
    assert set(back) == set(full)
    for k in full:
        assert back[k].shape == full[k].shape
        np.testing.assert_array_equal(back[k], full[k])
    model = make_model(pcfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in params_from_jax(full).items()}
    lm = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 1], np.float32)
    r_shapes = {k: v.shape for k, v in full.items()}
    p_shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    for wr in (1.0, 0.5, 0.25, 0.125, 0.0625):
        r_cm = r_count_masks(r_shapes, rmodel.specs, rmodel.groups, wr, jnp.asarray(lm))
        p_cm = params_to_jax(count_masks(p_shapes, model.specs, model.groups, wr,
                                         torch.from_numpy(lm)))
        r_pm = r_mask_params({k: jnp.ones(s) for k, s in r_shapes.items()}, rmodel.specs,
                             rmodel.groups, wr)
        p_pm = params_to_jax(mask_params({k: torch.ones(s) for k, s in p_shapes.items()},
                                         model.specs, model.groups, wr))
        for k in r_shapes:
            np.testing.assert_array_equal(p_cm[k], np.asarray(r_cm[k]), err_msg=f"{k}@{wr}")
            np.testing.assert_array_equal(p_pm[k], np.asarray(r_pm[k]), err_msg=f"{k}@{wr}")


def test_unported_model_options_raise():
    """Every norm and model of the reference builds (``gn``, ResNet-50);
    a norm or model the reference does not have raises, naming it."""
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_10_0.5_iid_fix_a1_gn_1_1")
    cfg["override"] = {"resnet": {"hidden_size": [8, 16, 16, 16]}}
    cfg = PC.process_control(cfg)
    cfg["classes_size"] = 10
    assert make_model(cfg).norm == "gn"
    assert "layer3.2.conv3.w" in dict(make_model(dict(cfg, model_name="resnet50"))
                                      .named_parameters())
    with pytest.raises(ValueError, match="norm"):
        make_model(dict(cfg, norm="batch"))
    with pytest.raises(ValueError, match="model_name"):
        make_model(dict(cfg, model_name="resnet200"))
