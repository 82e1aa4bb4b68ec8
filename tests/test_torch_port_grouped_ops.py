"""The pieces of the grouped engine in the PyTorch/CUDA port against the JAX
reference on the CPU: the sliced sub-models (host extract/embed and the
port's index maps against ``extract_sliced``/``embed_sliced``, exact), the
dense level models (names and shapes against ``make_model(cfg, rate)``, the
conversion both ways, exact), the batched batch norm (plain version against
``jax.vmap(batch_norm_pallas)`` in interpret mode, tolerance as the
one-client BN's: 2e-5 forward, 1e-4 gradients) and the batched fused SGD
(plain version against ``jax.vmap(fused_sgd_flat)`` with the Pallas kernel
in interpret mode at 1e-6 / 1e-7, and bit for bit against one-client
calls), and the batched forward of each vision
model against its one-client forward (scores and loss rtol 1e-4, atol
1e-5; gradients rtol 1e-3, atol 2e-5: the models' tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.fed.core import embed_sliced as r_embed
from heterofl_tpu.fed.core import extract_sliced as r_extract
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.ops.fused_update import fused_sgd_flat as r_fused_sgd
from heterofl_tpu.ops.pallas_norm import batch_norm_pallas
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
from heterofl_tpu_torch.fed import embed_sliced, extract_sliced, level_index_map, snap_to_levels
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.ops import fused_norm, fused_update
from heterofl_tpu_torch.ops.fused_update import FlatSpec
from heterofl_tpu_torch.ops.layers import clients_in_channels
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture

few_threads = thread_limit_fixture()

LEVELS = (1.0, 0.5, 0.25, 0.125, 0.0625)
MODELS = {  # model -> (data, override)
    "conv": ("MNIST", {"conv": {"hidden_size": [8, 16]}}),
    "resnet18": ("CIFAR10", {"resnet": {"hidden_size": [8, 16, 16, 16]}}),
    # at 8/16/16/16 a stage of 4 * 8 channels keeps 2 at level e, but the level
    # model's 4 * ceil(8 / 16): the bottleneck's sub-models need hidden sizes
    # that 16 divides
    "resnet50": ("CIFAR10", {"resnet": {"hidden_size": [16, 32, 32, 32]}}),
    "transformer": ("WikiText2", {"transformer": {"embedding_size": 128, "num_heads": 4,
                                                  "hidden_size": 64, "num_layers": 2,
                                                  "dropout": 0.0}, "bptt": 16}),
}


def _cfg(mod, model_name, norm="bn"):
    data, override = MODELS[model_name]
    cfg = mod.default_cfg()
    cfg.update(control=mod.parse_control_name(f"1_5_1_iid_fix_a1-b1-c1-d1-e1_{norm}_1_1"),
               data_name=data, model_name=model_name, override=override)
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    cfg["num_tokens"] = 50
    return cfg


@pytest.fixture(scope="module", params=list(MODELS))
def both_models(request):
    """The port's global model (seeded init) and the reference's, with the
    reference's params equal to the port's."""
    name = request.param
    pcfg, rcfg = _cfg(PC, name), _cfg(RC, name)
    model = make_model(pcfg).init_(torch.Generator().manual_seed(0))
    rmodel = r_make_model(rcfg)
    r_params = params_to_jax(dict(model.named_parameters()), model.jax_perms())
    return name, pcfg, rcfg, model, rmodel, r_params


def test_extract_embed_and_index_maps_match_reference(both_models):
    """At every level: the host extract (port layout) converted to the
    reference's layout equals ``extract_sliced``; the embed back equals
    ``embed_sliced``; the index map gathers exactly the extracted leaves
    from the flat global buffer and scatters them back (all exact)."""
    name, pcfg, rcfg, model, rmodel, r_params = both_models
    p_np = {k: v.detach().numpy() for k, v in model.named_parameters()}
    spec = FlatSpec.of(dict(model.named_parameters()))
    P = spec.flatten(dict(model.named_parameters())).detach()
    for wr in LEVELS:
        level = make_model(pcfg, wr)
        sub = extract_sliced(p_np, model.specs, model.groups, wr)
        r_sub = r_extract(r_params, rmodel.specs, rmodel.groups, wr)
        conv = params_to_jax({k: torch.from_numpy(v) for k, v in sub.items()}, level.jax_perms())
        assert sorted(conv) == sorted(r_sub)
        for k in r_sub:
            np.testing.assert_array_equal(conv[k], r_sub[k], err_msg=f"{name} {wr} {k}")
        back = embed_sliced(sub, model.specs, model.groups, wr, spec.shapes)
        r_back = r_embed(r_sub, rmodel.specs, rmodel.groups, wr,
                         {k: v.shape for k, v in r_params.items()})
        back_j = params_to_jax({k: torch.from_numpy(v) for k, v in back.items()},
                               model.jax_perms())
        for k in r_back:
            np.testing.assert_array_equal(back_j[k], r_back[k], err_msg=f"{name} {wr} {k}")
        lspec = FlatSpec.of(dict(level.named_parameters()))
        idx = torch.from_numpy(level_index_map(spec, lspec, model.specs, model.groups, wr))
        assert len(set(idx.tolist())) == idx.numel() == lspec.total
        flat_sub = lspec.flatten({k: torch.from_numpy(v) for k, v in sub.items()})
        assert torch.equal(P.index_select(0, idx), flat_sub)
        scattered = torch.zeros_like(P).index_add_(0, idx, flat_sub)
        assert torch.equal(scattered, spec.flatten({k: torch.from_numpy(v)
                                                    for k, v in back.items()}))
    print(f"parity extract/embed and index maps, {name}, levels a-e: max_abs_err 0 (exact)")


def test_level_models_match_reference(both_models):
    """``make_model(cfg, rate)``: the reference level model's parameter
    names and (converted) shapes, the Scaler rate ``rate / global rate``,
    and the conversion round trip of its initial params, exact."""
    name, pcfg, rcfg, model, rmodel, r_params = both_models
    for rate in LEVELS:
        level = make_model(pcfg, rate)
        r_level = r_make_model(rcfg, model_rate=rate)
        r_init = {k: np.asarray(v) for k, v in r_level.init(jax.random.key(1)).items()}
        shapes = params_to_jax(dict(level.named_parameters()), level.jax_perms())
        assert {k: v.shape for k, v in shapes.items()} == {k: v.shape for k, v in r_init.items()}
        assert level.meta["scaler_rate"] == r_level.meta["scaler_rate"] == rate
        back = params_to_jax(params_from_jax(r_init, level.jax_perms()), level.jax_perms())
        for k in r_init:
            np.testing.assert_array_equal(back[k], r_init[k])


def test_snap_to_levels():
    """Rates round-tripped through float32 snap onto the level table; a
    rate near no level raises naming it."""
    rates = np.asarray([1.0, 0.0625, 0.5], np.float32) * np.float32(1.0000001)
    np.testing.assert_array_equal(snap_to_levels(rates, LEVELS), [1.0, 0.0625, 0.5])
    with pytest.raises(ValueError, match="0.3"):
        snap_to_levels([0.3], LEVELS)


# --- the batched kernels' plain versions --------------------------------------------

def _bn_clients_inputs(G=3, B=4, H=4, W=4, C=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, B, H, W, C)).astype(np.float32) * 2.0 + 0.5
    g = rng.normal(size=(G, C)).astype(np.float32)
    b = rng.normal(size=(G, C)).astype(np.float32)
    w = np.ones((G, B), np.float32)
    w[G - 1, B - 1] = 0.0  # a padding sample of the last client
    w[1, 0] = 0.0
    dy = rng.normal(size=(G, B, H, W, C)).astype(np.float32)
    return x, g, b, w, dy


def test_batched_bn_plain_matches_vmapped_pallas_and_unbatched():
    """The batched BN's plain version on the clients-in-channels layout (C =
    4 per client, 3 clients, padding rows): against ``jax.vmap`` of
    ``batch_norm_pallas`` in interpret mode (y 2e-5, gradients 1e-4), and
    against G one-client plain calls (same tolerances)."""
    x, g, b, w, dy = _bn_clients_inputs()
    G, B, H, W, C = x.shape

    def r_loss(x_, g_, b_):
        y = jax.vmap(lambda xc, gc, bc, wc: batch_norm_pallas(
            xc, gc, bc, sample_weight=wc, block_m=32, interpret=True))(x_, g_, b_, jnp.asarray(w))
        return jnp.sum(y * jnp.asarray(dy)), y

    (_, y_ref), (dx_ref, dg_ref, db_ref) = jax.value_and_grad(r_loss, argnums=(0, 1, 2),
                                                              has_aux=True)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xt = clients_in_channels(torch.from_numpy(x)).detach().requires_grad_()
    gt, bt = torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = fused_norm.batch_norm_fused_clients(xt, gt, bt, torch.from_numpy(w))
    y.backward(clients_in_channels(torch.from_numpy(dy)))

    def per_client(t):  # [B, G*C, H, W] -> [G, B, H, W, C]
        return t.detach().reshape(B, G, C, H, W).permute(1, 0, 3, 4, 2).numpy()

    assert_close("batched bn plain y vs vmap(pallas)", per_client(y), y_ref, rtol=2e-5, atol=2e-5)
    assert_close("batched bn plain dx vs vmap(pallas)", per_client(xt.grad), dx_ref, rtol=1e-4,
                 atol=1e-4)
    assert_close("batched bn plain dg vs vmap(pallas)", gt.grad, dg_ref, rtol=1e-4, atol=1e-4)
    assert_close("batched bn plain db vs vmap(pallas)", bt.grad, db_ref, rtol=1e-4, atol=1e-4)
    # against G one-client calls of the plain kernels
    x2 = xt.detach().permute(0, 2, 3, 1).reshape(-1, G * C)
    dy2 = clients_in_channels(torch.from_numpy(dy)).permute(0, 2, 3, 1).reshape(-1, G * C)
    wt, gf, bf = torch.from_numpy(w), gt.detach().reshape(-1), bt.detach().reshape(-1)
    yb, st = fused_norm.bn_fwd_batched_plain(x2, wt, H * W, gf, bf)
    dxb, dgb, dbb = fused_norm.bn_bwd_batched_plain(x2, wt, H * W, gf, dy2, st)
    for c in range(G):
        cols = slice(c * C, (c + 1) * C)
        yu, su = fused_norm.bn_fwd_plain(x2[:, cols], wt[c], H * W, gf[cols], bf[cols])
        dxu, dgu, dbu = fused_norm.bn_bwd_plain(x2[:, cols], wt[c], H * W, gf[cols], dy2[:, cols],
                                                su)
        for what, a, u, tol in (("y", yb[:, cols], yu, 2e-5), ("stats", st[:, cols], su, 2e-5),
                                ("dx", dxb[:, cols], dxu, 1e-4), ("dg", dgb[cols], dgu, 1e-4),
                                ("db", dbb[cols], dbu, 1e-4)):
            assert_close(f"batched bn plain {what} vs one-client plain, client {c}", a, u,
                         rtol=tol, atol=tol)
    assert st[2].tolist() == [float(w[c].sum() * H * W) for c in range(G) for _ in range(C)]


SGD_SHAPES = {"a.w": (6, 5), "a.b": (6,), "b.g": (7,)}


@pytest.mark.parametrize("gscale", [1e-3, 3.0])
def test_batched_sgd_plain_matches_vmapped_pallas_and_unbatched(gscale):
    """The batched fused SGD's plain version over ``[G, n]`` (one client
    with ``has`` 0): against ``jax.vmap(fused_sgd_flat)`` with the Pallas
    kernel in interpret mode at rtol 1e-6 / atol 1e-7, the one-client
    clip's tolerance (the norm is summed in another order; and without the
    clip the vmapped reference lands one ulp off its own unbatched result
    on 1 of 129 entries, where the one-client plain version is held to it
    bit for bit), and against G one-client plain calls bit for bit."""
    G = 3
    rng = np.random.default_rng(4)
    rspec = RFlatSpec({k: s for k, s in SHAPES_SORTED().items()})
    spec = FlatSpec(SGD_SHAPES)
    n = spec.total
    p = rng.normal(size=(G, n)).astype(np.float32)
    buf = (rng.normal(size=(G, n)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(G, n)) * gscale).astype(np.float32)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    n_glob = np.asarray([7.0, 3.0, 0.0], np.float32)
    lr, kw = 0.05, dict(momentum=0.9, weight_decay=5e-4)
    masks = {k: jnp.asarray(v) for k, v in spec.unflatten(torch.from_numpy(mask)).items()}

    def one(pf, gf, bf, nn):
        grads = {k: v for k, v in rspec.unflatten(gf).items()}
        return r_fused_sgd(rspec, pf, grads, bf, masks, nn, jnp.float32(lr), max_norm=1.0,
                           has=nn > 0, mode="pallas", interpret=True, block_rows=1, **kw)

    rp, rb = jax.vmap(one)(jnp.asarray(p), jnp.asarray(g), jnp.asarray(buf), jnp.asarray(n_glob))
    scal = torch.stack([torch.from_numpy(n_glob).clamp_min(1e-6), torch.full((G,), lr),
                        torch.from_numpy((n_glob > 0).astype(np.float32))], 1)
    pt, bt = torch.from_numpy(p.copy()), torch.from_numpy(buf.copy())
    fused_update.fused_sgd_batched(torch.from_numpy(g), pt, bt, torch.from_numpy(mask), scal,
                                   max_norm=1.0, **kw)
    tol = (1e-6, 1e-7)
    clip = "clip" if gscale > 1 else "no clip"
    assert_close(f"batched sgd plain p vs vmap(pallas), {clip}", pt, rp, rtol=tol[0], atol=tol[1])
    assert_close(f"batched sgd plain buf vs vmap(pallas), {clip}", bt, rb, rtol=tol[0],
                 atol=tol[1])
    for c in range(G):
        pu, bu = fused_update.fused_sgd_plain(torch.from_numpy(g[c]), torch.from_numpy(p[c]),
                                              torch.from_numpy(buf[c]), torch.from_numpy(mask),
                                              scal[c], max_norm=1.0, **kw)
        assert torch.equal(pu, pt[c]) and torch.equal(bu, bt[c]), c
    np.testing.assert_array_equal(pt[2].numpy(), p[2])  # has = 0: untouched
    print(f"parity batched sgd plain vs one-client plain, {clip}: max_abs_err 0 (bit for bit)")


def SHAPES_SORTED():
    return {k: SGD_SHAPES[k] for k in sorted(SGD_SHAPES)}


# --- the batched forward of the models ----------------------------------------------------

@pytest.mark.parametrize("model_name,norm", [("conv", "bn"), ("conv", "ln"), ("resnet18", "bn"),
                                             ("resnet18", "in"), ("resnet50", "gn"),
                                             ("resnet18", "none")])
def test_forward_clients_matches_one_client_forward(model_name, norm):
    """A level model's batched forward of 3 clients (each its own params,
    labels, label mask and a padding sample) against its one-client forward
    per client: scores and loss rtol 1e-4, atol 1e-5; each client's
    gradient of ``loss * n`` rtol 1e-3, atol 2e-5 (ResNet-50: relative to
    each leaf's scale, as the norms test holds it)."""
    cfg = _cfg(PC, model_name, norm)
    cfg["pallas_norm"] = norm == "bn"
    if model_name == "conv":
        cfg["data_name"], cfg["data_shape"] = "CIFAR10", [32, 32, 3]
    model = make_model(cfg, 0.5)
    G, B = 3, 4
    ps = [{k: v.detach().clone() for k, v in make_model(cfg, 0.5).init_(
        torch.Generator().manual_seed(i)).named_parameters()} for i in range(G)]
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.normal(size=(G, B, 32, 32, 3)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 10, (G, B)))
    w = torch.ones(G, B)
    w[1, 3] = 0.0
    lm = torch.ones(G, 10)
    lm[2, 5:] = 0.0
    leaves = {k: torch.stack([p[k] for p in ps]).requires_grad_() for k in ps[0]}
    score, loss = model.forward_clients(clients_in_channels(imgs), lab, G, params=leaves,
                                        scaler_rate=0.5, label_mask=lm, sample_weight=w)
    names = sorted(leaves)
    grads = torch.autograd.grad((loss * w.sum(1)).sum(), [leaves[k] for k in names])
    for c in range(G):
        lv = {k: v.clone().requires_grad_() for k, v in ps[c].items()}
        img = imgs[c].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        s1, l1 = model(img, lab[c], params=lv, width_rate=1.0, scaler_rate=0.5,
                       label_mask=lm[c], sample_weight=w[c])
        g1 = torch.autograd.grad(l1 * w[c].sum(), [lv[k] for k in names])
        case = f"{model_name}/{norm} client {c}"
        assert_close(f"forward_clients scores, {case}", score[c], s1, rtol=1e-4, atol=1e-5)
        assert_close(f"forward_clients loss, {case}", loss[c], l1, rtol=1e-4, atol=1e-5)
        for k, a, u in zip(names, grads, g1):
            scale = float(u.abs().max()) if model_name == "resnet50" else 1.0
            np.testing.assert_allclose(a[c].numpy() / max(scale, 1e-12),
                                       u.numpy() / max(scale, 1e-12), rtol=1e-3, atol=2e-5,
                                       err_msg=f"{case} {k}")
