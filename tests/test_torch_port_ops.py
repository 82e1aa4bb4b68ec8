"""Op parity of the PyTorch/CUDA port against the JAX reference on the CPU.

The port's plain kernel versions are held against the reference's Pallas
kernels in interpret mode (``interpret=True``, as the reference's own CPU
tests run them) and its XLA paths; the masked layers against
``heterofl_tpu.ops.layers``.  Inputs are made with numpy from a seed and
handed to both sides.  Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu.ops import augment as r_aug
from heterofl_tpu.ops import layers as r_layers
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.ops.fused_update import fused_sgd_flat as r_fused_sgd
from heterofl_tpu.ops.pallas_norm import _call_fwd as r_bn_call_fwd
from heterofl_tpu.ops.pallas_norm import batch_norm_pallas
from heterofl_tpu_torch.ops import augment, fused_norm, fused_update, layers
from heterofl_tpu_torch.ops.fused_update import FlatSpec, fused_sgd_flat, fused_sgd_plain, make_scal
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from heterofl_tpu_torch.utils import clip_by_global_norm, sgd_update


few_threads = thread_limit_fixture()

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _bn_inputs(seed, shape=(10, 8, 8, 32), nan_row=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 2.0 + 0.5
    C = shape[-1]
    g = rng.normal(size=C).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    g[3 * C // 4:] = 0.0
    b[3 * C // 4:] = 0.0  # masked channels of a narrower client
    w = np.ones(shape[0], np.float32)
    w[[2, shape[0] - 1]] = 0.0  # zero-weight (padding) samples
    if nan_row:
        x[shape[0] - 1, 1, 2, :] = np.nan
    dy = rng.normal(size=shape).astype(np.float32)
    return x, g, b, w, dy


# --- batch norm -------------------------------------------------------------

def test_fused_bn_plain_matches_pallas_fwd_and_grads():
    """Plain BN forward and its dx/dg/db (the autograd.Function's backward)
    against batch_norm_pallas in interpret mode with block_m=256 (M=640:
    three blocks), zero-weight rows and masked channels.  Tolerance:
    rtol/atol 2e-5 (forward), 1e-4 (grads; sums in another order)."""
    x, g, b, w, dy = _bn_inputs(0)

    def r_loss(x_, g_, b_):
        y = batch_norm_pallas(x_, g_, b_, sample_weight=jnp.asarray(w), block_m=256,
                              interpret=True)
        return jnp.sum(y * jnp.asarray(dy)), y

    (_, y_ref), (dx_ref, dg_ref, db_ref) = jax.value_and_grad(r_loss, argnums=(0, 1, 2),
                                                              has_aux=True)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xt = _nchw(x).requires_grad_()
    gt, bt = torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = fused_norm.batch_norm_fused(xt, gt, bt, sample_weight=torch.from_numpy(w))
    y.backward(_nchw(dy))
    assert_close("bn plain y vs pallas", _nhwc(y), y_ref, rtol=2e-5, atol=2e-5)
    assert_close("bn plain dx vs pallas", _nhwc(xt.grad), dx_ref, rtol=1e-4, atol=1e-4)
    assert_close("bn plain dg vs pallas", gt.grad, dg_ref, rtol=1e-4, atol=1e-4)
    assert_close("bn plain db vs pallas", bt.grad, db_ref, rtol=1e-4, atol=1e-4)
    assert np.all(_nhwc(y)[..., 24:] == 0.0)


def test_fused_bn_nonfinite_zero_weight_row_spares_stats():
    """A NaN in a zero-weight row stays out of the statistics (select, not
    multiply): stats equal the reference kernel's (rtol/atol 1e-5), every
    other row's output is finite and matches (rtol/atol 2e-5)."""
    x, g, b, w, _ = _bn_inputs(1, nan_row=True)
    C = x.shape[-1]
    x2 = x.reshape(-1, C)
    P = x2.shape[0] // x.shape[0]
    wr = np.repeat(w, P).reshape(-1, 1)
    y_ref, st_ref = r_bn_call_fwd(jnp.asarray(x2), jnp.asarray(wr), jnp.asarray(g),
                                  jnp.asarray(b), 1e-5, 256, True)
    y2, st = fused_norm.bn_fwd_plain(torch.from_numpy(x2), torch.from_numpy(w), P,
                                     torch.from_numpy(g), torch.from_numpy(b))
    assert torch.isfinite(st).all()
    assert_close("bn plain stats vs pallas, NaN in a zero-weight row", st,
                 np.asarray(st_ref)[:3], rtol=1e-5, atol=1e-5)
    finite = np.isfinite(x2).all(1)
    assert (~finite).sum() == 1
    assert torch.isfinite(y2[torch.from_numpy(finite)]).all()
    assert_close("bn plain y vs pallas, NaN in a zero-weight row", y2.numpy()[finite],
                 np.asarray(y_ref)[finite], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_two_pass_batch_norm_matches_reference(weighted):
    """The plain two-pass ``batch_norm`` (the pallas_norm=False path) against
    the reference's ``batch_norm(mode='batch')``; rtol/atol 1e-5."""
    x, g, b, w, _ = _bn_inputs(2, shape=(6, 5, 5, 16))
    sw = w if weighted else None
    ref, _ = r_layers.batch_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), mode="batch",
                                 sample_weight=None if sw is None else jnp.asarray(sw))
    out, _ = layers.batch_norm(_nchw(x), torch.from_numpy(g), torch.from_numpy(b),
                               sample_weight=None if sw is None else torch.from_numpy(sw))
    assert_close(f"two-pass batch_norm vs reference (weighted={weighted})", _nhwc(out), ref,
                 rtol=1e-5, atol=1e-5)


# --- fused masked SGD ---------------------------------------------------------

SHAPES = {"a.w": (3, 3, 4, 8), "a.b": (8,), "b.g": (8,), "c.w": (8, 10), "c.b": (10,)}


def _sgd_inputs(seed, gscale):
    rng = np.random.default_rng(seed)
    mk = lambda s, sc: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    p = {k: mk(s, 1.0) for k, s in SHAPES.items()}
    bufs = {k: mk(s, 0.1) for k, s in SHAPES.items()}
    grads = {k: mk(s, gscale) for k, s in SHAPES.items()}
    masks = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
    # a narrow level: the trailing 6 of 8 channels are inactive rows
    masks["a.w"][..., 2:] = 0.0
    masks["a.b"][2:] = 0.0
    masks["b.g"][2:] = 0.0
    masks["c.w"][2:, :] = 0.0
    for k in ("a.w", "a.b", "b.g", "c.w"):
        p[k] = p[k] * masks[k]
        bufs[k] = bufs[k] * masks[k]
    return p, bufs, grads, masks


def _run_both(seed, gscale, has, n_glob=7.0, lr=0.05, momentum=0.9, wd=5e-4):
    p, bufs, grads, masks = _sgd_inputs(seed, gscale)
    rspec = RFlatSpec.of({k: jnp.asarray(v) for k, v in p.items()})
    pf = rspec.flatten({k: jnp.asarray(v) for k, v in p.items()})
    bf = rspec.flatten({k: jnp.asarray(v) for k, v in bufs.items()})
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jm = {k: jnp.asarray(v) for k, v in masks.items()}
    refs = {}
    for mode in ("xla", "pallas"):
        kw = dict(momentum=momentum, weight_decay=wd, max_norm=1.0, has=jnp.asarray(has),
                  mode=mode)
        if mode == "pallas":
            kw.update(interpret=True, block_rows=1)
        np_, nb = r_fused_sgd(rspec, pf, jg, bf, jm, jnp.float32(n_glob), jnp.float32(lr), **kw)
        refs[mode] = (np.asarray(np_), np.asarray(nb))
    spec = FlatSpec({k: tuple(s) for k, s in SHAPES.items()})
    t = lambda d: spec.flatten({k: torch.from_numpy(v) for k, v in d.items()})  # noqa: E731
    scal = torch.tensor([n_glob, lr, float(has)], dtype=torch.float32)
    pn, bn = fused_sgd_plain(t(grads), t(p), t(bufs), t(masks), scal, momentum=momentum,
                             weight_decay=wd, max_norm=1.0)
    return (pn.numpy(), bn.numpy()), refs, (t(p).numpy(), t(bufs).numpy()), t(masks).numpy()


@pytest.mark.parametrize("has", [True, False])
def test_fused_sgd_plain_bitwise_without_clip(has):
    """No clip engaged (small grads): the plain version equals the reference's
    Pallas kernel (interpret) and XLA path BIT FOR BIT; ``has=False`` leaves
    p and buf unchanged; inactive (level-narrowed) rows stay exactly zero."""
    port, refs, (p0, b0), mask = _run_both(0, 1e-3, has)
    for mode, (rp, rb) in refs.items():
        assert_close(f"fused sgd plain p vs {mode}, no clip, has={has}", port[0], rp, rtol=0, atol=0)
        assert_close(f"fused sgd plain buf vs {mode}, no clip, has={has}", port[1], rb, rtol=0,
                     atol=0)
    if not has:
        np.testing.assert_array_equal(port[0], p0)
        np.testing.assert_array_equal(port[1], b0)
    assert np.all(port[0][mask == 0] == 0.0) and np.all(port[1][mask == 0] == 0.0)


def test_fused_sgd_plain_with_clip():
    """Clip engaged (large grads): agreement to rtol 1e-6 / atol 1e-7 -- the
    norm is summed in another order (flat, not per leaf / per block), so the
    scale may differ in the last ulp."""
    port, refs, _, mask = _run_both(1, 3.0, True)
    for mode, (rp, rb) in refs.items():
        assert_close(f"fused sgd plain p vs {mode}, clip", port[0], rp, rtol=1e-6, atol=1e-7)
        assert_close(f"fused sgd plain buf vs {mode}, clip", port[1], rb, rtol=1e-6, atol=1e-7)
    assert np.all(port[0][mask == 0] == 0.0)


@pytest.mark.parametrize("gscale", [1e-3, 3.0])
def test_fused_sgd_plain_matches_port_tree_chain(gscale):
    """The flat plain version against the port's own per-tree chain
    (mean-normalise, mask, ``clip_by_global_norm``, ``sgd_update``): bitwise
    with the clip not engaged; rtol 1e-6 / atol 1e-7 with it engaged (the
    norm is summed per leaf there, flat here)."""
    p, bufs, grads, masks = _sgd_inputs(2, gscale)
    tree = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    n_glob, lr, clip = 7.0, 0.05, gscale > 1
    gm = {k: (g / n_glob) * masks[k] for k, g in tree(grads).items()}
    gm, total = clip_by_global_norm(gm, 1.0)
    assert bool(total > 1.0) == clip
    tp, tb = sgd_update(tree(p), gm, tree(bufs), lr, 0.9, 5e-4)
    spec = FlatSpec({k: tuple(s) for k, s in SHAPES.items()})
    flat = lambda d: spec.flatten(tree(d))  # noqa: E731
    fp, fb = fused_sgd_plain(flat(grads), flat(p), flat(bufs), flat(masks),
                             torch.tensor([n_glob, lr, 1.0]), momentum=0.9, weight_decay=5e-4)
    tol = dict(rtol=1e-6, atol=1e-7) if clip else dict(rtol=0, atol=0)
    assert_close(f"fused sgd plain p vs tree chain, clip={clip}", fp, spec.flatten(tp), **tol)
    assert_close(f"fused sgd plain buf vs tree chain, clip={clip}", fb, spec.flatten(tb), **tol)


def test_schedulers_match_reference():
    """``make_scheduler`` for every stateless kind: the same LR as the
    reference at every round of a 400-round run (exact); an unknown kind
    raises as the reference's does."""
    from heterofl_tpu.utils.optim import make_scheduler as r_make_scheduler
    from heterofl_tpu_torch.utils import make_scheduler

    base = {"lr": 0.1, "factor": 0.1, "milestones": [150, 250], "step_size": 30,
            "num_epochs": {"global": 400, "local": 5}}
    for name in ("None", "StepLR", "MultiStepLR", "ExponentialLR", "CosineAnnealingLR",
                 "CyclicLR"):
        cfg = dict(base, scheduler_name=name)
        port, ref = make_scheduler(cfg), r_make_scheduler(cfg)
        assert [port(e) for e in range(1, 401)] == [ref(e) for e in range(1, 401)], name
    with pytest.raises(ValueError, match="scheduler"):
        make_scheduler(dict(base, scheduler_name="LinearLR"))


def test_fused_sgd_wrapper_updates_in_place_on_cpu():
    """The wrapper takes the plain version for CPU tensors, in place."""
    g, p, b, m = (torch.randn(1000) for _ in range(4))
    scal = make_scal(torch.tensor(3.0), torch.tensor(0.1))
    ref = fused_sgd_plain(g, p, b, m, scal, momentum=0.9, weight_decay=5e-4)
    pid = p.data_ptr()
    out = fused_sgd_flat(g, p, b, m, scal, momentum=0.9, weight_decay=5e-4)
    assert out[0].data_ptr() == pid
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_cuda_mode_wrappers_raise_without_cuda():
    """A wrapper asked for the CUDA kernel with no CUDA tensor raises; it never
    falls back to the plain version."""
    x = torch.randn(20, 8)
    w, g, b = torch.ones(2), torch.ones(8), torch.zeros(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_norm.bn_fwd_cuda(x, w, 10, g, b)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_norm.bn_bwd_cuda(x, w, 10, g, x, torch.ones(3, 8))
    v = torch.randn(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_update.fused_sgd_cuda(v, v.clone(), v.clone(), v.clone(), torch.ones(3),
                                    momentum=0.9, weight_decay=0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_update.resolve_fused_mode({"fused_update": "cuda", "optimizer_name": "SGD"},
                                        torch.device("cpu"))
    cpu = torch.device("cpu")
    assert fused_update.resolve_fused_mode({"optimizer_name": "SGD"}, cpu) == "plain"
    assert fused_update.resolve_fused_mode({"fused_update": False}, cpu) is None
    with pytest.raises(ValueError, match="fused_update"):
        fused_update.resolve_fused_mode({"fused_update": "plain"}, cpu)
    # and the batched kernels of the grouped engine
    wg = torch.ones(2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_norm.bn_fwd_batched_cuda(x, wg, 10, g, b)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_norm.bn_bwd_batched_cuda(x, wg, 10, g, x, torch.ones(3, 8))
    vv = torch.randn(2, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_update.fused_sgd_batched_cuda(vv, vv.clone(), vv.clone(), v.clone(),
                                            torch.ones(2, 3), momentum=0.9, weight_decay=0.0)
    assert fused_norm.LAUNCHES == {"bn_fwd": 0, "bn_bwd": 0, "bn_fwd_batched": 0,
                                   "bn_bwd_batched": 0}
    assert fused_update.LAUNCHES == {"fused_sgd": 0, "fused_sgd_batched": 0}


# --- layers and augmentation ---------------------------------------------------

def test_layers_match_reference():
    """conv2d (3x3 pad 1, 1x1 stride 2), linear, pools, masked logits, weighted
    cross entropy against the reference ops; rtol/atol 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 9, 9, 4)).astype(np.float32)
    for k, s, pad in ((3, 1, 1), (1, 2, 0)):
        w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
        bias = rng.normal(size=6).astype(np.float32)
        ref = r_layers.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), stride=s,
                              padding=pad)
        out = layers.conv2d(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                            torch.from_numpy(bias), stride=s, padding=pad)
        assert_close(f"conv2d {k}x{k} stride {s} vs reference", _nhwc(out), ref, rtol=1e-5,
                     atol=1e-5)
    assert_close("max_pool2 vs reference", _nhwc(layers.max_pool2(_nchw(x))),
                 r_layers.max_pool2(jnp.asarray(x)), rtol=0, atol=0)
    assert_close("global_avg_pool vs reference", layers.global_avg_pool(_nchw(x)),
                 r_layers.global_avg_pool(jnp.asarray(x)), rtol=1e-5, atol=1e-6)
    h = rng.normal(size=(5, 7)).astype(np.float32)
    lw = rng.normal(size=(7, 10)).astype(np.float32)
    lb = rng.normal(size=10).astype(np.float32)
    logits = r_layers.linear(jnp.asarray(h), jnp.asarray(lw), jnp.asarray(lb))
    out = layers.linear(torch.from_numpy(h), torch.from_numpy(lw).t(), torch.from_numpy(lb))
    assert_close("linear vs reference", out, logits, rtol=1e-5, atol=1e-5)
    lm = np.array([1, 1, 0, 1, 0, 0, 1, 1, 1, 0], np.float32)
    ml_ref = r_layers.masked_logits(logits, jnp.asarray(lm), True)
    ml = layers.masked_logits(out, torch.from_numpy(lm), True)
    assert_close("masked_logits vs reference", ml, ml_ref, rtol=1e-5, atol=1e-5)
    labels = np.array([0, 3, 6, 7, 1])
    sw = np.array([1, 1, 0, 1, 1], np.float32)
    assert_close("weighted cross_entropy vs reference",
                 layers.cross_entropy(ml, torch.from_numpy(labels), torch.from_numpy(sw)),
                 r_layers.cross_entropy(ml_ref, jnp.asarray(labels), jnp.asarray(sw)),
                 rtol=1e-5, atol=1e-6)


def test_augment_and_normalize_match_reference():
    """With the reference's own crop offsets and flips injected, the port's
    crop + flip is bit-identical; normalisation agrees to rtol/atol 1e-6;
    generator draws stay in range."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 255, size=(6, 32, 32, 3)).astype(np.uint8)
    key = jax.random.key(11)
    k_shift, k_flip = jax.random.split(key)
    shifts = np.asarray(jax.random.randint(k_shift, (6, 2), 0, 9))
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (6,)))
    ref = np.asarray(r_aug.augment_cifar(key, jnp.asarray(x)))
    out = augment.augment_cifar(torch.from_numpy(x), offsets=torch.from_numpy(shifts).long(),
                                flips=torch.from_numpy(flips))
    assert_close("augment_cifar (injected draws) vs reference", out, ref, rtol=0, atol=0)
    stats = ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010))
    assert_close("normalize_image vs reference", augment.normalize_image(out, *stats),
                 r_aug.normalize_image(jnp.asarray(ref), *stats), rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    offs, fl = augment.augment_draws(64, gen, "cpu")
    assert offs.min() >= 0 and offs.max() <= 8 and fl.dtype == torch.bool
    assert augment.augment_cifar(torch.from_numpy(x), gen).shape == x.shape
