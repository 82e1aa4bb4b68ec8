"""The wire codec path of the PyTorch/CUDA port against the JAX reference on
the CPU: lane packing, the quantise-and-pack pass (the plain version of the
``csrc/quant.cu`` kernel) against the reference's XLA path and its Pallas
kernel in interpret mode, the three codecs, the codec config, and two
compressed rounds against ``RoundEngine.train_round`` with the residual
carried.  The reference's ``jax.random`` draws (noise, block offset, epoch
permutations) are injected into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.compress import make_codec as r_make_codec
from heterofl_tpu.fed.core import client_stream_keys
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.models.spec import count_masks as r_count_masks
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.ops.quant import pack_lanes as r_pack_lanes
from heterofl_tpu.ops.quant import quantize_pack as r_quantize_pack
from heterofl_tpu.ops.quant import unpack_lanes as r_unpack_lanes
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress import CODEC_NAMES, make_codec, resolve_codec_cfg
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT, compressed_sum
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.fed.core import to_width_rates
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.ops import quant
from heterofl_tpu_torch.ops.fused_update import FlatSpec
from heterofl_tpu_torch.parallel import RoundEngine
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture

from test_torch_port_round import CONTROL, LR, _data

few_threads = thread_limit_fixture()

RATE_LM = np.array([[1, 1, 0, 0, 0, 0, 0, 0, 0, 0],
                    [0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
                    [1, 0, 0, 0, 1, 0, 0, 0, 0, 0],
                    [0, 0, 0, 1, 0, 0, 0, 0, 1, 0]], np.float32)  # labels 5, 6, 7, 9: no one


def _eq(what, a, b):
    assert_close(what, a, b, rtol=0, atol=0)


# --- lane packing -------------------------------------------------------------

@pytest.mark.parametrize("lane_bits", [8, 4])
@pytest.mark.parametrize("rem", [0, 1, 2, 3])
def test_lane_packing_matches_reference(lane_bits, rem):
    """``pack_lanes``/``unpack_lanes`` against the reference, n = 4k + rem:
    the same words (top lanes >= 2**(lane_bits-1) included, so words are
    negative int32) and the same lanes back, exactly."""
    n = 100 + rem
    q = np.random.default_rng(rem).integers(0, 1 << lane_bits, n).astype(np.int32)
    q[lane_bits - 1::32 // lane_bits] = (1 << lane_bits) - 1  # a full top lane in every word
    w_ref = np.asarray(r_pack_lanes(jnp.asarray(q), lane_bits))
    w = quant.pack_lanes(torch.from_numpy(q), lane_bits)
    assert w.dtype == torch.int32 and (w_ref < 0).any()
    _eq(f"pack_lanes {lane_bits}-bit n={n}", w, w_ref)
    back = quant.unpack_lanes(w, lane_bits, n)
    _eq(f"unpack_lanes {lane_bits}-bit n={n}", back,
        np.asarray(r_unpack_lanes(jnp.asarray(w_ref), lane_bits, n)))
    np.testing.assert_array_equal(back.numpy(), q)


# --- quantise and pack --------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 1002, 4099])
@pytest.mark.parametrize("qmax,bias", [(127, 128), (15, 16)])
def test_quant_pack_plain_matches_reference(n, qmax, bias):
    """The kernel's plain version against ``quantize_pack`` with the
    reference's noise ``u = uniform(key, (n,))`` injected: ``q`` and the
    words equal the XLA path's exactly; ``q`` equals the Pallas kernel's
    (interpret mode), and so do the words, except the padding lanes of the
    last word when ``n % 4 != 0``: the Pallas path pads with x=0, s=1, u=0,
    so each such lane holds ``bias``, where the plain version (like the XLA
    path) leaves it zero.  That one difference is pinned here."""
    rng = np.random.default_rng(n + qmax)
    x = rng.normal(0, 2, n).astype(np.float32)
    s = rng.uniform(0.02, 0.2, n).astype(np.float32)  # |x/s| > qmax for some: clipped
    key = jax.random.key(5)
    u = np.array(jax.random.uniform(key, (n,), jnp.float32))
    w_x, q_x = r_quantize_pack(jnp.asarray(x), jnp.asarray(s), key, qmax, bias, mode="xla")
    w_p, q_p = r_quantize_pack(jnp.asarray(x), jnp.asarray(s), key, qmax, bias, mode="pallas",
                               interpret=True)
    w, q = quant.quantize_pack(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(u),
                               qmax, bias)
    case = f"quant_pack n={n} qmax={qmax}"
    assert (np.abs(q.numpy()) == qmax).any() and w.shape == (-(-n // 4),)
    _eq(f"{case}: q vs xla", q, q_x)
    _eq(f"{case}: words vs xla", w, w_x)
    _eq(f"{case}: q vs pallas", q, q_p)
    w_p = np.asarray(w_p)
    _eq(f"{case}: words vs pallas but the last", w[:-1], w_p[:-1])
    tail = w.numpy()[-1:].view(np.uint32)[0]
    for k in range(n % 4, 4) if n % 4 else ():
        tail |= np.uint32(bias) << np.uint32(8 * k)
    assert w_p[-1:].view(np.uint32)[0] == tail


def test_quant_pack_cuda_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; the dispatch never sends
    a CPU tensor to it (and a CUDA tensor never to the plain version)."""
    x = torch.zeros(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        quant.quant_pack_cuda(x, torch.ones(8), x, 127, 128)
    assert quant.LAUNCHES["quant_pack"] == 0


# --- codecs -------------------------------------------------------------------

def _conv_cfg(mod, **extra):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(CONTROL)
    cfg["data_name"], cfg["model_name"] = "MNIST", "conv"
    cfg["override"] = {"num_epochs": {"local": 2}, "conv": {"hidden_size": [8, 16]}}
    cfg.update(extra)
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


@pytest.fixture(scope="module")
def codec_inputs():
    """A masked round's flat (sums, counts) on the reference's MNIST-conv
    shapes: 4 clients at widths 1, 0.5, 0.25, 0.0625 under a non-iid label
    mask (no client holds labels 5, 6, 7 or 9, so their classifier rows
    count 0), a residual and the global params."""
    rcfg = _conv_cfg(RC)
    rmodel = r_make_model(rcfg)
    params = {k: np.array(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    shapes = {k: v.shape for k, v in params.items()}
    spec = RFlatSpec(shapes)
    rng = np.random.default_rng(4)
    sums = np.zeros(spec.total, np.float32)
    cnts = np.zeros(spec.total, np.float32)
    for wr, lm in zip((1.0, 0.5, 0.25, 0.0625), RATE_LM):
        cm = np.asarray(spec.flatten(r_count_masks(shapes, rmodel.specs, rmodel.groups, wr,
                                                   jnp.asarray(lm))))
        trained = np.asarray(spec.flatten(params)) + rng.normal(0, 0.05, spec.total)
        sums += (trained * cm).astype(np.float32)
        cnts += cm
    assert (cnts == 0).any() and (cnts == 4).any()
    resid = rng.normal(0, 0.01, (2, spec.total)).astype(np.float32)
    return params, shapes, sums, cnts, resid


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("name", ["int8", "signsgd", "topk"])
def test_codec_matches_reference(codec_inputs, name, ef):
    """Encode and decode of one participant against the reference codec
    (``axis=None``), the reference's noise (``fold_in(key, 9173)``) and
    block offset injected: payload, new residual, decoded sums and counts
    exactly equal -- but for signsgd's per-leaf mean magnitude ``s``, a
    float32 mean over each leaf (up to 4,608 entries here) summed in
    another order than XLA's: measured up to 3 ulps apart (4 of 10 leaves
    differ, max abs 2.4e-7), so ``s`` and the decoded sums (``+-s``) are
    held to rtol 5e-7 (4 ulps) and the residual (``x -+ s``) to atol 5e-7
    x max ``s``; its sign bits and counts stay exact."""
    params, shapes, sums, cnts, resid = codec_inputs
    cmax = 4
    resid = resid[:2 if name == "topk" else 1]
    rcodec = r_make_codec(name, RFlatSpec(shapes), 1, error_feedback=ef, axis=None)
    key = jax.random.key(11)
    r_pay, r_resid = rcodec.encode(jnp.asarray(sums), jnp.asarray(cnts), jnp.asarray(resid),
                                   {k: jnp.asarray(v) for k, v in params.items()}, key, cmax)
    r_sums, r_cnts = rcodec.decode(r_pay, params, key, cmax)
    spec = FlatSpec(shapes)
    codec = make_codec(name, spec, 1, error_feedback=ef)
    draw = None
    if name == "int8":
        draw = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, QUANT_NOISE_SALT), (spec.total,), jnp.float32)))
    elif name == "topk":
        draw = int(rcodec._offset(key))
    P = spec.flatten({k: torch.from_numpy(v) for k, v in params.items()})
    t = torch.from_numpy
    pay, new_resid = codec.encode(t(sums), t(cnts), t(resid), P, draw, cmax)
    out_sums, out_cnts, resid2 = compressed_sum(codec, P, t(sums), t(cnts), t(resid), draw, cmax)
    case = f"codec {name} ef={ef}"
    rtol = 5e-7 if name == "signsgd" else 0.0
    atol = rtol * float(np.max(np.asarray(r_pay["s"]))) if name == "signsgd" else 0.0
    assert sorted(pay) == sorted(r_pay)
    for k in pay:
        assert_close(f"{case}: payload {k}", pay[k], np.asarray(r_pay[k]),
                     rtol=rtol if k == "s" else 0.0, atol=0)
    assert_close(f"{case}: residual", new_resid, np.asarray(r_resid), rtol=0, atol=atol)
    assert_close(f"{case}: decoded sums", out_sums, np.asarray(r_sums), rtol=rtol, atol=0)
    _eq(f"{case}: decoded counts", out_cnts, np.asarray(r_cnts))
    np.testing.assert_array_equal(resid2.numpy(), new_resid.numpy())
    assert codec.payload_bytes() == rcodec.payload_bytes()


def test_codec_capacity_checks_raise_as_reference():
    """Participant limits at construction and the count-lane capacity at
    encode raise ``ValueError`` where the reference's do, and pass where
    they pass."""
    rspec, spec = RFlatSpec({"w": (64,)}), FlatSpec({"w": (64,)})
    for make, sp, kw in ((r_make_codec, rspec, {"axis": None}), (make_codec, spec, {})):
        make("signsgd", sp, 15, **kw)
        make("int8", sp, 64, **kw)
        for name, p, match in (("signsgd", 16, "participants"), ("int8", 65, "participants")):
            with pytest.raises(ValueError, match=match):
                make(name, sp, p, **kw)
        with pytest.raises(ValueError, match="flat elements"):
            make("topk", type(sp)({"w": (2,)}), 4, **kw)
        codec = make("int8", sp, 1, **kw)
        codec._check_count_capacity(255, 8)
        with pytest.raises(ValueError, match="count lanes overflow"):
            codec._check_count_capacity(256, 8)
    assert make_codec("int8", spec, 1).qmax == 127 and make_codec("int8", spec, 8).qmax == 15
    assert make_codec("dense", spec, 1) is None


# --- config -------------------------------------------------------------------

def test_codec_config_accepts_and_rejects():
    """``resolve_codec_cfg`` and ``check_ported`` take the four codecs; a
    typo and a non-bool ``error_feedback`` raise ``ValueError``; a
    per-level map raises ``NotImplementedError`` (it is not run dense)."""
    assert resolve_codec_cfg({}) == ("dense", True)
    for name in CODEC_NAMES:
        assert resolve_codec_cfg({"wire_codec": name, "error_feedback": False}) == (name, False)
        PC.check_ported(dict(PC.default_cfg(), wire_codec=name))
    for bad, exc, match in (({"wire_codec": "int4"}, ValueError, "Not valid wire_codec"),
                            ({"wire_codec": "Dense"}, ValueError, "Not valid wire_codec"),
                            ({"error_feedback": 1}, ValueError, "Not valid error_feedback"),
                            ({"error_feedback": "off"}, ValueError, "Not valid error_feedback"),
                            ({"wire_codec": {"1.0": "int8", "0.5": "dense"}},
                             ValueError, "per-level"),
                            ):
        with pytest.raises(exc, match=match):
            resolve_codec_cfg(bad)
        with pytest.raises(exc, match=match):
            _conv_cfg(PC, **bad)
    with pytest.raises(ValueError, match="sliced"):  # invalid in the reference too
        resolve_codec_cfg({"wire_codec": "int8", "strategy": "sliced"})
    assert _conv_cfg(PC, wire_codec="topk")["wire_codec"] == "topk"


def test_wire_resid_carry_set_and_reset():
    """The engine's residual carry for a checkpoint: none before the first
    compressed round; ``set_wire_resid`` restores a ``[slots, total]`` host
    array (any other shape raises), ``wire_resid_host`` gives it back, and
    ``reset_carries`` drops it.  Under ``dense`` there is no codec."""
    for name, slots in (("int8", 1), ("topk", 2)):
        cfg = _conv_cfg(PC, wire_codec=name)
        eng = RoundEngine(make_model(cfg), cfg, torch.device("cpu"))
        assert eng.wire_resid_host() is None and eng.codec.resid_slots == slots
        arr = np.random.default_rng(1).normal(size=(slots, eng.spec.total)).astype(np.float32)
        eng.set_wire_resid(arr)
        np.testing.assert_array_equal(eng.wire_resid_host(), arr)
        with pytest.raises(ValueError, match="shape"):
            eng.set_wire_resid(arr[:, :-1])
        eng.reset_carries()
        assert eng.wire_resid_host() is None
    cfg = _conv_cfg(PC)
    assert RoundEngine(make_model(cfg), cfg, torch.device("cpu")).codec is None


# --- two compressed rounds against the reference engine -----------------------

def _perms(key, users, E, N):
    slot_keys = client_stream_keys(key, jnp.asarray(users))
    return {int(u): np.stack([np.asarray(jax.random.permutation(k, N)) for k in
                              jax.random.split(jax.random.fold_in(slot_keys[i], 1), E)])
            for i, u in enumerate(users)}


@pytest.mark.parametrize("ef", [True, False])
def test_two_int8_rounds_match_reference_round_engine(ef):
    """Two ``train_round`` calls of the port (int8 codec, residual carried)
    against two of the reference's on ``make_mesh(1, 1)``, from the same
    params, with the reference's epoch permutations and codec noise
    ``uniform(fold_in(fold_in(key, 9173), 0), (total,))`` -- the draw inside
    its ``shard_map`` -- injected.

    Contract: the trained sums differ by float32 reduction order (up to
    5e-5 in params after a plain round), so a few entries land one grid
    step apart.  New params agree within 5e-5 everywhere but at most 2% of
    entries, each of which differs by at most one step ``s_leaf / count``
    (+5e-5).  The residual ``x - q * s`` keeps the trained sum's own float
    difference (a sum of up to 4 clients' params): within 4 x 5e-5 but at
    most 2% of entries, each at most one step ``s_leaf`` (+2e-4) apart.
    ``n`` exactly.  In round 2 each side starts from its own round-1 params
    and residual.  Measured: round 1 params equal, residual max 1.1e-4 with
    no entry a step apart; round 2 params 1 (EF on) and 3 (EF off) of 1,466
    entries a step apart, the residual 15 (1.02%)."""
    rcfg = _conv_cfg(RC, wire_codec="int8", error_feedback=ef)
    pcfg = _conv_cfg(PC, wire_codec="int8", error_feedback=ef)
    arrays = _data()
    users = np.array([0, 1, 2, 3])
    E, N = rcfg["num_epochs"]["local"], arrays[0].shape[1]
    rmodel = r_make_model(rcfg)
    params = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    reng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params))
    peng = RoundEngine(model, pcfg, torch.device("cpu"))
    rspec, spec = RFlatSpec({k: v.shape for k, v in params.items()}), peng.spec

    def to_port(ref_flat):  # reference flat layout -> the port's
        leaves = {k: np.asarray(v) for k, v in rspec.unflatten(jnp.asarray(ref_flat)).items()}
        return spec.flatten(params_from_jax(leaves))

    data = tuple(torch.from_numpy(a) for a in arrays)
    wrs = to_width_rates(peng.fix_rates[users], pcfg)
    counts = torch.stack([peng.count_mask_flat(float(wr), data[3][u])
                          for u, wr in zip(users, wrs)]).sum(0)
    r_p, P = params, peng.flatten(model.params())
    for rnd, key in enumerate((jax.random.key(3), jax.random.key(4)), start=1):
        noise = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0),
                                   (rspec.total,), jnp.float32)
        s = peng.codec.scale_flat(P, len(users))
        r_new, r_ms = reng.train_round({k: jnp.asarray(v) for k, v in r_p.items()}, key, LR,
                                       users, tuple(jnp.asarray(a) for a in arrays))
        r_p = {k: np.asarray(v) for k, v in r_new.items()}
        r_resid = reng.wire_resid_host()
        P, ms = peng.train_round(P, LR, users, data, round_seed=rnd,
                                 epoch_perms=_perms(key, users, E, N),
                                 codec_noise=to_port(np.asarray(noise)))
        resid = peng.wire_resid_host()
        assert r_resid.shape == (1, 1, rspec.total) and resid.shape == (1, spec.total)
        case = f"int8 round {rnd} (ef={ef})"
        assert_grid_close(f"{case}: new params", P, to_port(rspec.flatten(r_p)),
                          torch.where(counts > 0, s / counts.clamp_min(1), 0.0),
                          atol=5e-5, max_share=0.02)
        assert_grid_close(f"{case}: residual", resid[0], to_port(r_resid[0, 0]), s,
                          atol=5e-5 * len(users), max_share=0.02)
        _eq(f"{case}: n", ms["n"], np.asarray(r_ms["n"]))
        assert bool(np.any(resid != 0)) == ef
