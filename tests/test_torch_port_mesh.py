"""The clients mesh axis of the PyTorch/CUDA port on one process: the
``mesh`` / ``world_size`` / ``data_placement`` config and its refusals
against the JAX package's, the slot layout against the reference's
``clients``-axis packing, the wrappers' counts, the residual a rank in a
checkpoint blob, the sharded checkpoints (the reference's
``tests/test_pod.py`` cases, and each package reading the other's files),
one collective a sharded evaluation pass and the audit's collective
budget.  The two-rank runs are ``tests/test_torch_port_pod.py``."""

import math
import os

import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.parallel.round_engine import _bucket_pow2, _ceil_div
from heterofl_tpu.utils import checkpoint as RCK
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.parallel import mesh as M
from heterofl_tpu_torch.parallel.round_engine import rank_slots, shard_client_data
from heterofl_tpu_torch.testing import thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint as PCK

few_threads = thread_limit_fixture()


def _cfg(mod, **over):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name("1_8_0.5_iid_fix_a1-b1_bn_1_1")
    cfg.update({"data_name": "MNIST", "model_name": "conv", **over})
    return cfg


# --- config -------------------------------------------------------------------------

def test_mesh_keys_take_the_reference_defaults():
    """``mesh`` has the reference's default and a CLI flag; ``world_size``
    and ``data_placement`` are out of ``UNPORTED``, and so is
    ``level_placement`` (the grouped engine on the mesh): ``slices`` with
    ``grouped`` is accepted."""
    from heterofl_tpu_torch.entry.common import build_cli, cfg_from_args

    assert PC.DEFAULT_CFG["mesh"] == RC.DEFAULT_CFG["mesh"] == {"clients": 0, "data": 1}
    for key in ("world_size", "data_placement"):
        assert key not in PC.UNPORTED and PC.DEFAULT_CFG[key] == RC.DEFAULT_CFG[key]
    done = PC.process_control(_cfg(PC, world_size=4, data_placement="sharded"))
    assert (done["world_size"], done["data_placement"]) == (4, "sharded")
    assert "level_placement" not in PC.UNPORTED
    assert PC.process_control(_cfg(PC, strategy="grouped", level_placement="slices"))[
        "level_placement"] == "slices"
    args = build_cli("t").parse_args(["--mesh", '{"clients": 2}', "--data_placement", "sharded",
                                      "--world_size", "2"])
    cfg = cfg_from_args(args)
    assert (cfg["mesh"], cfg["data_placement"], cfg["world_size"]) == \
        ({"clients": 2}, "sharded", 2)


PLACEMENTS = [{"data_placement": "bogus"}, {"level_placement": "bogus"},
              {"strategy": "grouped", "data_placement": "sharded"},
              {"strategy": "sliced", "data_placement": "sharded"},
              {"strategy": "grouped"}, {"data_placement": "sharded"}, {}]


@pytest.mark.parametrize("case", range(len(PLACEMENTS)))
def test_resolve_placement_matches_reference(case):
    """``resolve_placement_cfg`` accepts and refuses what the reference's
    does, with its messages."""
    over = PLACEMENTS[case]

    def run(mod):
        try:
            return "ok", mod.resolve_placement_cfg(_cfg(mod, **over))
        except ValueError as e:
            return "error", str(e)

    assert run(PC) == run(RC)


#: (cfg, ROADMAP item refused at a world of two; None: accepted there, a
#: refusal lifted)
REFUSED = [({"strategy": "grouped", "arms": 2, "superstep_rounds": 2}, "the arms axis"),
           ({"strategy": "grouped", "client_store": "stream"}, "the stream store"),
           ({"strategy": "grouped", "data_name": "WikiText2", "model_name": "transformer"},
            None),
           ({"client_store": "stream"}, "the stream store"),
           ({"arms": 2}, "the arms axis"),
           ({"telemetry": "on"}, "observability"),
           ({"quarantine": "on"}, "observability"),
           ({"chaos_poison": [[1, 2]]}, "observability"),
           ({"telemetry": "on", "watchdog": {"action": "warn"}}, "observability")]


@pytest.mark.parametrize("case", range(len(REFUSED)))
def test_world_of_ranks_refuses_what_the_axis_does_not_carry(case, monkeypatch):
    """Under a world of two ranks (torchrun's ``WORLD_SIZE``) each option the
    clients axis does not carry is refused at config time, naming its
    ROADMAP item; on one rank it is accepted.  The grouped LM (item None)
    is carried now: accepted at a world of two, on the clients axis and on
    the data axis."""
    over, item = REFUSED[case]
    PC.process_control(_cfg(PC, **over))
    monkeypatch.setenv("WORLD_SIZE", "2")
    if item is None:
        for mesh in ({"clients": 2, "data": 1}, {"clients": 1, "data": 2}):
            assert PC.process_control(_cfg(PC, mesh=mesh, **over))["mesh"] == mesh
        assert not any("transformer" in what for _, what, _ in PC.MESH_REFUSALS)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item 5, {item}"):
        PC.process_control(_cfg(PC, **over))


@pytest.mark.parametrize("entry", ["train_classifier", "test_classifier_fed"])
def test_world_of_ranks_refuses_the_one_rank_entries(entry, monkeypatch):
    """The centralised baseline and the test entries run on one rank: under
    torchrun's ``WORLD_SIZE`` 2 they refuse, naming the ROADMAP item."""
    import importlib

    main = importlib.import_module(f"heterofl_tpu_torch.entry.{entry}").main
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        main(["--device", "cpu", "--data_name", "MNIST", "--model_name", "conv",
              "--synthetic", "1"])


def test_world_of_ranks_accepts_what_the_axis_carries(monkeypatch):
    """The masked engine, K=1 and the superstep, every codec, the
    scheduler, both samplers and sharded placement run at two ranks; so do
    the grouped engine under either level placement, K=1 and the
    superstep with a per-level map, and the sliced twin."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for over in ({}, {"superstep_rounds": 2, "wire_codec": "int8"}, {"wire_codec": "signsgd"},
                 {"strategy": "grouped"}, {"strategy": "sliced"},
                 {"strategy": "grouped", "level_placement": "slices", "strict_placement": True},
                 {"strategy": "grouped", "superstep_rounds": 2,
                  "wire_codec": {"1": "int8", "0.5": "dense"}},
                 {"wire_codec": "topk"}, {"sampler": "prp", "data_placement": "sharded"},
                 {"schedule": {"kind": "uniform", "aggregation": "buffered"}},
                 {"client_failure_rate": 0.2}, {"mesh": {"clients": 2, "data": 1}}):
        PC.process_control(_cfg(PC, **over))
    with pytest.raises(ValueError, match="Not valid mesh keys"):
        PC.resolve_mesh_cfg({"mesh": {"model": 2}})
    with pytest.raises(ValueError, match="Not valid mesh clients"):
        PC.resolve_mesh_cfg({"mesh": {"clients": -1}})


def test_make_mesh_is_one_rank_without_a_group():
    """Without torchrun's variables nothing is joined; the mesh is rank 0 of
    1 on the device asked for; a clients count other than the world size
    raises (the deliberate difference), so does a data axis the world of
    one rank cannot hold, and an arms axis names its ROADMAP item."""
    assert not M.initialize_distributed(device="cpu")
    mesh = M.make_mesh(0, device=torch.device("cpu"))
    assert (mesh.rank, mesh.size, mesh.distributed, mesh.device) == \
        (0, 1, False, torch.device("cpu"))
    assert M.make_mesh(1).size == 1
    with pytest.raises(ValueError, match="each rank is one process"):
        M.make_mesh(2)
    with pytest.raises(ValueError, match="data=2 does not divide the world"):
        M.make_mesh(0, 2)
    with pytest.raises(NotImplementedError, match="arms axis"):
        M.make_mesh(0, 1, 2)


def test_wrappers_count_every_call_and_pass_values_through():
    """On one process each wrapper counts its call and its bytes and
    returns its input unchanged (the same tensors)."""
    mesh = M.single_mesh(torch.device("cpu"))
    M.reset_counts()
    a, b = torch.ones(5), torch.arange(3, dtype=torch.int32)
    out = mesh.all_reduce_sum([a, b])
    assert out[0] is a and out[1] is b
    rows = torch.zeros(4, 3)
    assert mesh.gather_rows(rows) is rows
    assert mesh.broadcast_int(7) == 7
    mesh.barrier()
    assert M.COLLECTIVES == {"all_reduce": 1, "gather": 1, "broadcast": 1, "barrier": 1}
    assert M.COLLECTIVE_BYTES["all_reduce"] == 5 * 4 + 3 * 4


def test_wrappers_through_a_one_rank_gloo_group(monkeypatch):
    """Joined through torchrun's variables (a one-rank gloo group in this
    process), each wrapper runs its collective: a mixed-dtype payload (the
    signsgd lanes and scales) reduces in float64 and comes back in its
    dtypes with the int32 words' bits (their top bit set too), a one-dtype
    pair in its own; the rows, the int and the barrier pass; the group is
    left after."""
    from heterofl_tpu_torch.parallel.pod import _free_port

    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    assert M.initialize_distributed(device="cpu")
    try:
        mesh = M.make_mesh(0, device=torch.device("cpu"))
        assert mesh.distributed and mesh.backend == "gloo" and mesh.size == 1
        words = torch.tensor([-5, 2 ** 31 - 1, -2 ** 31, 7], dtype=torch.int32)
        scales = torch.tensor([0.1, 3.0e-7], dtype=torch.float32)
        out = mesh.all_reduce_sum([words, scales])
        assert out[0].dtype == torch.int32 and torch.equal(out[0], words)
        assert out[1].dtype == torch.float32 and torch.equal(out[1], scales)
        pair = mesh.all_reduce_sum([scales, 2 * scales])
        assert torch.equal(pair[1], 2 * scales) and pair[0].data_ptr() != scales.data_ptr()
        rows = torch.arange(6.0).view(2, 3)
        assert torch.equal(mesh.gather_rows(rows), rows)
        assert mesh.broadcast_int(11) == 11
        mesh.barrier()
    finally:
        M.shutdown_distributed()
    assert not M.joined()


# --- the slot layout -------------------------------------------------------------------

def _reference_replicated(a: int, n: int):
    """The reference's K=1 replicated packing (round_engine.py:1827-1831):
    the cohort padded with -1 to a multiple of the clients axis, device d
    the d-th block; the slots a device, ``_ceil_div(a, n)``."""
    pad = (-a) % n
    glob = np.concatenate([np.arange(a), -np.ones(pad, np.int64)]).reshape(n, -1)
    return [row[row >= 0] for row in glob], _ceil_div(a, n)


@pytest.mark.parametrize("a", [3, 4, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_slot_layout_matches_reference_packing(a, n):
    """Each rank's schedule positions and the slots a rank are the
    reference's device blocks (replicated, K=1 and the superstep's
    ``ceil(A / n)``), and under ``sharded`` placement the positions of the
    users each device owns with the reference's slot count and its
    superstep bucket."""
    users = np.random.default_rng(a * 10 + n).permutation(16)[:a]
    (pos,), per = rank_slots(users[None], n)
    ref_pos, ref_per = _reference_replicated(a, n)
    assert per == ref_per
    for mine, ref in zip(pos, ref_pos):
        np.testing.assert_array_equal(mine, ref)
    # sharded: user u on device u // (U_pad / n) (round_engine.py:1814-1822)
    u_pad = 16 + (-16) % n
    per_user = u_pad // n
    sched = np.stack([users, np.where(np.arange(a) == 0, -1, users)])
    spos, sper = rank_slots(sched, n, "sharded", per_user)
    for r in range(2):
        owners = sched[r] // per_user
        for d in range(n):
            np.testing.assert_array_equal(spos[r][d], np.flatnonzero((owners == d)
                                                                    & (sched[r] >= 0)))
    assert sper == max(1, max(len(p) for row in spos for p in row))
    _, bper = rank_slots(sched, n, "sharded", per_user, bucket=True)
    assert bper == _bucket_pow2(sper)


def test_shard_client_data_matches_reference_padding():
    """Rank r's block is rows ``[r * U_pad / n, (r + 1) * U_pad / n)`` of
    the stacks padded with empty users, as ``shard_client_data`` pads and
    shards them over the clients axis."""
    x = torch.arange(5 * 3).reshape(5, 3)
    blocks = [shard_client_data((x,), 2, r)[0] for r in range(2)]
    assert [tuple(b.shape) for b in blocks] == [(3, 3), (3, 3)]
    np.testing.assert_array_equal(torch.cat(blocks)[:5].numpy(), x.numpy())
    assert not blocks[1][2].any()


# --- the residual a rank, and the sharded checkpoints -----------------------------------

def _tiny_experiment(tmp_path, codec="int8"):
    from heterofl_tpu_torch.entry.common import FedExperiment

    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_4_0.5_iid_fix_a1-b1_bn_1_1")
    cfg.update(data_name="MNIST", model_name="conv", device="cpu", synthetic=True,
               synthetic_sizes={"train": 80, "test": 40}, wire_codec=codec,
               output_dir=str(tmp_path), override={"conv": {"hidden_size": [4, 8]}})
    return FedExperiment(PC.process_control(cfg), 0)


def test_residual_blob_of_a_row_a_rank(tmp_path):
    """The checkpoint's residual: ``[1, slots, total]`` on one rank, as
    before; ``[n, slots, total]`` accepted when n is the world size, each
    rank restoring its own row (also from the merged shard blocks of the
    ranks' markers); any other n refused with the message it had."""
    exp = _tiny_experiment(tmp_path)
    total = exp.engine.spec.total
    rows = np.random.default_rng(0).normal(size=(2, 1, total)).astype(np.float32)
    with pytest.raises(ValueError, match=r"restores a \[1, slots, total\] carry"):
        exp._resid_from_blob(rows)
    np.testing.assert_array_equal(
        exp._resid_to_blob(exp._resid_from_blob(rows[:1]))[0], rows[0])
    want = exp._resid_from_blob(rows[1:])  # row 1 in the port's flat layout
    exp.mesh = M.Mesh(rank=1, size=2, device=torch.device("cpu"))
    np.testing.assert_array_equal(exp._resid_from_blob(rows), want)
    markers = [PCK.rank_block_marker(rows[r], r, 2) for r in range(2)]
    merged = dict(markers[0], blocks={**markers[0]["blocks"], **markers[1]["blocks"]})
    np.testing.assert_array_equal(exp._resid_from_blob(merged), want)
    with pytest.raises(ValueError, match=r"a \[2, slots, total\] one, a row a rank"):
        exp._resid_from_blob(np.concatenate([rows, rows[:1]]))


def _fake_sharded_ckpt(mod, path, stamp="e3"):
    """The on-disk layout of a two-rank sharded checkpoint, hand-made (the
    reference's ``tests/test_pod.py`` helper)."""
    full = np.arange(8, dtype=np.float32)
    blocks = [{"/resid": {((0, 4),): full[:4]}}, {"/resid": {((4, 8),): full[4:]}}]
    for i in (0, 1):
        mod.save_checkpoint(mod.shard_path(path, i, 2),
                            {"stamp": stamp, "process": i, "blocks": blocks[i]})
    header = {"epoch": 3,
              "resid": {mod.BLOCKS_KEY: True, "shape": (8,), "dtype": "float32",
                        "key": "/resid"},
              mod.SHARD_SET_KEY: {"count": 2, "stamp": stamp,
                                  "files": [os.path.basename(mod.shard_path(path, i, 2))
                                            for i in (0, 1)]}}
    mod.save_checkpoint(path, header)
    return full


@pytest.mark.parametrize("case", ["merge", "stamp", "missing", "hole", "best", "plain",
                                  "one_rank_group"])
def test_sharded_checkpoint_cases(tmp_path, monkeypatch, case):
    """The reference's sharded-checkpoint cases (``tests/test_pod.py:
    84-149``) on the port's reader and writer: the blocks merge; a shard of
    another generation, a missing shard and a coverage hole raise
    ``CheckpointCorruptError``; ``copy_best`` mirrors the shard files; a
    one-rank write is the plain blob, also from the entry in a one-rank
    group (``torchrun --nproc_per_node=1``: the int8 residual a plain
    ``[1, slots, total]`` array, no shard file)."""
    ck = str(tmp_path / "model" / "c.pkl")
    if case == "one_rank_group":
        from heterofl_tpu_torch.entry import train_classifier_fed
        from heterofl_tpu_torch.parallel.pod import _free_port

        for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}.items():
            monkeypatch.setenv(k, v)
        out = str(tmp_path / "entry")
        try:
            train_classifier_fed.main([
                "--device", "cpu", "--control_name", "1_4_0.5_iid_fix_a1-b1_bn_1_1",
                "--data_name", "MNIST", "--model_name", "conv", "--synthetic", "1",
                "--synthetic_sizes", '{"train": 40, "test": 20}', "--wire_codec", "int8",
                "--output_dir", out, "--override",
                '{"num_epochs": {"global": 1, "local": 1}, "conv": {"hidden_size": [4, 8]}}'])
            assert M.joined()
        finally:
            M.shutdown_distributed()
        files = os.listdir(os.path.join(out, "model"))
        assert files and not [f for f in files if ".shard" in f], files
        (live,) = [f for f in files if f.endswith("_checkpoint.pkl")]
        blob = PCK.load_checkpoint(os.path.join(out, "model", live))
        assert PCK.SHARD_SET_KEY not in blob
        assert isinstance(blob["wire_resid"], np.ndarray) and blob["wire_resid"].shape[0] == 1
        return
    if case == "plain":
        blob = {"epoch": 7, "params": {"w": np.ones((2, 3), np.float32)}}
        assert not PCK.save_checkpoint_sharded(ck, blob)
        assert not os.path.exists(PCK.shard_path(ck, 0, 1))
        loaded = PCK.load_checkpoint_sharded(ck)
        assert loaded["epoch"] == 7
        np.testing.assert_array_equal(loaded["params"]["w"], blob["params"]["w"])
        assert PCK.load_checkpoint(ck)["epoch"] == 7
        return
    if case == "hole":
        marker = {PCK.BLOCKS_KEY: True, "shape": (8,), "dtype": "float32",
                  "blocks": {((0, 4),): np.zeros(4, np.float32)}}
        with pytest.raises(PCK.CheckpointCorruptError, match="coverage holes"):
            PCK.dense_from_blocks(marker)
        return
    if case == "best":
        ck = PCK.checkpoint_path(str(tmp_path), "probe", "checkpoint")
    full = _fake_sharded_ckpt(PCK, ck)
    if case == "merge":
        blob = PCK.load_checkpoint_sharded(ck)
        assert blob["epoch"] == 3 and PCK.is_shard_marker(blob["resid"])
        np.testing.assert_array_equal(PCK.dense_from_blocks(blob["resid"]), full)
    elif case == "stamp":
        PCK.save_checkpoint(PCK.shard_path(ck, 1, 2), {"stamp": "e99", "process": 1,
                                                       "blocks": {"/resid": {((4, 8),): full[4:]}}})
        with pytest.raises(PCK.CheckpointCorruptError, match="stamp"):
            PCK.load_checkpoint_sharded(ck)
    elif case == "missing":
        os.remove(PCK.shard_path(ck, 1, 2))
        with pytest.raises(PCK.CheckpointCorruptError, match="missing"):
            PCK.load_checkpoint_sharded(ck)
        with pytest.raises(PCK.CheckpointCorruptError, match="failed verification"):
            PCK.load_newest_verifying_sharded(ck)
    else:
        PCK.copy_best(str(tmp_path), "probe", sharded=True)
        best = PCK.checkpoint_path(str(tmp_path), "probe", "best")
        blob = PCK.load_checkpoint_sharded(best)
        np.testing.assert_array_equal(PCK.dense_from_blocks(blob["resid"]), full)
        assert os.path.exists(PCK.shard_path(best, 0, 2))
        assert os.path.exists(PCK.shard_path(best, 1, 2))


def test_each_package_reads_the_others_sharded_checkpoint(tmp_path):
    """The port's collective write, rank 1 then rank 0 of two (each rank's
    residual row a marker), reads back through the reference's
    ``load_checkpoint_sharded``, and the reference's hand-made two-process
    files through the port's: the same merged array."""
    ck = str(tmp_path / "model" / "c.pkl")
    rows = np.random.default_rng(1).normal(size=(2, 1, 6)).astype(np.float32)
    for r in (1, 0):
        mesh = M.Mesh(rank=r, size=2, device=torch.device("cpu"))
        PCK.save_checkpoint_sharded(ck, {"epoch": 4, "wire_resid": PCK.rank_block_marker(
            rows[r], r, 2)}, mesh=mesh)
    ref = RCK.load_checkpoint_sharded(ck)
    assert ref["epoch"] == 4
    np.testing.assert_array_equal(RCK.dense_from_blocks(ref["wire_resid"]), rows)
    ck2 = str(tmp_path / "model" / "d.pkl")
    full = _fake_sharded_ckpt(RCK, ck2)
    np.testing.assert_array_equal(
        PCK.dense_from_blocks(PCK.load_checkpoint_sharded(ck2)["resid"]), full)


def test_resume_agrees_on_one_rank():
    """``check_multihost_resume`` on one rank: its own epoch, no
    collective (the reference's single-process case)."""
    from heterofl_tpu_torch.entry.common import check_multihost_resume

    M.reset_counts()
    assert check_multihost_resume({"epoch": 9}) == 9
    assert check_multihost_resume(None, M.single_mesh(torch.device("cpu"))) == 0
    assert M.COLLECTIVES["broadcast"] == 0


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_placement_on_one_rank_is_the_replicated_run(tmp_path, k):
    """``data_placement='sharded'`` on one rank (the block is every user):
    the entry's K=1 rounds and its superstep give the replicated run's
    params and round records bit for bit."""
    from heterofl_tpu_torch.entry import train_classifier_fed

    def run(placement):
        argv = ["--device", "cpu", "--control_name", "1_8_0.5_iid_fix_a1-b1_bn_1_1",
                "--data_name", "MNIST", "--model_name", "conv", "--synthetic", "1",
                "--synthetic_sizes", '{"train": 80, "test": 40}', "--superstep_rounds", str(k),
                "--data_placement", placement, "--output_dir", str(tmp_path / placement),
                "--override", '{"num_epochs": {"global": 2, "local": 1}, '
                              '"conv": {"hidden_size": [4, 8]}}']
        (res,) = train_classifier_fed.main(argv)
        return res

    a, b = run("replicated"), run("sharded")
    for key, v in a["params"].items():
        assert torch.equal(v, b["params"][key]), key
    assert [r["loss"] for r in a["history"]] == [r["loss"] for r in b["history"]]


# --- one collective a pass, one all-reduce a round --------------------------------------

def test_evaluation_makes_one_collective_a_pass(tmp_path):
    """The host evaluation and the fused one: the sBN pass one all-reduce,
    Local one gather, Global one all-reduce."""
    exp = _tiny_experiment(tmp_path, "dense")
    exp.stage(*exp.make_splits())
    P = exp.engine.flatten(exp.model.params())
    M.reset_counts()
    exp.evaluate(P, 1)
    assert (M.COLLECTIVES["all_reduce"], M.COLLECTIVES["gather"]) == (2, 1)
    fused = exp._fused_eval()
    M.reset_counts()
    fused.run(P, 1)
    assert (M.COLLECTIVES["all_reduce"], M.COLLECTIVES["gather"]) == (2, 1)


@pytest.mark.parametrize("name", ["masked/k1", "masked/k2", "masked/k2-int8", "grouped/k1"])
def test_audit_counts_one_all_reduce_a_round(tmp_path, name):
    """The audit's collective budget (check g): exactly one all-reduce a
    training round and one gather a dispatch, K=1 and the superstep, each
    moving the wire table's bytes, and one all-reduce an sBN and a Global
    pass and one gather a Local pass of the host (and fused) evaluation;
    the grouped engine's alike.  A round that reduces twice is a finding."""
    from heterofl_tpu_torch.staticcheck import audit

    spec = next(p for p in audit.PROGRAMS if p.name == name)
    rep = audit.audit_program(spec, torch.device("cpu"), False, str(tmp_path))
    assert rep.ok, rep.findings
    want = 1
    assert rep.collectives["all_reduce_per_round"] == want
    assert rep.collectives["participants"] == 1
    if want:
        assert rep.collectives["payload_bytes_per_round"] == rep.wire["level_bytes"]
        assert rep.collectives["eval_host"] == {"all_reduce": 2, "gather": 1}
        assert ("eval_fused" in rep.collectives) == (spec.k > 1)

        def twice(_name, exp):
            real = exp.engine.mesh.all_reduce_sum

            def reduce_twice(ts):
                return real(real(ts))

            exp.engine.mesh.all_reduce_sum = reduce_twice

        bad = audit.audit_program(spec, torch.device("cpu"), False, str(tmp_path / "bad"),
                                  tamper=twice)
        assert any(f.rule == "collective-budget" for f in bad.findings)


def test_ring_bytes_of_the_flagship_payload():
    """The ring all-reduce's bytes a rank (``staticcheck/wire.py``) of the
    flagship's dense ``[2, 11,172,170]`` float32 payload: zero on one rank,
    ``2 (n - 1) / n`` of it on n."""
    from heterofl_tpu_torch.staticcheck.wire import ring_allreduce_bytes

    payload = 2 * 11_172_170 * 4
    assert ring_allreduce_bytes(payload, 1) == 0
    assert ring_allreduce_bytes(payload, 2) == payload
    assert ring_allreduce_bytes(payload, 4) == math.floor(1.5 * payload)
