"""The on-disk vision readers and the computed normalisation statistics of
the PyTorch/CUDA port against the JAX reference's, on small files written
here in every format the reference reads (numpy and a seed): IDX raw and
gzip, in the dataset root and in ``raw/`` (MNIST, FashionMNIST, EMNIST in
all six subsets), CIFAR10/100 as the binary distribution, the python-pickle
directory and the ``.tar.gz`` archive.  Images, labels, class counts and the
statistics must be equal, and each package reads the other's stats cache;
the centralised entry trains on EMNIST files with computed statistics."""

import gzip
import io
import json
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import stats as r_stats
from heterofl_tpu.entry.common import _maybe_compute_norm_stats as r_maybe_stats
from heterofl_tpu_torch.data import fetch_dataset, stats
from heterofl_tpu_torch.entry import test_classifier, train_classifier
from heterofl_tpu_torch.entry.common import _maybe_compute_norm_stats
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint as ckpt

few_threads = thread_limit_fixture()

EMNIST_CLASSES = {"byclass": 62, "bymerge": 47, "balanced": 47, "letters": 26, "digits": 10,
                  "mnist": 10}
SIZES = {"train": 23, "test": 7}


def write_idx(path: str, arr: np.ndarray) -> None:
    """An IDX ubyte file (gzip when ``path`` ends in ``.gz``)."""
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
        f.write(head + np.ascontiguousarray(arr, np.uint8).tobytes())


def write_mnist_like(root, rng, names, classes, shape=(28, 28), label_offset=0):
    """Image and label IDX files of each split; ``names(split)`` -> (image
    file, label file) paths under ``root``."""
    for split, n in SIZES.items():
        img_p, lbl_p = names(split)
        write_idx(os.path.join(root, img_p), rng.integers(0, 256, (n,) + shape, np.uint8))
        write_idx(os.path.join(root, lbl_p),
                  rng.integers(label_offset, classes + label_offset, n, np.uint8))


def cifar_arrays(rng, n, classes):
    return rng.integers(0, 256, (n, 3072), np.uint8), rng.integers(0, classes, n)


def write_cifar(root, rng, data_name, fmt):
    """CIFAR10/100 under ``root`` in one distribution: ``bin``, ``py`` (the
    pickle directory) or ``tgz`` (its archive, in ``raw/``)."""
    ten = data_name == "CIFAR10"
    classes = 10 if ten else 100
    files = {"train": [f"data_batch_{i}" for i in range(1, 6)] if ten else ["train"],
             "test": ["test_batch"] if ten else ["test"]}
    if fmt == "bin":
        base = os.path.join(root, "cifar-10-batches-bin" if ten else "cifar-100-binary")
        os.makedirs(base)
        for split, names in files.items():
            for fn in names:
                data, fine = cifar_arrays(rng, SIZES[split], classes)
                labels = fine[:, None] if ten else np.stack([fine // 5, fine], 1)
                rec = np.concatenate([labels.astype(np.uint8), data], 1)
                rec.tofile(os.path.join(base, fn + ".bin"))
        return
    sub = "cifar-10-batches-py" if ten else "cifar-100-python"
    entries = {}
    for split, names in files.items():
        for fn in names:
            data, fine = cifar_arrays(rng, SIZES[split], classes)
            key = b"labels" if ten else b"fine_labels"
            entries[fn] = pickle.dumps({b"data": data, key: fine.tolist(),
                                        b"batch_label": fn.encode()})
    if fmt == "py":
        os.makedirs(os.path.join(root, sub))
        for fn, raw in entries.items():
            with open(os.path.join(root, sub, fn), "wb") as f:
                f.write(raw)
        return
    os.makedirs(os.path.join(root, "raw"))
    archive = "cifar-10-python.tar.gz" if ten else "cifar-100-python.tar.gz"
    with tarfile.open(os.path.join(root, "raw", archive), "w:gz") as tf:
        for fn, raw in entries.items():
            info = tarfile.TarInfo(f"{sub}/{fn}")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))


def assert_same_datasets(port, ref, what, batches=1):
    """Equal arrays, labels, class counts and flags; ``batches`` train
    files of ``SIZES['train']`` images each."""
    for split in ("train", "test"):
        p, r = port[split], ref[split]
        assert p.data.dtype == r.data.dtype == np.uint8, what
        np.testing.assert_array_equal(p.data, r.data, err_msg=f"{what} {split} images")
        np.testing.assert_array_equal(p.target, r.target, err_msg=f"{what} {split} labels")
        assert p.target.dtype == r.target.dtype
        assert (p.classes_size, p.augment, p.data_name) == (r.classes_size, r.augment,
                                                            r.data_name), what
        assert len(p) == SIZES[split] * (batches if split == "train" else 1)


@pytest.mark.parametrize("data_name", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("where", ["root", "raw", "root-gz", "raw-gz"])
def test_idx_readers_match_reference(tmp_path, data_name, where):
    root = tmp_path / data_name
    sub = "raw" if where.startswith("raw") else ""
    gz = ".gz" if where.endswith("gz") else ""
    files = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    write_mnist_like(str(root), np.random.default_rng(1),
                     lambda s: tuple(os.path.join(sub, f + gz) for f in files[s]), 10)
    port = fetch_dataset(data_name, data_dir=str(tmp_path), synthetic=False)
    ref = r_fetch(data_name, data_dir=str(tmp_path), synthetic=False)
    assert_same_datasets(port, ref, f"{data_name} ({where})")
    assert port["train"].data.shape == (SIZES["train"], 28, 28, 1)


@pytest.mark.parametrize("subset", sorted(EMNIST_CLASSES) + ["label"])
def test_emnist_subsets_match_reference(tmp_path, subset):
    """Every subset (``label``, the cfg default, reads ``balanced``): the
    images transposed back from EMNIST's column-major order, ``letters``
    labels shifted from 1-based; half the files gzip, half in ``raw/``."""
    name = "balanced" if subset == "label" else subset
    root = str(tmp_path / "EMNIST")
    rng = np.random.default_rng(2)
    write_mnist_like(root, rng, lambda s: (
        f"emnist-{name}-{s}-images-idx3-ubyte.gz",
        os.path.join("raw", f"emnist-{name}-{s}-labels-idx1-ubyte")),
        EMNIST_CLASSES[name], shape=(28, 28), label_offset=int(name == "letters"))
    port = fetch_dataset("EMNIST", data_dir=str(tmp_path), synthetic=False, subset=subset)
    ref = r_fetch("EMNIST", data_dir=str(tmp_path), synthetic=False, subset=subset)
    assert_same_datasets(port, ref, f"EMNIST {subset}")
    assert port["train"].classes_size == EMNIST_CLASSES[name]
    assert port["train"].target.min() >= 0


@pytest.mark.parametrize("data_name", ["CIFAR10", "CIFAR100"])
@pytest.mark.parametrize("fmt", ["bin", "py", "tgz"])
def test_cifar_readers_match_reference(tmp_path, data_name, fmt):
    write_cifar(str(tmp_path / data_name), np.random.default_rng(3), data_name, fmt)
    port = fetch_dataset(data_name, data_dir=str(tmp_path), synthetic=False)
    ref = r_fetch(data_name, data_dir=str(tmp_path), synthetic=False)
    batches = 5 if data_name == "CIFAR10" else 1
    assert_same_datasets(port, ref, f"{data_name} ({fmt})", batches)
    assert port["train"].data.shape == (SIZES["train"] * batches, 32, 32, 3)
    assert port["train"].augment and not port["test"].augment


def test_computed_stats_equal_reference_bit_for_bit(tmp_path):
    """``compute_stats`` (float64 merges of batches of 100) equals the
    reference's bit for bit on a ragged last batch, grey and RGB."""
    rng = np.random.default_rng(4)
    for shape in ((257, 28, 28, 1), (130, 32, 32, 3)):
        data = rng.integers(0, 256, shape, np.uint8)
        (pm, ps), (rm, rs) = stats.compute_stats(data), r_stats.compute_stats(data)
        assert pm.dtype == rm.dtype == np.float32
        assert_close(f"computed stats mean {shape}", pm, rm, rtol=0, atol=0)
        assert_close(f"computed stats std {shape}", ps, rs, rtol=0, atol=0)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stats_cache_is_read_by_the_other_package(tmp_path, writer):
    """The ``stats/{name}.npz`` one package writes the other reads back
    unchanged (and does not recompute: the data it is then given is
    different)."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (120, 28, 28, 1), np.uint8)
    first, second = (stats, r_stats) if writer == "port" else (r_stats, stats)
    m1, s1 = first.dataset_stats("EMNIST", data, str(tmp_path))
    assert os.path.exists(stats.stats_path("EMNIST", str(tmp_path)))
    m2, s2 = second.dataset_stats("EMNIST", data[:10] // 2, str(tmp_path))
    np.testing.assert_array_equal(m2, m1)
    np.testing.assert_array_equal(s2, s1)


def test_norm_stats_of_emnist_from_disk_match_reference(tmp_path):
    """EMNIST read from IDX files has no ``DATASET_STATS`` entry: both
    drivers' ``_maybe_compute_norm_stats`` put the same statistics into the
    cfg, from one cache; CIFAR10 keeps its table entry (no file)."""
    root = str(tmp_path / "EMNIST")
    write_mnist_like(root, np.random.default_rng(6), lambda s: (
        f"emnist-balanced-{s}-images-idx3-ubyte", f"emnist-balanced-{s}-labels-idx1-ubyte"), 47)
    ds = fetch_dataset("EMNIST", data_dir=str(tmp_path), synthetic=False)
    port_cfg = {"data_name": "EMNIST", "data_dir": str(tmp_path / "p")}
    ref_cfg = {"data_name": "EMNIST", "data_dir": str(tmp_path / "r")}
    _maybe_compute_norm_stats(port_cfg, ds)
    r_maybe_stats(ref_cfg, r_fetch("EMNIST", data_dir=str(tmp_path), synthetic=False))
    assert port_cfg["norm_stats"] == ref_cfg["norm_stats"]
    assert len(port_cfg["norm_stats"][0]) == 1
    cifar = {"data_name": "CIFAR10", "data_dir": str(tmp_path / "c")}
    _maybe_compute_norm_stats(cifar, {"train": ds["train"]})
    assert "norm_stats" not in cifar and not os.path.exists(tmp_path / "c")


def test_central_entry_on_emnist_files_under_gn(tmp_path):
    """The centralised baseline (``train_classifier --device cpu``, conv net
    at 8/16 under ``gn``) on EMNIST read from IDX files: it computes the
    statistics the reference computes, caches them, trains two finite
    epochs, and ``test_classifier`` reproduces the logged accuracy."""
    write_mnist_like(str(tmp_path / "EMNIST"), np.random.default_rng(8), lambda s: (
        f"emnist-balanced-{s}-images-idx3-ubyte.gz", f"emnist-balanced-{s}-labels-idx1-ubyte"),
        47)
    control = "1_1_1_none_fix_a1_gn_1_1"
    argv = ["--device", "cpu", "--output_dir", str(tmp_path / "out"), "--control_name", control,
            "--data_name", "EMNIST", "--model_name", "conv", "--data_dir", str(tmp_path),
            "--override", json.dumps({"conv": {"hidden_size": [8, 16]}, "num_epochs": 2,
                                      "batch_size": {"train": 10, "test": 7}})]
    (res,) = train_classifier.main(argv)
    assert [r["epoch"] for r in res["history"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in res["history"])
    want = {"data_name": "EMNIST", "data_dir": str(tmp_path / "r")}
    r_maybe_stats(want, r_fetch("EMNIST", data_dir=str(tmp_path), synthetic=False))
    tag = f"0_EMNIST_label_conv_{control}"
    blob = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path / "out"), tag))
    assert tuple(map(tuple, blob["cfg"]["norm_stats"])) == want["norm_stats"]
    assert os.path.exists(stats.stats_path("EMNIST", str(tmp_path)))
    (out,) = test_classifier.main(argv)
    best = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path / "out"), tag, "best"))
    assert_close("central test entry on EMNIST files vs logged: Accuracy",
                 out["metrics"]["Accuracy"], best["logger_history"]["test/Accuracy"][-1],
                 rtol=1e-4, atol=1e-4)
