"""Datasets: the deterministic synthetic generators, the on-disk readers of
the vision and language-model datasets, and per-dataset normalisation
statistics.

Port of ``heterofl_tpu/data/datasets.py`` (the IDX and CIFAR readers,
:78-235, the synthetic branch, :405-501, and the LM reader, :342-400) and
``heterofl_tpu/data/vocab.py``.  The numpy RNG calls are the reference's,
in the same order, so the synthetic arrays are identical for the same seed;
the readers parse the same files into the same arrays.  The readers are
numpy only (the reference's optional C++ parser reads the same records).
The folder datasets (Omniglot, ImageNet, ImageFolder) are not ported.

Without ``synthetic`` a dataset is read from ``{data_dir}/{data_name}``, and
when its files are absent ``fetch_dataset`` raises ``FileNotFoundError``
naming them: the reference falls back to the synthetic twin there, which
would swap the user's data for random images without a word.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..config import LM_DATASETS, MNIST_LIKE, VISION_DATASETS

DATASET_STATS = {
    "MNIST": ((0.1307,), (0.3081,)),
    "FashionMNIST": ((0.2860,), (0.3530,)),
    "CIFAR10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "CIFAR100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
}

_EMNIST_CLASSES = {"byclass": 62, "bymerge": 47, "balanced": 47, "letters": 26,
                   "digits": 10, "mnist": 10}


@dataclass
class ArrayDataset:
    """In-memory labelled image dataset (NHWC uint8)."""

    data: np.ndarray
    target: np.ndarray
    classes_size: int
    data_name: str
    augment: bool = False  # train split of CIFAR: random crop + flip on device

    def __len__(self) -> int:
        return len(self.data)


class Vocab:
    """Symbol <-> index vocabulary (``<ukn>`` = 0, ``<eos>`` = 1, then
    insertion order; an unknown symbol maps to ``<ukn>``)."""

    def __init__(self):
        self.symbol_to_index = {"<ukn>": 0, "<eos>": 1}
        self.index_to_symbol = ["<ukn>", "<eos>"]

    def add(self, symbol: str) -> None:
        if symbol not in self.symbol_to_index:
            self.index_to_symbol.append(symbol)
            self.symbol_to_index[symbol] = len(self.index_to_symbol) - 1

    def __len__(self) -> int:
        return len(self.index_to_symbol)

    def __getitem__(self, query):
        if isinstance(query, int):
            if 0 <= query < len(self.index_to_symbol):
                return self.index_to_symbol[query]
            return "<ukn>"
        if isinstance(query, str):
            return self.symbol_to_index.get(query, self.symbol_to_index["<ukn>"])
        raise ValueError("Not valid data type")


@dataclass
class TokenDataset:
    """Token-stream LM dataset; ``token`` is 1-D before ``batchify`` and
    ``[batch_size, T]`` rows after."""

    token: np.ndarray
    vocab: Vocab
    data_name: str

    def __len__(self) -> int:
        return len(self.token)


def _emnist_subset(subset) -> str:
    if subset in ("label", None, ""):
        return "balanced"
    if subset not in _EMNIST_CLASSES:
        raise ValueError(f"Not valid EMNIST subset: {subset!r} (one of {sorted(_EMNIST_CLASSES)})")
    return subset


# -- on-disk vision readers ------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    """An IDX (ubyte) file, raw or gzip: a big-endian magic whose low byte is
    the rank, the dimensions, then the uint8 payload."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


_MNIST_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _find(root: str, name: str) -> Optional[str]:
    """``name`` or ``name.gz``, in ``root`` or ``root/raw``."""
    for cand in (name, name + ".gz"):
        for sub in ("", "raw"):
            p = os.path.join(root, sub, cand)
            if os.path.exists(p):
                return p
    return None


def _load_mnist_like(root: str, split: str, data_name: str) -> Optional[ArrayDataset]:
    img_p, lbl_p = (_find(root, n) for n in _MNIST_FILES[split])
    if img_p is None or lbl_p is None:
        return None
    return ArrayDataset(_read_idx(img_p)[..., None], _read_idx(lbl_p).astype(np.int64), 10,
                        data_name)


def _load_emnist(root: str, split: str, subset: str) -> Optional[ArrayDataset]:
    """One EMNIST subset's IDX files.  EMNIST ships its images transposed
    (column-major), so they are transposed back; ``letters`` labels start
    at 1 and are shifted to 0."""
    subset = _emnist_subset(subset)
    img_p = _find(root, f"emnist-{subset}-{split}-images-idx3-ubyte")
    lbl_p = _find(root, f"emnist-{subset}-{split}-labels-idx1-ubyte")
    if img_p is None or lbl_p is None:
        return None
    imgs = _read_idx(img_p).transpose(0, 2, 1)[..., None]
    labels = _read_idx(lbl_p).astype(np.int64)
    if subset == "letters":
        labels = labels - 1
    return ArrayDataset(imgs, labels, _EMNIST_CLASSES[subset], "EMNIST")


def _cifar_layout(data_name: str, split: str) -> Dict[str, Any]:
    """File names of both CIFAR distributions for one split."""
    if data_name == "CIFAR10":
        return {"bin_dir": "cifar-10-batches-bin", "label_bytes": 1, "classes": 10,
                "bin": [f"data_batch_{i}.bin" for i in range(1, 6)] if split == "train"
                else ["test_batch.bin"],
                "archive": "cifar-10-python.tar.gz", "py_dir": "cifar-10-batches-py",
                "py": [f"data_batch_{i}" for i in range(1, 6)] if split == "train"
                else ["test_batch"], "label_key": b"labels"}
    return {"bin_dir": "cifar-100-binary", "label_bytes": 2, "classes": 100,
            "bin": ["train.bin"] if split == "train" else ["test.bin"],
            "archive": "cifar-100-python.tar.gz", "py_dir": "cifar-100-python",
            "py": ["train"] if split == "train" else ["test"], "label_key": b"fine_labels"}


def _load_cifar_bin(root: str, split: str, data_name: str) -> Optional[ArrayDataset]:
    """The binary distribution: records of the label byte(s) (CIFAR100: the
    coarse then the fine label) and 3,072 bytes of CHW pixels."""
    lay = _cifar_layout(data_name, split)
    base = next((p for sub in ("", "raw")
                 if os.path.isdir(p := os.path.join(root, sub, lay["bin_dir"]))), None)
    if base is None:
        return None
    lb = lay["label_bytes"]
    imgs, labels = [], []
    for fn in lay["bin"]:
        path = os.path.join(base, fn)
        if not os.path.exists(path):
            return None
        n = os.path.getsize(path) // (lb + 3072)
        rec = np.fromfile(path, np.uint8, n * (lb + 3072)).reshape(n, lb + 3072)
        labels.append(rec[:, lb - 1].astype(np.int64))
        imgs.append(np.ascontiguousarray(rec[:, lb:].reshape(n, 3, 32, 32).transpose(0, 2, 3, 1)))
    return ArrayDataset(np.concatenate(imgs), np.concatenate(labels), lay["classes"],
                        data_name, augment=(split == "train"))


def _load_cifar(root: str, split: str, data_name: str) -> Optional[ArrayDataset]:
    """CIFAR10/100: the binary distribution first, then the python-pickle
    batches in their directory under ``root``, then the ``.tar.gz`` archive
    (in ``root`` or ``root/raw``)."""
    ds = _load_cifar_bin(root, split, data_name)
    if ds is not None:
        return ds
    lay = _cifar_layout(data_name, split)

    def read_entry(raw: bytes):
        entry = pickle.loads(raw, encoding="bytes")
        data = entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # -> NHWC
        return data, np.array(entry[lay["label_key"]], dtype=np.int64)

    base = os.path.join(root, lay["py_dir"])
    if os.path.isdir(base):
        parts = []
        for fn in lay["py"]:
            with open(os.path.join(base, fn), "rb") as f:
                parts.append(read_entry(f.read()))
    else:
        tar_p = next((p for sub in ("", "raw")
                      if os.path.exists(p := os.path.join(root, sub, lay["archive"]))), None)
        if tar_p is None:
            return None
        with tarfile.open(tar_p, "r:gz") as tf:
            parts = [read_entry(tf.extractfile(tf.getmember(f"{lay['py_dir']}/{fn}")).read())
                     for fn in lay["py"]]
    return ArrayDataset(np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]), lay["classes"], data_name,
                        augment=(split == "train"))


def _vision_files(data_name: str, subset: str) -> str:
    """What the vision reader looks for, for the error message."""
    if data_name == "EMNIST":
        s = _emnist_subset(subset)
        return f"emnist-{s}-{{train,test}}-{{images-idx3,labels-idx1}}-ubyte[.gz]"
    if data_name in MNIST_LIKE:
        return "{train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz]"
    lay = _cifar_layout(data_name, "train")
    return f"{lay['bin_dir']}/, {lay['py_dir']}/ or {lay['archive']}"


def _load_vision(root: str, split: str, data_name: str, subset: str
                 ) -> Optional[ArrayDataset]:
    if data_name == "EMNIST":
        return _load_emnist(root, split, subset)
    if data_name in MNIST_LIKE:
        return _load_mnist_like(root, split, data_name)
    return _load_cifar(root, split, data_name)


def synthetic_vision(data_name: str, split: str, n: Optional[int] = None, seed: int = 0,
                     subset: str = "balanced") -> ArrayDataset:
    """Class-conditional random images: mean brightness and two per-class
    stripes depend on the label, so a model can learn from them."""
    shape = (28, 28, 1) if data_name in MNIST_LIKE else (32, 32, 3)
    if data_name == "EMNIST":
        classes = _EMNIST_CLASSES[_emnist_subset(subset)]
    else:
        classes = {"CIFAR100": 100}.get(data_name, 10)
    if n is None:
        n = 2000 if split == "train" else 500
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    labels = rng.integers(0, classes, size=n).astype(np.int64)
    imgs = rng.integers(0, 96, size=(n,) + shape).astype(np.int64)
    h, w = shape[0], shape[1]
    lab = labels[:, None, None, None]
    row = np.arange(h)[None, :, None, None]
    col = np.arange(w)[None, None, :, None]
    imgs = (imgs
            + 40 * (row == lab % h)
            + 40 * (col == (lab * 7 + 3) % w)
            + 8 * (lab % 8))
    return ArrayDataset(np.clip(imgs, 0, 255).astype(np.uint8), labels, classes, data_name,
                        augment=(split == "train" and data_name.startswith("CIFAR")))


def synthetic_lm(data_name: str, split: str, n_tokens: int = 200_000, vocab_size: int = 512,
                 seed: int = 0) -> TokenDataset:
    """Markov-ish token stream over a synthetic vocabulary: with
    probability 0.7 the next token is ``(7 t + 3) % vocab_size`` of the
    current one ``t``, else a uniform draw.

    The reference writes this as a loop over the tokens; here each run of
    the map since the last draw is read off a table of the map's powers, the
    same integers."""
    vocab = Vocab()
    for i in range(vocab_size - 2):
        vocab.add(f"w{i}")
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    jumps = rng.integers(0, vocab_size, size=n_tokens)
    noise = rng.random(n_tokens)
    # token[i] is the map applied (i - start) times to the value at the
    # run's start: a draw, or 2 at position 0
    start_val = np.where(noise >= 0.7, jumps, -1)
    start_val[0] = 2
    is_start = start_val >= 0
    idx = np.arange(n_tokens)
    start = np.maximum.accumulate(np.where(is_start, idx, 0))
    steps = idx - start
    powers = np.empty((int(steps.max()) + 1 if n_tokens else 1, vocab_size), np.int64)
    powers[0] = np.arange(vocab_size)
    for k in range(1, powers.shape[0]):
        powers[k] = (powers[k - 1] * 7 + 3) % vocab_size
    token = powers[steps, start_val[start]] if n_tokens else np.empty(0, np.int64)
    return TokenDataset(token.astype(np.int64), vocab, data_name)


_LM_FILES = {
    "PennTreebank": {"train": "ptb.train.txt", "valid": "ptb.valid.txt", "test": "ptb.test.txt",
                     "dir": ""},
    "WikiText2": {"train": "wiki.train.tokens", "valid": "wiki.valid.tokens",
                  "test": "wiki.test.tokens", "dir": "wikitext-2"},
    "WikiText103": {"train": "wiki.train.tokens", "valid": "wiki.valid.tokens",
                    "test": "wiki.test.tokens", "dir": "wikitext-103"},
}


def _lm_path(root: str, data_name: str, split: str) -> Optional[str]:
    spec = _LM_FILES[data_name]
    for sub in ("", "raw"):
        for mid in (spec["dir"], ""):
            p = os.path.join(root, sub, mid, spec[split])
            if os.path.exists(p):
                return p
    return None


def _read_tokens(vocab: Vocab, path: str, build: bool) -> Optional[np.ndarray]:
    """Whitespace tokenisation plus ``<eos>`` per line: with ``build`` the
    symbols go into ``vocab`` (None returned), else their ids."""
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            for symbol in line.split() + ["<eos>"]:
                if build:
                    vocab.add(symbol)
                else:
                    out.append(vocab[symbol])
    return None if build else np.array(out, dtype=np.int64)


def _load_lm(root: str, split: str, data_name: str, vocab: Optional[Vocab] = None
             ) -> Optional[TokenDataset]:
    """One split's token file under ``root`` (a downloaded zip is extracted
    first), or None when it is absent.  The vocabulary is built from the
    train stream only (valid/test symbols outside it map to ``<ukn>``);
    pass the train split's ``vocab`` to read another split without parsing
    the train file again."""
    for sub in ("", "raw"):
        for z in ("wikitext-2-v1.zip", "wikitext-103-v1.zip"):
            zp = os.path.join(root, sub, z)
            if os.path.exists(zp) and _lm_path(root, data_name, "train") is None:
                with zipfile.ZipFile(zp) as zf:
                    zf.extractall(os.path.join(root, sub))
    train_p = _lm_path(root, data_name, "train")
    split_p = _lm_path(root, data_name, split)
    if train_p is None or split_p is None:
        return None
    if vocab is None:
        vocab = Vocab()
        _read_tokens(vocab, train_p, build=True)
    return TokenDataset(_read_tokens(vocab, split_p, build=False), vocab, data_name)


def fetch_dataset(data_name: str, data_dir: str = "./data", synthetic: bool = False,
                  seed: int = 0, synthetic_sizes: Optional[Dict[str, int]] = None,
                  subset: str = "label") -> Dict[str, Any]:
    """``{'train': dataset, 'test': dataset}``: the synthetic generators,
    or the dataset's files under ``{data_dir}/{data_name}`` (raises
    ``FileNotFoundError`` when they are absent)."""
    sizes = synthetic_sizes or {}
    if data_name in LM_DATASETS:
        if synthetic:
            return {split: synthetic_lm(data_name, split, n_tokens=sizes.get(split) or 200_000,
                                        seed=seed) for split in ("train", "test")}
        root = os.path.join(data_dir, data_name)
        train = _load_lm(root, "train", data_name)
        test = None if train is None else _load_lm(root, "test", data_name, train.vocab)
        if test is None:
            raise FileNotFoundError(
                f"{data_name}: no token files {_LM_FILES[data_name]['train']!r} and "
                f"{_LM_FILES[data_name]['test']!r} under {root}; pass synthetic=1 for the "
                f"synthetic twin")
        return {"train": train, "test": test}
    if synthetic:
        return {split: synthetic_vision(data_name, split, n=sizes.get(split), seed=seed,
                                        subset=subset)
                for split in ("train", "test")}
    if data_name not in VISION_DATASETS:
        raise ValueError(f"Not valid dataset name: {data_name!r}")
    root = os.path.join(data_dir, data_name)
    out = {split: _load_vision(root, split, data_name, subset) for split in ("train", "test")}
    if any(ds is None for ds in out.values()):
        raise FileNotFoundError(
            f"{data_name}: no {_vision_files(data_name, subset)} under {root} (or its raw/); "
            f"pass synthetic=1 for the synthetic twin")
    return out
