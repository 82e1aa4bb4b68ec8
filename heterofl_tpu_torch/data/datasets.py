"""Datasets: the deterministic synthetic generators, the on-disk token
files of the language-model datasets, and per-dataset normalisation
statistics.

Port of ``heterofl_tpu/data/datasets.py`` (the synthetic branch, :405-501,
and the LM reader, :342-400) and ``heterofl_tpu/data/vocab.py``.  The numpy
RNG calls are the reference's, in the same order, so the arrays are
identical for the same seed.  The on-disk vision readers are not ported
yet: a vision ``fetch_dataset`` needs ``synthetic=True``.  An LM dataset
without ``synthetic`` reads its token files and raises when they are absent
(the reference falls back to the synthetic twin there).
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..config import LM_DATASETS, MNIST_LIKE

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
    or an LM dataset's token files under ``{data_dir}/{data_name}``."""
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
    if not synthetic:
        raise NotImplementedError(
            "on-disk vision datasets (synthetic=False, data_dir) are not ported to "
            "heterofl_tpu_torch yet; pass synthetic=1")
    return {split: synthetic_vision(data_name, split, n=sizes.get(split), seed=seed,
                                    subset=subset)
            for split in ("train", "test")}
