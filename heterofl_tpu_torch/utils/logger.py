"""Experiment logger: size-weighted running means, per-round history, and
writers (JSONL always; TensorBoard if asked for and available).

Port of ``heterofl_tpu/utils/logger.py``: ``append(result, tag, n)``
updates running means keyed ``{tag}/{metric}``; ``safe(True)`` opens the
writers and ``safe(False)`` closes them and snapshots the means into
``history``; ``write`` prints one info line and appends one JSONL record.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from collections import defaultdict
from numbers import Number
from typing import Dict, Iterable, List


class Logger:
    def __init__(self, log_path: str, use_tensorboard: bool = False):
        self.log_path = log_path
        self.use_tensorboard = use_tensorboard
        self.writer = None
        self._jsonl = None
        self._tb_warned = False
        self.tracker: Dict[str, object] = {}
        self.counter: Dict[str, float] = defaultdict(float)
        self.mean: Dict[str, float] = defaultdict(float)
        self.history: Dict[str, List[float]] = defaultdict(list)
        self.iterator: Dict[str, int] = defaultdict(int)

    # -- lifecycle ----------------------------------------------------
    def safe(self, write: bool) -> None:
        if write:
            os.makedirs(self.log_path, exist_ok=True)
            self._jsonl = open(os.path.join(self.log_path, "log.jsonl"), "a")
            if self.use_tensorboard and self.writer is None:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self.writer = SummaryWriter(self.log_path)
                except Exception as e:
                    # one warning per Logger, then JSONL-only logging
                    if not self._tb_warned:
                        self._tb_warned = True
                        warnings.warn(f"use_tensorboard=True but the tensorboard writer is "
                                      f"unavailable ({e!r}); continuing with JSONL-only logging")
                    self.writer = None
        else:
            if self.writer is not None:
                self.writer.close()
                self.writer = None
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None
            for name in self.mean:
                self.history[name].append(self.mean[name])

    def reset(self) -> None:
        self.tracker = {}
        self.counter = defaultdict(float)
        self.mean = defaultdict(float)

    def reset_tag(self, tag: str) -> None:
        """Clear one tag's running means and counters (history untouched)."""
        prefix = f"{tag}/"
        for d in (self.counter, self.mean):
            for k in [k for k in d if k.startswith(prefix)]:
                del d[k]

    # -- persistence: the state rides inside the checkpoint blob, so a full
    # resume restores running means, counters and TensorBoard step counters
    def state_dict(self) -> Dict[str, object]:
        return {"counter": dict(self.counter), "mean": dict(self.mean),
                "history": {k: list(v) for k, v in self.history.items()},
                "iterator": dict(self.iterator)}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.counter = defaultdict(float, state.get("counter", {}))
        self.mean = defaultdict(float, state.get("mean", {}))
        self.history = defaultdict(list, {k: list(v)
                                          for k, v in state.get("history", {}).items()})
        self.iterator = defaultdict(int, state.get("iterator", {}))

    # -- accumulation -------------------------------------------------
    def append(self, result: Dict[str, object], tag: str, n: float = 1, mean: bool = True) -> None:
        for k, v in result.items():
            name = f"{tag}/{k}"
            self.tracker[name] = v
            if mean and isinstance(v, Number):
                self.counter[name] += n
                c = self.counter[name]
                self.mean[name] = ((c - n) * self.mean[name] + n * float(v)) / c

    # -- output -------------------------------------------------------
    def write(self, tag: str, metric_names: Iterable[str]) -> str:
        parts = []
        record = {"tag": tag, "t": time.time()}
        for k in metric_names:
            name = f"{tag}/{k}"
            if name in self.mean:
                parts.append(f"{k}: {self.mean[name]:.4f}")
                record[k] = self.mean[name]
                if self.writer is not None:
                    self.iterator[name] += 1
                    self.writer.add_scalar(name, self.mean[name], self.iterator[name])
        info = self.tracker.get(f"{tag}/info")
        line_items = list(info) if isinstance(info, list) else ([str(info)] if info else [])
        line_items[2:2] = parts
        line = "  ".join(line_items) if line_items else "  ".join(parts)
        print(line, flush=True)
        if self.writer is not None:
            name = f"{tag}/info"
            self.iterator[name] += 1
            self.writer.add_text(name, line, self.iterator[name])
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        return line

    def emit(self, event: Dict[str, object], tag: str = "obs") -> None:
        """One structured ``{"tag": tag, "t": ..., **event}`` line on the
        JSONL writer; no-op while the writer is closed."""
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "t": time.time(), **event}) + "\n")
            self._jsonl.flush()

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()
        if self._jsonl is not None:
            self._jsonl.flush()
