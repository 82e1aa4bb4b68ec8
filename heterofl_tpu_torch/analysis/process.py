"""Result aggregation and figures.

Port of ``heterofl_tpu/analysis/process.py``: load the
``output_dir/result/{tag}.pkl`` bundles the test entries write
(``entry/evaluate.py``), group them by everything but the seed, take the
mean and standard deviation across seeds, export a table (csv with numpy
alone; xlsx through pandas), and draw the learning curves and the
accuracy-against-size interpolation figure (matplotlib) from the profiler
bundles of :mod:`.summary`.  pandas and matplotlib are imported only when
an xlsx or a figure is asked for, and their absence raises a clear error;
``--xlsx 0 --figures 0`` leaves the csv alone.
"""

from __future__ import annotations

import glob
import os
import pickle
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np

from .. import config as C
from ..models import RESNET_BLOCKS
from ..models.norms import NORM_TYPES

METRIC_KEYS = ("Global-Accuracy", "Global-Perplexity", "Global-Loss",
               "Local-Accuracy", "Local-Perplexity", "Local-Loss",
               "Accuracy", "Perplexity", "Loss")

#: the model-name registry a tag's model field is anchored by
MODEL_NAMES = ("conv",) + tuple(RESNET_BLOCKS) + ("transformer",)
#: the reference's folder datasets: not ported, but their tags still parse
FOLDER_DATASETS = ("Omniglot", "ImageNet", "ImageFolder")
DATASET_NAMES = C.VISION_DATASETS + FOLDER_DATASETS + C.LM_DATASETS


def parse_tag(tag: str) -> Optional[Dict[str, str]]:
    """Invert ``config.make_model_tag``: ``seed_data[_subset]_model_<9
    control fields>``, anchored from the right at the control-field count
    with each field checked against its domain, the model anchored by the
    registry and the data name by the dataset names (longest match wins);
    None for a tag that fails (ref process.py:29-87)."""
    parts = tag.split("_")
    n_ctl = len(C.CONTROL_KEYS)
    if len(parts) < 3 + n_ctl:
        return None
    ctl = dict(zip(C.CONTROL_KEYS, parts[-n_ctl:]))
    try:
        int(ctl["num_users"])
        float(ctl["frac"])
    except ValueError:
        return None
    if (ctl["fed"] not in ("0", "1") or ctl["norm"] not in NORM_TYPES
            or ctl["model_split_mode"] not in ("fix", "dynamic")
            or ctl["scale"] not in ("0", "1") or ctl["mask"] not in ("0", "1")):
        return None
    head = parts[:-n_ctl]
    try:
        int(head[0])
    except ValueError:
        return None
    if head[-1] not in MODEL_NAMES:
        return None
    mid = head[1:-1]  # the data name's parts and an optional subset
    if not mid:
        return None
    if "_".join(mid) in DATASET_NAMES:
        data_name, subset = "_".join(mid), ""
    elif len(mid) >= 2 and "_".join(mid[:-1]) in DATASET_NAMES:
        data_name, subset = "_".join(mid[:-1]), mid[-1]
    else:
        data_name, subset = "_".join(mid), ""
    return {"seed": head[0], "data_name": data_name, "subset": subset,
            "model_name": head[-1], **ctl}


def load_results(output_dir: str) -> List[Dict[str, Any]]:
    """Every bundle of ``output_dir/result`` whose name parses as a tag:
    its last logged test metrics (``logger_history``) and its ``metrics``
    (the centralised bundles')."""
    rows = []
    for path in sorted(glob.glob(os.path.join(output_dir, "result", "*.pkl"))):
        tag = os.path.splitext(os.path.basename(path))[0]
        meta = parse_tag(tag)
        if meta is None:
            continue
        with open(path, "rb") as f:
            bundle = pickle.load(f)
        metrics: Dict[str, float] = {}
        hist = bundle.get("logger_history", {})
        for k in METRIC_KEYS:
            if f"test/{k}" in hist and hist[f"test/{k}"]:
                metrics[k] = float(hist[f"test/{k}"][-1])
        metrics.update({k: float(v) for k, v in bundle.get("metrics", {}).items()})
        rows.append({"tag": tag, **meta, "metrics": metrics,
                     "train_history": bundle.get("train_history", {})})
    return rows


def aggregate(rows: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Group by everything but the seed; mean and std across seeds (ref
    process.py:114-179)."""
    groups: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for r in rows:
        key = "_".join([r["data_name"], r["subset"], r["model_name"]]
                       + [r[k] for k in C.CONTROL_KEYS])
        groups[key].append(r)
    out = {}
    for key, rs in groups.items():
        metrics = defaultdict(list)
        for r in rs:
            for k, v in r["metrics"].items():
                metrics[k].append(v)
        out[key] = {"n_seeds": len(rs),
                    "mean": {k: float(np.mean(v)) for k, v in metrics.items()},
                    "std": {k: float(np.std(v)) for k, v in metrics.items()},
                    "rows": rs}
    return out


def export_table(agg: Dict[str, Dict[str, Any]], output_dir: str, name: str = "result",
                 xlsx: bool = False) -> str:
    """Write ``{name}.csv`` (numpy alone) and with ``xlsx`` also
    ``{name}.xlsx`` (pandas and openpyxl; their absence raises)."""
    all_metrics = sorted({m for g in agg.values() for m in g["mean"]})
    header = ["experiment", "n_seeds"] + [f"{m}_mean" for m in all_metrics] \
        + [f"{m}_std" for m in all_metrics]
    lines = [",".join(header)]
    for key in sorted(agg):
        g = agg[key]
        row = [key, str(g["n_seeds"])]
        row += [f"{g['mean'].get(m, float('nan')):.6g}" for m in all_metrics]
        row += [f"{g['std'].get(m, float('nan')):.6g}" for m in all_metrics]
        lines.append(",".join(row))
    os.makedirs(output_dir, exist_ok=True)
    csv_path = os.path.join(output_dir, f"{name}.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if xlsx:
        try:
            import pandas as pd
        except ImportError as e:
            raise RuntimeError(f"an xlsx table needs pandas and openpyxl ({e}); the csv is "
                               f"at {csv_path} (pass --xlsx 0)") from e
        pd.read_csv(csv_path).to_excel(os.path.join(output_dir, f"{name}.xlsx"), index=False)
    return csv_path


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(f"figures need matplotlib ({e}); pass --figures 0 for the table "
                           f"alone") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def make_learning_curves(rows: List[Dict[str, Any]], output_dir: str,
                         metric: str = "Global-Accuracy", fmt: str = "png") -> List[str]:
    """One learning curve an experiment, ``fig/lc_{tag}.{fmt}`` (ref
    process.py:300-342)."""
    plt = _plt()
    paths = []
    fig_dir = os.path.join(output_dir, "fig")
    os.makedirs(fig_dir, exist_ok=True)
    for r in rows:
        series = r.get("train_history", {}).get(f"test/{metric}")
        if not series:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(range(1, len(series) + 1), series)
        ax.set_xlabel("communication round")
        ax.set_ylabel(metric)
        ax.set_title(r["tag"], fontsize=8)
        ax.grid(True, alpha=0.3)
        p = os.path.join(fig_dir, f"lc_{r['tag']}.{fmt}")
        fig.savefig(p, dpi=120, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)
    return paths


def mode_ratio(output_dir: str, data_name: str, model_name: str, model_mode: str) -> float:
    """A model mode's expected size against level a (``a1-b9``: the
    proportions' weighted mean of each level's params over level a's), from
    the profiler bundles ``{data}_{model}_{level}.pkl`` when every level
    needed has one, else each width rate squared -- never a mix."""
    parts = [(p[0], int(p[1:])) for p in model_mode.split("-")]

    def load_params(level):
        path = os.path.join(output_dir, "result", f"{data_name}_{model_name}_{level}.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)["num_params"]

    needed = sorted({lvl for lvl, _ in parts} | {"a"})
    profiled = {lvl: load_params(lvl) for lvl in needed}
    if all(v is not None for v in profiled.values()):
        sizes = [profiled[lvl] / profiled["a"] for lvl, _ in parts]
    else:
        sizes = [C.MODEL_SPLIT_RATE[lvl] ** 2 for lvl, _ in parts]
    w = np.array([prop for _, prop in parts], np.float64)
    return float(np.dot(w / w.sum(), np.array(sizes)))


def make_interpolation_plot(agg: Dict[str, Dict[str, Any]], output_dir: str,
                            metric: str = "Global-Accuracy", fmt: str = "png"
                            ) -> Optional[str]:
    """``metric`` against the model-size ratio across model modes,
    ``fig/interp_{metric}.{fmt}`` (ref process.py:233-299)."""
    if not agg:
        return None
    plt = _plt()
    xs, ys, labels = [], [], []
    for key in sorted(agg):
        g = agg[key]
        r0 = g["rows"][0]
        if metric not in g["mean"]:
            continue
        xs.append(mode_ratio(output_dir, r0["data_name"], r0["model_name"], r0["model_mode"]))
        ys.append(g["mean"][metric])
        labels.append(r0["model_mode"])
    if not xs:
        return None
    fig, ax = plt.subplots(figsize=(6, 4))
    order = np.argsort(xs)
    ax.plot(np.array(xs)[order], np.array(ys)[order], "o-")
    for x, y, lab in zip(xs, ys, labels):
        ax.annotate(lab, (x, y), fontsize=6)
    ax.set_xscale("log")
    ax.set_xlabel("model size ratio")
    ax.set_ylabel(metric)
    ax.grid(True, alpha=0.3)
    os.makedirs(os.path.join(output_dir, "fig"), exist_ok=True)
    p = os.path.join(output_dir, "fig", f"interp_{metric}.{fmt}")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return p


def main(argv=None):
    """``python -m heterofl_tpu_torch.analysis.process --output_dir d``."""
    import argparse

    parser = argparse.ArgumentParser(description="result aggregation (process.py)")
    parser.add_argument("--output_dir", default="./output", type=str)
    parser.add_argument("--metric", default="Global-Accuracy", type=str)
    parser.add_argument("--xlsx", default=1, type=int, help="also write an xlsx (pandas)")
    parser.add_argument("--figures", default=1, type=int,
                        help="draw the learning curves and the interpolation figure "
                             "(matplotlib)")
    parser.add_argument("--save_format", default="png", type=str,
                        help="the figures' file format (the reference's config key)")
    args = parser.parse_args(argv)
    rows = load_results(args.output_dir)
    agg = aggregate(rows)
    csv_path = export_table(agg, args.output_dir, xlsx=bool(args.xlsx))
    lc, interp = [], None
    if args.figures:
        lc = make_learning_curves(rows, args.output_dir, args.metric, args.save_format)
        interp = make_interpolation_plot(agg, args.output_dir, args.metric, args.save_format)
    print(f"{len(rows)} results -> {csv_path}; {len(lc)} learning curves; interp={interp}")
    return agg


if __name__ == "__main__":
    main()
