"""Model profiler: parameters, FLOPs and memory of each width level.

Port of ``heterofl_tpu/analysis/summary.py``.  :func:`module_table` is the
reference's analytic per-leaf-module table (``(module, input_size,
output_size, params, macs)``, sizes in the reference's NHWC order): its
parameter counts come from the port's ``nn.Module`` at the rate, under the
reference's param-dict names, and the rows equal the reference's as
integers.  :func:`~..fed.core.level_flop_table` and the byte tables of
``fed/core.py`` are built on it.

The reference counts a forward's FLOPs with XLA's ``cost_analysis``; here
:func:`flop_count` runs the sub-model under
``torch.utils.flop_counter.FlopCounterMode``.  That counter counts only
the matmul-like aten ops (convolutions, matrix products, their backward),
two FLOPs a multiply-add, and neither bias adds, elementwise ops, norms
(the BN kernels run through ctypes) nor the embedding's row lookup.  So
the contract of one training-mode forward is
:func:`matmul_flops`: ``2 * sum(macs)`` over the ``_MATMUL_LIKE`` rows of
:func:`module_table`, each convolution row's bias term, the ``embedding``
row and the ``avgpool`` row taken out (``tests/test_torch_port_analysis.py`` pins it
exactly).  Where the counter cannot be imported, :func:`profile_model`
falls back to ``2 x`` the analytic MACs, says so on stderr and records
``flops_source: analytic_2x_macs``.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import config as C
from ..fed.core import _MATMUL_LIKE
from ..models import RESNET_BLOCKS, make_model


def _train_batch(cfg: Dict[str, Any]) -> int:
    bs = cfg["batch_size"]
    return bs["train"] if isinstance(bs, dict) else bs


def module_table(cfg: Dict[str, Any], model_rate: float, batch_size: Optional[int] = None
                 ) -> List[tuple]:
    """Per-leaf-module profile ``(module, input_size, output_size, params,
    macs)`` at ``model_rate`` (the width rate the sub-model is built at)
    and the training batch (or ``batch_size``), the reference's rows
    (ref analysis/summary.py:82-198): convolutions and linears count MACs
    (a conv with a bias adds ``co * bs * ho * wo``), norms ``numel x 2``,
    relu and pools ``numel``, the attention products two rows a layer."""
    model = make_model(cfg, model_rate)
    psize = {k: int(p.numel()) for k, p in model.named_parameters()}
    bs = _train_batch(cfg) if batch_size is None else batch_size

    def mods(prefix):
        return sum(v for k, v in psize.items() if k == prefix or k.startswith(prefix + "."))

    rows: List[tuple] = []

    def add(name, insz, outsz, nparam, macs):
        rows.append((name, tuple(insz), tuple(outsz), int(nparam), int(macs)))

    kind = model.meta["kind"]
    if kind in ("conv", "resnet"):
        h0, w0, cin = cfg["data_shape"]

        def conv_row(name, h, w, ci, co, k, stride, bias):
            ho, wo = -(-h // stride), -(-w // stride)
            macs = k * k * ci * co * bs * ho * wo + (co * bs * ho * wo if bias else 0)
            add(name, (bs, h, w, ci), (bs, ho, wo, co), mods(name), macs)
            return ho, wo

        def norm_relu(norm_name, h, w, c):
            numel = bs * h * w * c
            if cfg["norm"] != "none":
                add(norm_name, (bs, h, w, c), (bs, h, w, c), mods(norm_name), numel * 2)
            add(f"{norm_name}.relu", (bs, h, w, c), (bs, h, w, c), 0, numel)

    if kind == "conv":
        hidden = C.scaled_hidden(cfg["conv"]["hidden_size"], model_rate)
        h, w, ci = h0, w0, cin
        for i, co in enumerate(hidden):
            h_, w_ = conv_row(f"block{i}.conv", h, w, ci, co, 3, 1, True)
            norm_relu(f"block{i}.norm", h_, w_, co)
            if i < len(hidden) - 1:  # the last pool is dropped (ref conv.py:56)
                add(f"block{i}.pool", (bs, h_, w_, co), (bs, h_ // 2, w_ // 2, co), 0,
                    bs * h_ * w_ * co)
                h_, w_ = h_ // 2, w_ // 2
            h, w, ci = h_, w_, co
        add("avgpool", (bs, h, w, ci), (bs, ci), 0, bs * h * w * ci)
        add("linear", (bs, ci), (bs, cfg["classes_size"]), mods("linear"),
            bs * ci * cfg["classes_size"])
    elif kind == "resnet":
        num_blocks, bottleneck = RESNET_BLOCKS[cfg["model_name"]]
        hidden = C.scaled_hidden(cfg["resnet"]["hidden_size"], model_rate)
        expansion = 4 if bottleneck else 1
        h, w = h0, w0
        h, w = conv_row("conv1", h, w, cin, hidden[0], 3, 1, False)
        in_planes = hidden[0]
        for s in range(len(hidden)):
            strides = [1 if s == 0 else 2] + [1] * (num_blocks[s] - 1)
            for b, stride in enumerate(strides):
                pfx, planes = f"layer{s}.{b}", hidden[s]
                out_planes = planes * expansion
                norm_relu(f"{pfx}.n1", h, w, in_planes)  # pre-activation
                if bottleneck:
                    conv_row(f"{pfx}.conv1", h, w, in_planes, planes, 1, 1, False)
                    norm_relu(f"{pfx}.n2", h, w, planes)
                    h2, w2 = conv_row(f"{pfx}.conv2", h, w, planes, planes, 3, stride, False)
                    norm_relu(f"{pfx}.n3", h2, w2, planes)
                    conv_row(f"{pfx}.conv3", h2, w2, planes, out_planes, 1, 1, False)
                else:
                    h2, w2 = conv_row(f"{pfx}.conv1", h, w, in_planes, planes, 3, stride, False)
                    norm_relu(f"{pfx}.n2", h2, w2, planes)
                    conv_row(f"{pfx}.conv2", h2, w2, planes, planes, 3, 1, False)
                if stride != 1 or in_planes != out_planes:
                    conv_row(f"{pfx}.shortcut", h, w, in_planes, out_planes, 1, stride, False)
                h, w, in_planes = h2, w2, out_planes
        norm_relu("n4", h, w, in_planes)
        add("avgpool", (bs, h, w, in_planes), (bs, in_planes), 0, bs * h * w * in_planes)
        add("linear", (bs, in_planes), (bs, cfg["classes_size"]), mods("linear"),
            bs * in_planes * cfg["classes_size"])
    else:  # transformer
        E = C.ceil_width(cfg["transformer"]["embedding_size"], model_rate)
        F = C.ceil_width(cfg["transformer"]["hidden_size"], model_rate)
        L = cfg["transformer"]["num_layers"]
        H = cfg["transformer"]["num_heads"]
        T, V = cfg["bptt"], cfg["num_tokens"]
        ntok = bs * T
        add("embedding", (bs, T), (bs, T, E), mods("embedding"), ntok * E * 2)
        for i in range(L):
            p = f"enc{i}"
            for hname in ("q", "k", "v", "o"):
                add(f"{p}.mha.{hname}", (bs, T, E), (bs, T, E), mods(f"{p}.mha.{hname}"),
                    ntok * E * E)
            add(f"{p}.mha.qk", (bs, T, E), (bs, H, T, T), 0, bs * H * T * T * (E // max(H, 1)))
            add(f"{p}.mha.av", (bs, H, T, T), (bs, T, E), 0, bs * H * T * T * (E // max(H, 1)))
            add(f"{p}.norm1", (bs, T, E), (bs, T, E), mods(f"{p}.norm1"), ntok * E * 2)
            add(f"{p}.ff.l1", (bs, T, E), (bs, T, F), mods(f"{p}.ff.l1"), ntok * E * F)
            add(f"{p}.gelu", (bs, T, F), (bs, T, F), 0, ntok * F)
            add(f"{p}.ff.l2", (bs, T, F), (bs, T, E), mods(f"{p}.ff.l2"), ntok * F * E)
            add(f"{p}.norm2", (bs, T, E), (bs, T, E), mods(f"{p}.norm2"), ntok * E * 2)
        add("dec.l1", (bs, T, E), (bs, T, E), mods("dec.l1"), ntok * E * E)
        add("dec.norm", (bs, T, E), (bs, T, E), mods("dec.norm"), ntok * E * 2)
        add("dec.l2", (bs, T, E), (bs, T, V), mods("dec.l2"), ntok * E * V)
    return rows


def matmul_flops(cfg: Dict[str, Any], rows: List[tuple]) -> int:
    """What ``FlopCounterMode`` counts in one training-mode forward with
    the rows ``rows`` of :func:`module_table`: ``2 * sum(macs)`` over the
    ``_MATMUL_LIKE`` rows, without each convolution row's bias term (the
    counter counts no bias add), the ``embedding`` row (a row lookup, no
    product) and the ``avgpool`` row (a mean, which ``_MATMUL_LIKE``'s
    ``"av"`` matches)."""
    total = 0
    for name, _insz, outsz, _p, macs in rows:
        if name in ("embedding", "avgpool") or not any(t in name for t in _MATMUL_LIKE):
            continue
        if name.endswith(".conv") and cfg["model_name"] == "conv":  # the conv net's biased convs
            macs -= int(np.prod(outsz))
        total += 2 * macs
    return total


def flop_count(fn: Callable[[], Any]) -> Optional[int]:
    """FLOPs of one call of ``fn`` under
    ``torch.utils.flop_counter.FlopCounterMode`` (forward, and backward
    where ``fn`` runs one), or None where the counter cannot be imported."""
    try:
        from torch.utils.flop_counter import FlopCounterMode
    except ImportError:  # pragma: no cover - present from torch 2.1
        return None
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def example_batch(cfg: Dict[str, Any], model, batch_size: int, device) -> Dict[str, Any]:
    """A zero batch of the training shapes on ``device``: NCHW
    (channels_last) images and labels, or an LM's token windows."""
    device = torch.device(device)
    if model.meta["kind"] == "transformer":
        return {"label": torch.zeros((batch_size, cfg["bptt"]), dtype=torch.int64,
                                     device=device)}
    h, w, c = cfg["data_shape"]
    img = torch.zeros((batch_size, c, h, w), device=device).contiguous(
        memory_format=torch.channels_last)
    return {"img": img, "label": torch.zeros(batch_size, dtype=torch.int64, device=device)}


def model_forward(model, batch: Dict[str, Any], gen: Optional[torch.Generator] = None):
    """One training-mode forward of a sliced sub-model (its Scaler at
    ``meta['scaler_rate']``) -> ``(out, loss)``."""
    sr = model.meta["scaler_rate"]
    if model.meta["kind"] == "transformer":
        return model(batch["label"], scaler_rate=sr, train=True, gen=gen)
    return model(batch["img"], batch["label"], scaler_rate=sr)


def profile_model(cfg: Dict[str, Any], model_rate: float, batch_size: Optional[int] = None,
                  device="cpu") -> Dict[str, Any]:
    """Profile one sliced sub-model at ``model_rate`` (ref
    analysis/summary.py:31-79): ``num_params`` and ``space_mb`` from its
    parameters, ``num_flops`` of one training-mode forward at the training
    batch on ``device`` (:func:`flop_count`; the module docstring states
    what it counts)."""
    device = torch.device(device)
    model = make_model(cfg, model_rate).to(device)
    params = dict(model.named_parameters())
    num_params = int(sum(p.numel() for p in params.values()))
    space_mb = sum(p.numel() * p.element_size() for p in params.values()) / (1024 ** 2)
    bs = _train_batch(cfg) if batch_size is None else batch_size
    batch = example_batch(cfg, model, bs, device)
    gen = torch.Generator(device=device).manual_seed(0)
    flops = flop_count(lambda: model_forward(model, batch, gen))
    flops_source = "torch_flop_counter"
    if flops is None:
        # never silently: the analytic count, said on stderr and recorded
        flops = float(matmul_flops(cfg, module_table(cfg, model_rate, bs)))
        flops_source = "analytic_2x_macs"
        print("summary: torch.utils.flop_counter unavailable; using the analytic "
              "matmul-like FLOPs (2x MACs)", file=sys.stderr)
    per_param = [(k, tuple(p.shape), int(p.numel())) for k, p in params.items()]
    return {"num_params": num_params, "num_flops": float(flops), "space_mb": space_mb,
            "batch_size": bs, "per_param": per_param, "model_rate": model_rate,
            "flops_source": flops_source}


def make_summary(cfg: Dict[str, Any], rates: Optional[List[float]] = None,
                 output_dir: Optional[str] = None, save: bool = True,
                 device="cpu") -> Dict[str, Any]:
    """Profile every width level and write the markdown report and the
    result bundles ``output_dir/result/{data}_{model}_{mode}.pkl`` with the
    reference's keys (``num_params``, ``num_flops``, ``space_mb``,
    ``flops_source``), which :mod:`.process` reads."""
    if rates is None:
        rates = sorted(set(C.MODEL_SPLIT_RATE.values()), reverse=True)
    output_dir = output_dir or cfg["output_dir"]
    rows, results = [], {}
    inv_rate = {v: k for k, v in C.MODEL_SPLIT_RATE.items()}
    for rate in rates:
        prof = profile_model(cfg, rate, device=device)
        mode = inv_rate.get(rate, f"{rate:g}")
        rows.append((mode, rate, prof["num_params"], prof["num_flops"], prof["space_mb"]))
        results[mode] = prof
        if save:
            path = os.path.join(output_dir, "result",
                                f"{cfg['data_name']}_{cfg['model_name']}_{mode}.pkl")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump({k: prof[k] for k in ("num_params", "num_flops", "space_mb",
                                                  "flops_source")}, f)
    lines = ["| mode | rate | params | fwd FLOPs/batch | space (MB) |",
             "|------|------|--------|-----------------|------------|"]
    base = rows[0]
    for mode, rate, p, fl, sp in rows:
        fl_s = f"{fl:.3e}" if np.isfinite(fl) else "n/a"
        lines.append(f"| {mode} | {rate:g} | {p:,} ({p/base[2]:.4f}x) | {fl_s} | {sp:.2f} |")
    report = "\n".join(lines)
    mt = module_table(cfg, rates[0])
    mod_lines = ["| module | input | output | params | MACs |",
                 "|--------|-------|--------|--------|------|"]
    for name, insz, outsz, p, fl in mt:
        mod_lines.append(f"| {name} | {'x'.join(map(str, insz))} | "
                         f"{'x'.join(map(str, outsz))} | {p:,} | {fl:,} |")
    mod_lines.append(f"| **total** | | | {sum(r[3] for r in mt):,} | {sum(r[4] for r in mt):,} |")
    module_report = "\n".join(mod_lines)
    if save:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "summary.md"), "w") as f:
            f.write(f"# {cfg['data_name']} {cfg['model_name']} width summary\n\n"
                    f"{report}\n\n## Per-module profile (rate {rates[0]:g})\n\n"
                    f"{module_report}\n")
    return {"rows": rows, "report": report, "results": results,
            "module_table": mt, "module_report": module_report}


def main(argv=None):
    """``python -m heterofl_tpu_torch.analysis.summary`` with the entries'
    flags (``--device cpu`` on a machine without CUDA)."""
    from ..data import fetch_dataset, process_dataset
    from ..entry.common import build_cli, cfg_from_args

    args = build_cli("heterofl_tpu_torch model profiler").parse_args(argv)
    cfg = C.process_control(cfg_from_args(args))
    dev = torch.device(cfg["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available "
                           "(pass --device cpu)")
    dataset = fetch_dataset(cfg["data_name"], cfg["data_dir"], synthetic=cfg["synthetic"],
                            synthetic_sizes=cfg.get("synthetic_sizes"),
                            subset=cfg.get("subset", "label"))
    cfg, _ = process_dataset(cfg, dataset)
    out = make_summary(cfg, device=dev)
    print(out["report"])
    return out


if __name__ == "__main__":
    main()
