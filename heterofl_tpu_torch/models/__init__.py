"""Model factory.

Port of ``heterofl_tpu/models/__init__.py`` for the conv net, the
pre-activation ResNets (basic block: 18, 34; bottleneck: 50, 101, 152) and
the masked-LM transformer: constructed widths are ``ceil(model_rate *
base)``.  ``make_model(cfg)`` builds the global model; ``make_model(cfg,
rate)`` the dense sub-model of a level, whose parameter names are the
global model's and whose shapes are the global model's sliced at ``rate /
global_model_rate`` (the grouped engine and the sliced twin train it, with
the Scaler at that ratio, ``meta['scaler_rate']``).  ``cfg['compute_dtype']``
and ``cfg['conv_impl']`` are parsed once here and go to every family, as
the reference's ``make_model`` hands them on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..config import ceil_width, parse_compute_dtype, parse_conv_impl, scaled_hidden
from .base import FedModel  # noqa: F401
from .conv import ConvNet
from .resnet import ResNet
from .spec import Group, ParamSpec, count_masks, mask_params, param_mask  # noqa: F401
from .transformer import Transformer

#: blocks per stage, and whether the block is the bottleneck
RESNET_BLOCKS = {
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
    "resnet152": ([3, 8, 36, 3], True),
}


def make_model(cfg: Dict[str, Any], model_rate: Optional[float] = None) -> FedModel:
    """The model of ``cfg`` at ``model_rate`` (default: the global model's),
    parameters zero until ``init_``."""
    model = _build(cfg, cfg["global_model_rate"] if model_rate is None else model_rate)
    model.meta["model_rate"] = cfg["global_model_rate"] if model_rate is None else model_rate
    model.meta["scaler_rate"] = model.meta["model_rate"] / cfg["global_model_rate"]
    return model


def _build(cfg: Dict[str, Any], rate: float) -> FedModel:
    name = cfg["model_name"]
    compute_dtype = parse_compute_dtype(cfg.get("compute_dtype"))
    conv_impl = parse_conv_impl(cfg.get("conv_impl"))
    if name == "transformer":
        t = cfg["transformer"]
        return Transformer(cfg["num_tokens"], ceil_width(t["embedding_size"], rate),
                           t["num_heads"], ceil_width(t["hidden_size"], rate), t["num_layers"],
                           t["dropout"], cfg["bptt"], cfg["mask_rate"], mask=cfg["mask"],
                           compute_dtype=compute_dtype)
    kw = dict(norm=cfg["norm"], scale=cfg["scale"], mask=cfg["mask"],
              pallas_norm=bool(cfg.get("pallas_norm", False)), compute_dtype=compute_dtype,
              conv_impl=conv_impl)
    if name == "conv":
        return ConvNet(cfg["data_shape"], scaled_hidden(cfg["conv"]["hidden_size"], rate),
                       cfg["classes_size"], **kw)
    if name in RESNET_BLOCKS:
        blocks, bottleneck = RESNET_BLOCKS[name]
        return ResNet(cfg["data_shape"], scaled_hidden(cfg["resnet"]["hidden_size"], rate),
                      blocks, cfg["classes_size"], bottleneck=bottleneck, **kw)
    raise ValueError(f"Not valid model_name: {name!r} (one of "
                     f"{('conv',) + tuple(RESNET_BLOCKS) + ('transformer',)})")
