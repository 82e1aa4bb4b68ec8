"""Model factory.

Port of ``heterofl_tpu/models/__init__.py`` for the conv net, the
pre-activation ResNets (basic block: 18, 34; bottleneck: 50, 101, 152) and
the masked-LM transformer: constructed widths are ``ceil(model_rate *
base)``.
Only the global model is built (the masked strategy).
"""

from __future__ import annotations

from typing import Any, Dict

from ..config import ceil_width, scaled_hidden
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


def make_model(cfg: Dict[str, Any]) -> FedModel:
    """The global model of ``cfg``, parameters zero until ``init_``."""
    name = cfg["model_name"]
    rate = cfg["global_model_rate"]
    if name == "transformer":
        t = cfg["transformer"]
        return Transformer(cfg["num_tokens"], ceil_width(t["embedding_size"], rate),
                           t["num_heads"], ceil_width(t["hidden_size"], rate), t["num_layers"],
                           t["dropout"], cfg["bptt"], cfg["mask_rate"], mask=cfg["mask"])
    kw = dict(norm=cfg["norm"], scale=cfg["scale"], mask=cfg["mask"],
              pallas_norm=bool(cfg.get("pallas_norm", False)))
    if name == "conv":
        return ConvNet(cfg["data_shape"], scaled_hidden(cfg["conv"]["hidden_size"], rate),
                       cfg["classes_size"], **kw)
    if name in RESNET_BLOCKS:
        blocks, bottleneck = RESNET_BLOCKS[name]
        return ResNet(cfg["data_shape"], scaled_hidden(cfg["resnet"]["hidden_size"], rate),
                      blocks, cfg["classes_size"], bottleneck=bottleneck, **kw)
    raise ValueError(f"Not valid model_name: {name!r} (one of "
                     f"{('conv',) + tuple(RESNET_BLOCKS) + ('transformer',)})")
