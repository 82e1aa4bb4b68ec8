"""Model factory.

Port of ``heterofl_tpu/models/__init__.py`` for the conv net and the
basic-block ResNets: constructed widths are ``ceil(model_rate * base)``.
Only the global model is built (the masked strategy).
"""

from __future__ import annotations

from typing import Any, Dict

from ..config import scaled_hidden
from .base import FedModel  # noqa: F401
from .conv import ConvNet
from .resnet import ResNet
from .spec import Group, ParamSpec, count_masks, mask_params, param_mask  # noqa: F401

RESNET_BLOCKS = {"resnet18": [2, 2, 2, 2], "resnet34": [3, 4, 6, 3]}


def make_model(cfg: Dict[str, Any]) -> FedModel:
    """The global model of ``cfg``, parameters zero until ``init_``."""
    name = cfg["model_name"]
    rate = cfg["global_model_rate"]
    kw = dict(norm=cfg["norm"], scale=cfg["scale"], mask=cfg["mask"],
              pallas_norm=bool(cfg.get("pallas_norm", False)))
    if name == "conv":
        return ConvNet(cfg["data_shape"], scaled_hidden(cfg["conv"]["hidden_size"], rate),
                       cfg["classes_size"], **kw)
    if name in RESNET_BLOCKS:
        return ResNet(cfg["data_shape"], scaled_hidden(cfg["resnet"]["hidden_size"], rate),
                      RESNET_BLOCKS[name], cfg["classes_size"], **kw)
    raise NotImplementedError(
        f"model_name={name!r} is not ported to heterofl_tpu_torch yet "
        f"(one of {('conv',) + tuple(RESNET_BLOCKS)})")
