"""Backbone factory (``libcontinual_tpu/models/__init__.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from libcontinual_tpu_torch.registry import BACKBONES

# importing the modules populates the registry
from libcontinual_tpu_torch.models import alexnet as _alexnet  # noqa: F401
from libcontinual_tpu_torch.models import cbam as _cbam  # noqa: F401
from libcontinual_tpu_torch.models import clip as _clip  # noqa: F401
from libcontinual_tpu_torch.models import resnet as _resnet  # noqa: F401
from libcontinual_tpu_torch.models import vit as _vit  # noqa: F401


def compute_dtype(config: Dict[str, Any]) -> torch.dtype:
    return torch.bfloat16 if str(config.get("dtype", "bfloat16")) == "bfloat16" else torch.float32


def backbone_feat_dim(config: Dict[str, Any]) -> int:
    """The feature width: ``classifier.kwargs.feat_dim``, else the ResNet
    table."""
    cls_kwargs = (config.get("classifier") or {}).get("kwargs") or {}
    if "feat_dim" in cls_kwargs:
        return int(cls_kwargs["feat_dim"])
    name = config["backbone"]["name"]
    if name in _resnet.FEATURE_DIMS:
        return _resnet.FEATURE_DIMS[name]
    raise ValueError(f"cannot infer feat_dim for backbone '{name}'")


def get_backbone(config: Dict[str, Any], generator: Optional[torch.Generator] = None):
    """Build the backbone module from ``config['backbone']`` = {name, kwargs}
    on the CPU; the caller moves it to its device."""
    node = config["backbone"]
    kwargs = dict(node.get("kwargs") or {})
    kwargs.pop("num_classes", None)  # heads are owned by methods
    kwargs.setdefault("dataset", config.get("dataset", ""))  # a CIFAR dataset: the CIFAR stem
    return BACKBONES.get(node["name"])(
        **{**kwargs, "dtype": compute_dtype(config), "generator": generator}
    )
