"""Model registry: the ``_name_`` of a model config block -> backbone.

Port of ``diffwave_sashimi_tpu/models/__init__.py``: the remaining config
keys are constructor keywords, and keys the constructor does not take are
dropped (as the reference's ``**kwargs`` swallows them).  Both backbones,
SaShiMi and WaveNet, are ported, at f32 only.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import torch

from .sashimi import Sashimi
from .wavenet import WaveNet

_REGISTRY = {"sashimi": Sashimi, "wavenet": WaveNet}
BF16_TODO = ("compute.precision=bf16 is not ported yet: ROADMAP.md queue 1, "
             "'bf16 activation policy for sampling'")


def construct_model(model_cfg: Dict[str, Any], precision: str = "f32",
                    generator: Optional[torch.Generator] = None):
    """Build the backbone (on the CPU) from a model config block."""
    if precision not in ("f32", "float32"):
        raise NotImplementedError(BF16_TODO)
    cfg = dict(model_cfg)
    name = cfg.pop("_name_")
    if name not in _REGISTRY:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    cls = _REGISTRY[name]
    params = inspect.signature(cls).parameters
    kwargs = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg.items() if k in params}
    return cls(**kwargs, generator=generator)
