"""Model registry: the ``_name_`` of a model config block -> backbone.

Port of ``diffwave_sashimi_tpu/models/__init__.py``: the remaining config
keys are constructor keywords, and keys the constructor does not take are
dropped (as the reference's ``**kwargs`` swallows them), except
``kernel_fft_fast``, which changes the numerics in JAX and is refused.
``precision`` sets the activation dtype of either backbone: f32, or bf16
(the shipped default), which samples and trains every model (SC09 SaShiMi
and WaveNet, the vocoder, unconditional and mel-conditioned); on the card
SaShiMi widths the channel-mixer kernels do not take are refused by name,
and training past the long conv's FFT size 2^20 by its size.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import torch

from .sashimi import Sashimi, check_mixer_widths, check_train_length
from .wavenet import WaveNet

_REGISTRY = {"sashimi": Sashimi, "wavenet": WaveNet}
_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "float32": torch.float32}
KERNEL_FFT_FAST_TODO = ("model.kernel_fft_fast (the precision of the S4 "
                        "kernel construction's FFT) is not ported: "
                        "ROADMAP.md queue 1, item 1")


def activation_dtype(precision: str) -> torch.dtype:
    if precision not in _DTYPES:
        raise ValueError(f"compute.precision {precision!r}: one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[precision]


def check_supported(model_cfg: Dict[str, Any], precision: str,
                    train: bool = False, *, device_type: str) -> None:
    """Raise on a model config or precision the port does not run on
    ``device_type`` ("cuda" or "cpu") for sampling, or with ``train`` for
    training (by name, with its ROADMAP entry), before anything is
    built."""
    def arg(key):       # the config's value, else Sashimi's default
        return model_cfg.get(
            key, inspect.signature(Sashimi).parameters[key].default)

    dtype = activation_dtype(precision)
    name = model_cfg["_name_"]
    if name not in _REGISTRY:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if model_cfg.get("kernel_fft_fast"):
        raise NotImplementedError(KERNEL_FFT_FAST_TODO)
    if name == "sashimi" and device_type == "cuda":
        check_mixer_widths(arg("d_model"), arg("expand"), len(arg("pool")),
                           arg("ff"), dtype, train)
    if train and name == "sashimi":
        check_train_length(int(arg("L")), device_type)


def construct_model(model_cfg: Dict[str, Any], precision: str = "f32",
                    generator: Optional[torch.Generator] = None):
    """Build the backbone (on the CPU) from a model config block."""
    check_supported(model_cfg, precision, device_type="cpu")
    cfg = dict(model_cfg)
    cls = _REGISTRY[cfg.pop("_name_")]
    params = inspect.signature(cls).parameters
    kwargs = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg.items() if k in params}
    return cls(**kwargs, dtype=activation_dtype(precision),
               generator=generator)
