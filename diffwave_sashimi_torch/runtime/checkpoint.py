"""Checkpoint save and load with the reference layout.

Files are ``exp/<run>/checkpoint/<iter>.pkl`` holding a dict with
``model_state_dict`` (and, from the trainers, ``optimizer_state_dict`` and
``step``).  Three producers are read:

- the JAX package (``diffwave_sashimi_tpu.runtime.checkpoint.
  save_checkpoint``): a pickle whose state is the flax ``{"params": ...}``
  numpy tree, converted with :func:`..utils.jax_compat.params_from_jax`;
- the reference torch framework: ``torch.save`` of a torch state dict;
- this port: ``torch.save`` of its state dict, which uses the reference's
  names (:func:`save_checkpoint`).

``ckpt_iter`` is ``"max"`` (the largest iteration present) or an int;
-1, like "none found", means none.  Resuming from a JAX pickle or a
reference torch file loads the parameters only: optimizer state is read
from the port's own files only (the JAX package does the same for torch
files).  Pickles are trusted input: they are written by this project's
trainers.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.exp import find_max_epoch
from ..utils.jax_compat import params_from_jax

FORMAT = "diffwave_sashimi_torch.v1"


def resolve_iter(directory: str, ckpt_iter) -> int:
    """``"max"`` -> the largest ``<iter>.pkl`` in ``directory`` (-1 if none);
    an int (or its string) -> itself."""
    if ckpt_iter == "max":
        return find_max_epoch(directory)
    return int(ckpt_iter)


def save_checkpoint(directory: str, step: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> str:
    """Write ``<directory>/<step>.pkl`` atomically in the port's format
    (``os.replace`` of a finished temporary file).  A DDP-wrapped model
    is saved as its module, so the names carry no ``module.`` prefix and
    load at any number of ranks."""
    from torch.nn.parallel import DistributedDataParallel
    if isinstance(model, DistributedDataParallel):
        model = model.module
    os.makedirs(directory, mode=0o775, exist_ok=True)
    path = os.path.join(directory, f"{step}.pkl")
    payload = {"model_state_dict": {k: v.detach().cpu() for k, v in
                                    model.state_dict().items()},
               "step": int(step), "format": FORMAT}
    if optimizer is not None:
        payload["optimizer_state_dict"] = optimizer.state_dict()
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def _read(path: str) -> Dict[str, Any]:
    if zipfile.is_zipfile(path):                 # torch.save (zip format)
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:                  # pickle (JAX package)
        return pickle.load(f)


def load_checkpoint(directory: str, ckpt_iter, model_cfg
                    ) -> Optional[Dict[str, Any]]:
    """``{"model_state_dict", "optimizer_state_dict", "step"}`` for
    ``ckpt_iter`` in ``directory`` (the optimizer state only from the
    port's own files, else None), or None when there is no such
    checkpoint."""
    it = resolve_iter(directory, ckpt_iter)
    path = os.path.join(directory, f"{it}.pkl")
    if it < 0 or not os.path.exists(path):
        return None
    raw = _read(path)
    sd = raw["model_state_dict"]
    if isinstance(sd.get("params"), dict):       # flax variables tree
        sd = params_from_jax(sd, model_cfg)
    else:
        sd = {k: v if isinstance(v, torch.Tensor)
              else torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    own = raw.get("format") == FORMAT
    return {"model_state_dict": sd,
            "optimizer_state_dict": (raw.get("optimizer_state_dict")
                                     if own else None),
            "step": int(raw.get("step", it))}


def load_state_dict(directory: str, ckpt_iter, model_cfg
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The port's state dict for ``ckpt_iter`` in ``directory``, or None
    when there is no such checkpoint."""
    ck = load_checkpoint(directory, ckpt_iter, model_cfg)
    return None if ck is None else ck["model_state_dict"]


def load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """``load_state_dict`` (strict), reshaping an entry whose element count
    matches (the reference stores its output-linear bias as (2H, 1))."""
    own = model.state_dict()
    fitted = {}
    for k, v in sd.items():
        if k in own and v.shape != own[k].shape \
                and v.numel() == own[k].numel():
            v = v.reshape(own[k].shape)
        fitted[k] = v
    model.load_state_dict(fitted, strict=True)
