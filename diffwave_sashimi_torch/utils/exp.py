"""Experiment-store naming and checkpoint discovery.

Port of ``diffwave_sashimi_tpu/utils/exp.py`` (the reference's on-disk
contract), which cannot be imported from here because its package
``__init__`` imports jax:

  exp/<name>_<model_id>_T<T>_betaT<beta_T>[_L<len>_hop<hop>]_{uncond,cond}/
      checkpoint/<iter>.pkl
      waveforms/<iter>/<iter//1000>k_<i>.wav
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def model_identifier(model_cfg) -> str:
    name = model_cfg["_name_"]
    if name == "wavenet":
        return "wnet_h{}_d{}".format(model_cfg["res_channels"],
                                     model_cfg["num_res_layers"])
    if name == "sashimi":
        return "{}_d{}_n{}_pool_{}_expand{}_ff{}".format(
            "unet" if model_cfg["unet"] else "snet", model_cfg["d_model"],
            model_cfg["n_layers"], len(model_cfg["pool"]),
            model_cfg["expand"], model_cfg["ff"])
    raise ValueError(f"Unknown model name {name!r}")


def local_directory(name: Optional[str], model_cfg, diffusion_cfg,
                    dataset_cfg, output_directory: str,
                    makedirs: bool = True) -> Tuple[str, str]:
    """(run_name, exp/<run_name>/<output_directory>), created if asked."""
    local_path = model_identifier(model_cfg) \
        + f"_T{diffusion_cfg['T']}_betaT{diffusion_cfg['beta_T']}"
    if not model_cfg["unconditional"]:
        local_path += (f"_L{dataset_cfg['segment_length']}"
                       f"_hop{dataset_cfg['hop_length']}")
    local_path += "_uncond" if model_cfg["unconditional"] else "_cond"
    if name:
        local_path = name + "_" + local_path
    out_dir = os.path.join("exp", local_path, output_directory)
    if makedirs:
        os.makedirs(out_dir, mode=0o775, exist_ok=True)
    return local_path, out_dir


def find_max_epoch(path: str) -> int:
    """Largest ``<iter>.pkl`` iteration in ``path``; -1 if none."""
    if not os.path.isdir(path):
        return -1
    epoch = -1
    for f in os.listdir(path):
        if len(f) > 4 and f.endswith(".pkl") and f[:-4].isdigit():
            epoch = max(epoch, int(f[:-4]))
    return epoch
