"""Carry JAX-package parameters into the port's state dict.

:func:`params_from_jax` is the inverse of
``diffwave_sashimi_tpu/utils/torch_compat.py::sashimi_from_torch`` and
``wavenet_from_torch``: it maps the JAX ``{"params": ...}`` numpy tree of a
SaShiMi model (block-scan stacked ``d0_blocks: {block: ...}`` or per-block
``d0_block{j}``) or of a WaveNet (``block{n}``) to the reference torch
names the port's modules use, with each block's mel conditioner when the
model is conditional.  Needs numpy only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _wn(sd, prefix: str, p: Mapping[str, Any]) -> None:
    v = np.asarray(p["v"])
    sd[prefix + ".weight_v"] = _t(v)
    sd[prefix + ".weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    sd[prefix + ".bias"] = _t(p["b"])


def _linear(sd, prefix: str, p: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = _t(p["w"])
    sd[prefix + ".bias"] = _t(p["b"])


def _tln(sd, prefix: str, p: Mapping[str, Any]) -> None:
    sd[prefix + ".m"] = _t(p["m"])
    sd[prefix + ".s"] = _t(p["s"])


def _block(sd, prefix: str, p: Mapping[str, Any], conditional: bool) -> None:
    _linear(sd, prefix + ".fc_t", p["fc_t"])
    _tln(sd, prefix + ".norm1", p["norm1"])
    _tln(sd, prefix + ".norm2", p["norm2"])
    s4 = p["s4"]
    sd[prefix + ".layer.D"] = _t(s4["D"])
    for k in ("C", "B", "P", "inv_w_real", "w_imag", "log_dt"):
        sd[f"{prefix}.layer.kernel.kernel.{k}"] = _t(s4["kernel"][k])
    _linear(sd, prefix + ".layer.output_linear.0", s4["output_linear"])
    _wn(sd, prefix + ".ff.ff.0.conv", p["ff1"])
    _wn(sd, prefix + ".ff.ff.2.conv", p["ff2"])
    if conditional:
        _mel_block(sd, prefix, p)


def _mel_block(sd, prefix: str, p: Mapping[str, Any]) -> None:
    """A block's mel conditioner: upsample_conv2d.{0,1} and mel_conv."""
    for i in (0, 1):
        q = p["mel_upsampler"][f"upsample{i}"]
        key = f"{prefix}.upsample_conv2d.{i}"
        sd[key + ".weight_v"] = _t(q["v"])
        sd[key + ".weight_g"] = _t(np.asarray(q["g"]).reshape(1, 1, 1, 1))
        sd[key + ".bias"] = _t(q["b"])
    _wn(sd, prefix + ".mel_conv.conv", p["mel_conv"])


def params_from_jax(params: Mapping[str, Any], model_cfg
                    ) -> Dict[str, torch.Tensor]:
    """JAX SaShiMi or WaveNet params (``{"params": tree}`` or the bare
    tree) -> the port's ``state_dict``."""
    name = model_cfg["_name_"]
    if name not in ("sashimi", "wavenet"):
        raise NotImplementedError(f"{name!r} is not ported")
    conditional = not model_cfg.get("unconditional", True)
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    _wn(sd, "init_conv.0.conv", p["init_conv"])
    if name == "wavenet":
        _wavenet_body(sd, p, int(model_cfg["num_res_layers"]), conditional)
    else:
        _sashimi_body(sd, p, model_cfg, conditional)
    _wn(sd, "final_conv.0.conv", p["final_conv1"])
    sd["final_conv.2.conv.weight"] = _t(np.asarray(
        p["final_conv2"]["w"])[:, :, None])
    sd["final_conv.2.conv.bias"] = _t(p["final_conv2"]["b"])
    return sd


def _wavenet_body(sd, p: Mapping[str, Any], n_layers: int,
                  conditional: bool) -> None:
    """fc_t1/fc_t2 and the blocks under ``residual_layer`` (the inverse of
    ``wavenet_from_torch``; res_conv and skip_conv have no ``.conv``)."""
    _linear(sd, "residual_layer.fc_t1", p["fc_t1"])
    _linear(sd, "residual_layer.fc_t2", p["fc_t2"])
    for n in range(n_layers):
        rb, q = f"residual_layer.residual_blocks.{n}", p[f"block{n}"]
        _linear(sd, rb + ".fc_t", q["fc_t"])
        _wn(sd, rb + ".dilated_conv_layer.conv", q["dilated_conv"])
        _wn(sd, rb + ".res_conv", q["res_conv"])
        _wn(sd, rb + ".skip_conv", q["skip_conv"])
        if conditional:
            _mel_block(sd, rb, q)


def _sashimi_body(sd, p: Mapping[str, Any], model_cfg,
                  conditional: bool) -> None:
    """fc_t1/fc_t2, the pooled stages' blocks and the final norm."""
    n_layers, pool = int(model_cfg["n_layers"]), list(model_cfg["pool"])
    unet = bool(model_cfg.get("unet", True))

    def blk(stage: str, j: int):
        if f"{stage}_blocks" in p:      # block-scan: slice the stacked axis
            return _index(p[f"{stage}_blocks"]["block"], j)
        return p[f"{stage}_block{j}"]

    _linear(sd, "fc_t1", p["fc_t1"])
    _linear(sd, "fc_t2", p["fc_t2"])
    i = 0
    for si in range(len(pool)):
        if unet:
            for j in range(n_layers):
                _block(sd, f"d_layers.{i}", blk(f"d{si}", j), conditional)
                i += 1
        _wn(sd, f"d_layers.{i}.linear.conv", p[f"down{si}"]["linear"])
        i += 1
    for j in range(n_layers):
        _block(sd, f"c_layers.{j}", blk("c", j), conditional)
    i = 0
    for si in range(len(pool)):
        _wn(sd, f"u_layers.{i}.linear.conv", p[f"up{si}"]["linear"])
        i += 1
        for j in range(n_layers):
            _block(sd, f"u_layers.{i}", blk(f"u{si}", j), conditional)
            i += 1
    _tln(sd, "norm", p["norm"])


def _index(tree, j: int):
    if isinstance(tree, Mapping):
        return {k: _index(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]
