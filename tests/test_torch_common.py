"""Shared helpers for the PyTorch-port parity tests (this module holds no
tests).  Inputs are made with numpy from fixed seeds and handed to both the
JAX package and the port, on the CPU, in f32.  torch runs single-threaded
because the suite runs under several pytest-xdist workers."""

import copy

import numpy as np
import torch

torch.set_num_threads(1)

SMALL_CFG = {"_name_": "sashimi", "unconditional": True, "in_channels": 1,
             "out_channels": 1, "diffusion_step_embed_dim_in": 128,
             "diffusion_step_embed_dim_mid": 512,
             "diffusion_step_embed_dim_out": 512, "unet": True,
             "d_model": 8, "n_layers": 1, "pool": [4, 4], "expand": 2,
             "ff": 2, "L": 16000}     # the JAX suite's sashimi_small model


def perturbed(params, seed=0):
    """A copy of JAX Sashimi params with a random (normally zero-init)
    final_conv2, so eps comparisons are not comparisons of zeros."""
    p = copy.deepcopy(jax_to_numpy(params))
    rng = np.random.RandomState(seed)
    fc = p["params"]["final_conv2"]
    fc["w"] = (0.3 * rng.randn(*fc["w"].shape)).astype(np.float32)
    fc["b"] = (0.3 * rng.randn(*fc["b"].shape)).astype(np.float32)
    return p


def jax_to_numpy(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_model(np_params, cfg=SMALL_CFG):
    """The port's model carrying the JAX params."""
    from diffwave_sashimi_torch.models import construct_model
    from diffwave_sashimi_torch.runtime.checkpoint import load_into
    from diffwave_sashimi_torch.utils.jax_compat import params_from_jax
    model = construct_model(cfg, generator=torch.Generator().manual_seed(0))
    load_into(model, params_from_jax(np_params, cfg))
    return model.eval()
