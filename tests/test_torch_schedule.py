"""Port parity: diffusion schedule and step embedding vs the JAX package.

The schedule rows agree to atol 1e-6 (both compute in float64 numpy and
store float32).  The embedding agrees to atol 2e-5: XLA's and torch's
float32 exp differ by one ulp on some frequencies, and at steps up to 199
that is ~1e-5 in the sine's argument."""

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)

from diffwave_sashimi_tpu.diffusion import schedule as jsched
from diffwave_sashimi_tpu.models.embedding import (
    diffusion_step_embedding as jax_embedding)
from diffwave_sashimi_torch.diffusion import schedule as tsched
from diffwave_sashimi_torch.models.embedding import diffusion_step_embedding

BASE = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}


def _rows(s):
    return [s.beta, s.alpha, s.alpha_bar, s.sigma] + (
        [] if s.t_embed is None else [s.t_embed])


@pytest.mark.parametrize("cfg,fast", [
    (BASE, False),
    (BASE, True),                                     # no beta: linear
    (dict(BASE, fast_steps=12), True),                # canon, aligned
    (dict(BASE, fast_steps=12, fast_shape="geom"), True),
    (dict(BASE, beta=[0.0001, 0.001, 0.01, 0.05, 0.2, 0.5]), True),
    (dict(BASE, fast_steps=6, align=False), True),
])
def test_schedule_matches_jax(cfg, fast):
    js = jsched.schedule_from_cfg(cfg, fast=fast)
    ts = tsched.schedule_from_cfg(cfg, fast=fast)
    assert ts.T == js.T
    assert (ts.t_embed is None) == (js.t_embed is None)
    for a, b in zip(_rows(ts), _rows(js)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("T,shape", [(12, "canon"), (8, "geom"), (6, "canon")])
def test_fast_beta_list_matches_jax(T, shape):
    np.testing.assert_allclose(tsched.fast_beta_list(T, shape),
                               jsched.fast_beta_list(T, shape), rtol=1e-12)


def test_embedding_matches_jax_integer_and_fractional():
    steps = np.array([0, 1, 57, 199, 3.25, 118.6], np.float32)
    ref = np.asarray(jax_embedding(steps, 128))
    out = diffusion_step_embedding(torch.from_numpy(steps), 128)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    ints = diffusion_step_embedding(torch.tensor([0, 1, 57, 199]), 128)
    np.testing.assert_array_equal(ints.numpy(), out.numpy()[:4])
