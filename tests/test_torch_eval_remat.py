"""Port parity for ``compute.remat`` (activation rematerialisation of the
training blocks, ``models/remat.py``) at the JAX suite's ``sashimi_small``
size on the CPU: the checkpointed blocks give gradients bit-equal to the
plain ones and within tests/test_sashimi_parity.py's atol 1e-3 / rtol
1e-2 of JAX's ``remat=True``, and every forward kernel of a block runs
twice a step (nothing is kept, as JAX's CPU route keeps nothing).  The
helpers here serve tests/test_torch_eval_runtime.py too."""

import importlib

import numpy as np
import torch

from test_torch_common import SMALL_CFG, jax_to_numpy, perturbed, port_model

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.sashimi import Sashimi as JaxSashimi
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

ATOL, RTOL = 1e-3, 1e-2
DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}


def _batch(L, B=2, seed=3):
    rng = np.random.RandomState(seed)
    audio = (0.5 * rng.randn(B, 1, L)).astype(np.float32)
    return audio, np.array([3, 170], np.int32)[:B], \
        rng.randn(B, 1, L).astype(np.float32)


def _jax_grads(model, params, audio, t, z, mel=None):
    abar = np.asarray(jax_schedule(DIFFUSION).alpha_bar)[t].reshape(
        -1, 1, 1)

    def loss_fn(q):
        x_t = jnp.sqrt(abar) * audio + jnp.sqrt(1.0 - abar) * z
        eps = model.apply(q, x_t, jnp.asarray(t), mel, train=True)
        return jnp.mean((eps - z) ** 2)
    return jax_to_numpy(jax.jit(jax.grad(loss_fn))(params))


def _port_grads(model, audio, t, z, mel=None):
    loss = training_loss(model, torch.from_numpy(audio),
                         schedule_from_cfg(DIFFUSION), t=torch.from_numpy(t),
                         z=torch.from_numpy(z),
                         mel=None if mel is None else torch.from_numpy(mel))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def _hold_remat(cfg, np_params, audio, t, z, mel=None, jax_model=None):
    """Port remat gradients bit-equal to the plain ones, and (with
    ``jax_model``, built with remat=True) within ATOL/RTOL of JAX's."""
    plain = port_model(np_params, cfg)
    remat = port_model(np_params, cfg)
    remat.remat = True
    loss0, g0 = _port_grads(plain, audio, t, z, mel)
    loss1, g1 = _port_grads(remat, audio, t, z, mel)
    assert torch.equal(loss0, loss1)
    for name, g in g0.items():
        assert (g is None and g1[name] is None) or torch.equal(g, g1[name]), \
            name
    if jax_model is None:
        return
    ref = params_from_jax(_jax_grads(jax_model, np_params, audio, t, z, mel),
                          cfg)
    assert set(ref) == set(g1)
    for name, g in ref.items():
        mine = g1[name]
        if mine is None:        # a parameter the loss never reaches
            assert float(g.abs().max()) == 0.0, name
            continue
        np.testing.assert_allclose(mine.reshape(g.shape).numpy(), g.numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_sashimi_remat_gradients(sashimi_small):
    _, params = sashimi_small
    model = JaxSashimi(d_model=8, n_layers=1, pool=(4, 4), expand=2, ff=2,
                       L=16000, remat=True)
    _hold_remat(SMALL_CFG, perturbed(params, seed=1), *_batch(16000),
                jax_model=model)


def test_remat_runs_each_block_forward_kernel_twice(monkeypatch):
    """The forward kernels of a block (1 or 1f, 2 or 2f, 3 or 3f) run
    again in the backward pass; the backward kernels and the S4 kernel
    construction (outside the blocks) run once.  Counted at the wrappers'
    entries, which on the CPU run the plain versions."""
    chmix = importlib.import_module("diffwave_sashimi_torch.ops.chmix")
    fftconv = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    cauchy = importlib.import_module("diffwave_sashimi_torch.ops.cauchy")
    calls = {}
    for mod, name in ((chmix, "ln_ff_res"), (chmix, "mix_glu_res"),
                      (fftconv, "fftconv"), (fftconv, "fftconv_dkf"),
                      (chmix, "glu_res_bwd"), (chmix, "ln_ff_res_bwd"),
                      (cauchy, "cauchy_quad")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    got = {}
    for remat in (False, True):
        calls.clear()
        model = construct_model(SMALL_CFG, remat=remat,
                                generator=torch.Generator().manual_seed(0))
        _port_grads(model, *_batch(16000))
        got[remat] = dict(calls)
    blocks = 5                       # d8 n1: 2 down, 1 centre, 2 up
    assert got[False] == {"ln_ff_res": blocks, "mix_glu_res": blocks,
                          "fftconv": 2 * blocks, "fftconv_dkf": blocks,
                          "glu_res_bwd": blocks, "ln_ff_res_bwd": blocks,
                          "cauchy_quad": blocks}
    assert got[True] == dict(got[False], ln_ff_res=2 * blocks,
                             mix_glu_res=2 * blocks, fftconv=3 * blocks)
