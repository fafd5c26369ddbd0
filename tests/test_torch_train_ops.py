"""Port parity for the training kernels' plain versions (kernels 1 in its
training form, 5, 6, 7 and 8) against the JAX package's kernels run as its
own CPU tests run them (Pallas interpret mode, or the plain reference its
custom VJP takes there), and the port's autograd Functions against torch
autograd of their plain forwards and against finite differences.

Inputs from numpy seeds, f32 on the CPU unless stated.  Tolerances are on
the max error relative to the max |reference|."""

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.ops import chmix as jchmix
from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_tpu.ops.cauchy_pallas import cauchy_sym_pallas
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.models.s4 import SSKernelNPLR, _fft_nodes


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def _flat(xc):
    """Compact (B, S, H, Rc) -> flat (B, H, S * Rc): for the position-wise
    channel mixes any consistent order of the positions will do."""
    x = np.asarray(xc)
    B, S, H, Rc = x.shape
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(B, H, S * Rc)))


def _chmix_data(seed, B=2, S=8, H=16, Rc=128):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: jnp.asarray(                  # noqa: E731
        (rng.randn(*s) * sc).astype(np.float32))
    return dict(x=f(B, S, H, Rc, sc=0.3) + 0.1, skip=f(B, S, H, Rc, sc=0.3),
                g=f(B, S, H, Rc), w=f(2 * H, H, sc=0.1), b=f(2 * H, sc=0.1),
                w1=f(2 * H, H, sc=0.1), b1=f(2 * H, sc=0.1),
                w2=f(H, 2 * H, sc=0.1), b2=f(H, sc=0.1),
                m=jnp.asarray([0.1], np.float32),
                s=jnp.asarray([1.2], np.float32))


def test_glu_bwd_matches_jax_glu_train_vjp():
    """Kernel 6's plain version vs the JAX _glu_bwd_kernel (interpret
    mode) through jax.vjp of _glu_train: 2e-5 of max|ref|."""
    d = _chmix_data(1)
    _, vjp = jax.vjp(lambda *a: jchmix._glu_train(False, *a),
                     d["x"], d["skip"], d["w"], d["b"])
    dy, dres, dw, db = vjp(d["g"])
    t = lambda k: torch.from_numpy(np.array(d[k]))   # noqa: E731
    out = ops.glu_res_bwd_ref(_flat(d["x"]), t("w"), t("b"), _flat(d["g"]))
    assert _rel(out[0], _flat(dy)) < 2e-5
    assert _rel(out[1], dw) < 2e-5
    assert _rel(out[2], db) < 2e-5
    np.testing.assert_array_equal(np.asarray(dres), np.asarray(d["g"]))


@pytest.mark.parametrize("with_skip", [False, True])
def test_ff_bwd_matches_jax_ff_train_vjp(with_skip):
    """Kernel 7's plain version vs the JAX _ff_bwd_kernel (interpret mode)
    through jax.vjp of _ff_train / _ff_train_skip: 2e-5 of max|ref|."""
    d = _chmix_data(0)
    names = ("m", "s", "w1", "b1", "w2", "b2")
    if with_skip:
        _, vjp = jax.vjp(lambda x, sk, *a: jchmix._ff_train_skip(
            False, x, sk, *a), d["x"], d["skip"], *(d[k] for k in names))
        dx, dskip, *rest = vjp(d["g"])
        np.testing.assert_array_equal(np.asarray(dskip), np.asarray(d["g"]))
    else:
        _, vjp = jax.vjp(lambda *a: jchmix._ff_train(False, *a),
                         d["x"], *(d[k] for k in names))
        dx, *rest = vjp(d["g"])
    t = lambda k: torch.from_numpy(np.array(d[k]))   # noqa: E731
    out = ops.ln_ff_res_bwd_ref(_flat(d["x"]), *(t(k) for k in names),
                                _flat(d["g"]))
    assert _rel(out[0], _flat(dx)) < 2e-5
    for name, o, r in zip(names, out[1:], rest):
        assert _rel(o, np.asarray(r).reshape(o.shape)) < 2e-5, name


def _s4_cauchy_inputs(H, L):
    """(v, z, w) of a freshly initialised bidirectional S4 kernel: the
    coefficients and nodes the training path gives the Cauchy kernels."""
    kern = SSKernelNPLR(H, N=64, l_max=L, channels=2,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        C = torch.view_as_complex(kern.C)
        P = kern._broadcast(torch.view_as_complex(kern.P), 1)
        B = kern._broadcast(torch.view_as_complex(kern.B), 1)
        v = torch.cat([B, P])[:, None] * torch.cat([C, P.conj()])[None]
        w = kern._w() * kern.log_dt.exp()[:, None]
    return v.numpy(), _fft_nodes(L)[1], w.numpy()


@pytest.mark.parametrize("L,tail", [(1000, None), (16000, 96)])
def test_cauchy_bwd_matches_jax_grad(L, tail):
    """Gradients in v and w of sum |cauchy|^2 through kernels 4 and 8's
    plain versions (the Function on the CPU) vs jax.grad of
    cauchy_sym_pallas (its _bwd_kernel in interpret mode), H = 8: 1e-4 of
    max|ref|.  The L = 16000 case takes the last 96 nodes, which hold the
    Nyquist node (|z| ~ 3e4) where the denominators are largest.  JAX's
    gradient of a real loss in a complex input is the conjugate of
    torch's."""
    v, z, w = _s4_cauchy_inputs(8, L)
    if tail:
        z = z[-tail:]

    def loss(v_, w_):
        return jnp.sum(jnp.abs(cauchy_sym_pallas(v_, jnp.asarray(z), w_))
                       ** 2)
    gv, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(w))
    tv = torch.from_numpy(v).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = ops.cauchy_sym_fused(tv, torch.from_numpy(z), tw)
    (out.abs() ** 2).sum().backward()
    assert _rel(tv.grad.numpy(), np.conj(np.asarray(gv))) < 1e-4
    assert _rel(tw.grad.numpy(), np.conj(np.asarray(gw))) < 1e-4


@pytest.mark.parametrize("L,n,H,B", [(1000, 2048, 8, 2), (500, 1024, 16, 3)])
def test_dkf_matches_jax_fftconv2_dkf(L, n, H, B):
    """Kernel 5's plain version vs the JAX fftconv2_dkf (interpret mode).
    The layouts differ, so both are pulled back to the time-domain kernel
    k (H, n): JAX through the vjp of kernel_spectrum(k, lay), the port
    through the vjp of rfft(k, n).  1e-5 of max|ref|."""
    lay = f2.choose_layout(L, n, H)
    rng = np.random.RandomState(4)
    u = rng.randn(B, H, L).astype(np.float32) * 0.3
    g = rng.randn(B, H, L).astype(np.float32)
    k = rng.randn(H, n).astype(np.float32) * 0.3
    dkfr, dkfi = f2.fftconv2_dkf(f2.to_compact(jnp.asarray(u), lay),
                                 f2.to_compact(jnp.asarray(g), lay), lay,
                                 False)
    _, vjp = jax.vjp(lambda kk: f2.kernel_spectrum(kk, lay), jnp.asarray(k))
    (ref,) = vjp((dkfr, dkfi))
    dkhat = ops.fftconv_dkf(torch.from_numpy(u), torch.from_numpy(g), n)
    assert dkhat.shape == (H, n // 2 + 1) and dkhat.dtype == torch.complex64
    tk = torch.from_numpy(k).requires_grad_(True)
    (dk,) = torch.autograd.grad(torch.fft.rfft(tk, n=n), tk, dkhat)
    assert _rel(dk.numpy(), ref) < 1e-5


def test_conv_and_input_grad_match_jax_fftconv2():
    """Kernel 1's training form and its conjugate-spectrum input gradient
    vs the JAX fftconv2 and its vjp (to_compact / from_compact): 1e-5 of
    max|ref|."""
    L, n, H, B = 1000, 2048, 16, 2
    lay = f2.choose_layout(L, n, H)
    rng = np.random.RandomState(5)
    u = rng.randn(B, H, L).astype(np.float32)
    g = rng.randn(B, H, L).astype(np.float32)
    k = rng.randn(H, n).astype(np.float32) * 0.05
    kfr, kfi = f2.kernel_spectrum(jnp.asarray(k), lay)
    y, vjp = jax.vjp(lambda uu: f2.fftconv2(uu, kfr, kfi, lay, False),
                     f2.to_compact(jnp.asarray(u), lay))
    (du,) = vjp(f2.to_compact(jnp.asarray(g), lay))
    khat = torch.fft.rfft(torch.from_numpy(k), n=n)
    out = ops.fftconv(torch.from_numpy(u), khat)
    dout = ops.fftconv(torch.from_numpy(g), khat, conj=True)
    assert _rel(out.numpy(), f2.from_compact(y, lay, L)) < 1e-5
    assert _rel(dout.numpy(), f2.from_compact(du, lay, L)) < 1e-5


def _function_cases(dtype, small):
    """(name, Function, plain forward, inputs) at f32 test sizes or at tiny
    float64 sizes for gradcheck."""
    rng = np.random.RandomState(7)
    B, H, L, n = (2, 4, 6, 32) if small else (2, 8, 50, 128)

    def t(*s, sc=1.0, shift=0.0):
        return torch.tensor(rng.randn(*s) * sc + shift, dtype=dtype,
                            requires_grad=True)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    khat = torch.fft.rfft(torch.tensor(rng.randn(H, n) * 0.3, dtype=dtype),
                          n=n).requires_grad_(True)
    ff = [t(B, H, L, shift=0.3), t(1, sc=0.1), t(1, sc=0.1, shift=1.2),
          t(2 * H, H, sc=0.3), t(2 * H, sc=0.1), t(H, 2 * H, sc=0.3),
          t(H, sc=0.1)]
    K, M, N, Lz = (2, 3, 4, 5) if small else (6, 8, 16, 40)
    z = torch.tensor(rng.randn(Lz) * 2 + 1j * rng.randn(Lz) * 2, dtype=cdt)
    quad = [t(K, M, N), t(K, M, N), t(M, N, sc=0.5),
            torch.tensor(rng.rand(M, N) + 1.0, dtype=dtype,
                         requires_grad=True)]
    return [
        ("conv", ops.fftconv_train, ops.fftconv_ref,
         [t(B, H, L), khat]),
        ("glu", ops.mix_glu_res_train, ops.glu_res_ref,
         [t(B, H, L), t(B, H, L), t(2 * H, H, sc=0.3), t(2 * H, sc=0.1)]),
        ("ff", ops.ln_ff_res_train, ops.ln_ff_res_ref, ff),
        ("ff_skip", ops.ln_ff_res_train, ops.ln_ff_res_ref,
         ff + [t(B, H, L)]),
        ("cauchy", lambda *a: ops.cauchy._CauchyQuad.apply(*a, z).unbind(-1),
         lambda *a: ops.cauchy_quad_ref(*a, z), quad),
    ]


@pytest.mark.parametrize("case", ["conv", "glu", "ff", "ff_skip", "cauchy"])
def test_function_matches_autograd_of_plain_forward(case):
    """Each Function on CPU tensors (plain forward + the plain backward
    formulas) vs torch autograd of the plain forward, f32: 1e-5 of max|ref|
    per input gradient."""
    name, fn, plain, inputs = next(
        c for c in _function_cases(torch.float32, False) if c[0] == case)
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.RandomState(8)
    cots = [torch.tensor(rng.randn(*o.shape), dtype=o.dtype) for o in outs]
    mine = torch.autograd.grad(outs, inputs, cots)
    ref_outs = plain(*inputs)
    ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
    ref = torch.autograd.grad(ref_outs, inputs, cots)
    for o, r in zip(outs, ref_outs):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert _rel(a.detach().numpy(), b.numpy()) < 1e-5, (name, i)


@pytest.mark.parametrize("case", ["conv", "glu", "ff", "ff_skip", "cauchy"])
def test_function_gradcheck_float64(case):
    """Finite differences in float64 at tiny sizes (the plain backward
    formulas do not depend on the dtype)."""
    _, fn, _, inputs = next(c for c in _function_cases(torch.float64, True)
                            if c[0] == case)
    assert torch.autograd.gradcheck(fn, inputs)


def test_training_wrappers_launch_nothing_on_cpu():
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    for _, fn, _, inputs in _function_cases(torch.float32, False):
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum(o.sum() for o in outs).backward()
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before
