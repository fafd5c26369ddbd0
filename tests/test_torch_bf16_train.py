"""Port parity for the bf16 SC09 training path: the plain versions of the
bf16 training kernel forms (kernel 1f's training entry and its conjugate
form, 5f, 6f, 7f) against the JAX package's ``fast=True`` Pallas kernels
run in interpret mode, the polynomial GELU's derivative, and one training
step of the whole ``sashimi_small`` model (d8, n1) at bf16 against
``jax.value_and_grad`` of JAX ``Sashimi(dtype=bfloat16)`` on its flat and
compact paths.  Inputs from numpy seeds; activations rounded to bf16 once,
for both sides.  Tolerances are relative to max |ref| unless stated."""

import numpy as np
import pytest
import torch

from test_torch_common import SMALL_CFG, perturbed

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.sashimi import Sashimi as JaxSashimi
from diffwave_sashimi_tpu.ops import chmix as jchmix
from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.runtime.checkpoint import load_into
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

BF = torch.bfloat16
DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}


def _bf16(x):
    """numpy f32 -> (the same values rounded to bf16: jax array, torch)."""
    t = torch.from_numpy(x).to(BF)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_gelu_fast_grad_matches_jax_and_is_the_derivative():
    """The port's GELU derivative is JAX ``_gelu_fast_grad`` (1e-6: the
    same f32 operations, in another evaluation order at most), and it is
    the derivative of :func:`ops.gelu_fast` (autograd in f64, 1e-9, away
    from the clamp's corners at +-4)."""
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    ref = np.asarray(jchmix._gelu_fast_grad(jnp.asarray(x)))
    out = ops.gelu_fast_grad(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-6
    x64 = torch.from_numpy(x[np.abs(np.abs(x) - 4.0) > 1e-3]).double()
    x64.requires_grad_(True)
    (auto,) = torch.autograd.grad(ops.gelu_fast(x64).sum(), x64)
    assert float((auto - ops.gelu_fast_grad(x64.detach())).abs().max()) <= 1e-9


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("L,n,B,H", [(1000, 2048, 2, 16), (500, 1024, 3, 8)])
def test_conv_train_bf16_matches_jax_fast_kernel(L, n, B, H, conj):
    """Kernel 1f's training entry (plain version) vs the JAX kernel with
    fast=True and no epilogue on its bf16 layout (``_conv2_impl``,
    interpret mode); ``conj`` is the input gradient's form, JAX's call on
    -kfi.  The JAX chain runs in bf16 (conv rel. error ~4e-3,
    ops/fftconv_pallas.py:38-41), the port's in f32, both round the output
    to bf16: max error <= 1.5e-2 of max|ref|, kernel 1f's sampling bar."""
    rng = np.random.RandomState(11)
    u = rng.randn(B, H, L).astype(np.float32)
    k = (0.05 * rng.randn(H, n)).astype(np.float32)
    ju, tu = _bf16(u)
    lay = f2.choose_layout(L, n, H, bf16=True)
    kfr, kfi = f2.kernel_spectrum(jnp.asarray(k), lay)
    yc = f2._conv2_impl(f2.to_compact(ju, lay), kfr, -kfi if conj else kfi,
                        None, lay, True, "none")
    assert yc.dtype == jnp.bfloat16
    ref = _f32(f2.from_compact(yc, lay, L))
    khat = torch.fft.rfft(torch.from_numpy(k), n=n)
    out = ops.fftconv_ref(tu, khat, conj)
    assert out.dtype == BF
    assert _rel(out.float().numpy(), ref) <= 1.5e-2
    assert torch.equal(ops.fftconv(tu, khat, conj), out)
    assert torch.equal(ops.fftconv_bf16(tu, khat, conj), out)


# Kernel 5f vs JAX at bf16: JAX's chain runs its DFT matmuls on bf16
# operands, the port's transforms in f32.  Pulled back to the time-domain
# kernel they differ by 2.0e-3 and 2.5e-3 of max|ref| at these two shapes,
# as much as JAX's fast=True result differs from its own f32 one on the
# same bf16 inputs (the port matches that one to 3e-7).
TOL_DKF_BF16 = 1e-2


@pytest.mark.parametrize("L,n,H,B", [(1000, 2048, 8, 2), (500, 1024, 16, 3)])
def test_dkf_bf16_matches_jax_fast_kernel(L, n, H, B):
    """Kernel 5f's plain version (bf16 u and g, f32 transforms, complex64
    result) vs the JAX fftconv2_dkf with fast=True on its bf16 layout
    (interpret mode).  The layouts differ, so both are pulled back to the
    time-domain kernel k (H, n): JAX through the vjp of
    kernel_spectrum(k, lay), the port through the vjp of rfft(k, n);
    TOL_DKF_BF16 of max|ref|."""
    lay = f2.choose_layout(L, n, H, bf16=True)
    rng = np.random.RandomState(12)
    ju, tu = _bf16((rng.randn(B, H, L) * 0.3).astype(np.float32))
    jg, tg = _bf16(rng.randn(B, H, L).astype(np.float32))
    k = (rng.randn(H, n) * 0.3).astype(np.float32)
    dkfr, dkfi = f2.fftconv2_dkf(f2.to_compact(ju, lay),
                                 f2.to_compact(jg, lay), lay, True)
    _, vjp = jax.vjp(lambda kk: f2.kernel_spectrum(kk, lay), jnp.asarray(k))
    (ref,) = vjp((dkfr, dkfi))
    dkhat = ops.fftconv_dkf_ref(tu, tg, n)
    assert dkhat.shape == (H, n // 2 + 1) and dkhat.dtype == torch.complex64
    tk = torch.from_numpy(k).requires_grad_(True)
    (dk,) = torch.autograd.grad(torch.fft.rfft(tk, n=n), tk, dkhat)
    assert _rel(dk.numpy(), ref) <= TOL_DKF_BF16
    assert torch.equal(ops.fftconv_dkf(tu, tg, n), dkhat)
    assert torch.equal(ops.fftconv_dkf_bf16(tu, tg, n), dkhat)


def _chmix_data(seed, B=2, S=8, H=16, Rc=128):
    """bf16 activations (x, skip, g) in JAX's compact layout and f32
    weights, as (jax dict, port dict); the port's activations flat."""
    rng = np.random.RandomState(seed)

    def f(*s, sc=1.0, shift=0.0):
        return (rng.randn(*s) * sc + shift).astype(np.float32)
    j, t = {}, {}
    for name, a in (("x", f(B, S, H, Rc, sc=0.3, shift=0.1)),
                    ("skip", f(B, S, H, Rc, sc=0.3)), ("g", f(B, S, H, Rc))):
        j[name], tb = _bf16(a)
        t[name] = tb.permute(0, 2, 1, 3).reshape(B, H, S * Rc).contiguous()
    for name, a in (("w", f(2 * H, H, sc=0.3)), ("b", f(2 * H, sc=0.1)),
                    ("w1", f(2 * H, H, sc=0.3)), ("b1", f(2 * H, sc=0.1)),
                    ("w2", f(H, 2 * H, sc=0.3)), ("b2", f(H, sc=0.1)),
                    ("m", np.asarray([0.1], np.float32)),
                    ("s", np.asarray([1.2], np.float32))):
        j[name], t[name] = jnp.asarray(a), torch.from_numpy(a)
    return j, t


def _flat(xc):
    """Compact (B, S, H, Rc) -> flat (B, H, S * Rc) f32 numpy (the
    channel mixes are position-wise)."""
    x = _f32(xc)
    B, S, H, Rc = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B, H, S * Rc)


def _close_to_one_rounding(out, ref):
    """Within about one bf16 rounding of the output: the kernel and its
    plain version sum the f32 products in other orders, so a value near a
    rounding boundary (of the result, or of a bf16 product operand such as
    dz) may land on the neighbouring bf16 value (2^-8 relative)."""
    err = np.abs(out - ref)
    assert (err <= 1e-5 + 2 ** -7 * np.abs(ref)).mean() > 0.999, err.max()
    assert err.max() <= 1e-2 * max(1.0, np.abs(ref).max()), err.max()


# The f32 weight, bias, m and s gradients of 6f and 7f: both sides contract
# the same unrounded f32 operands (dz, xn, the GELU output, g) in other
# orders, and the few bf16 roundings of xn or dz that land the other way
# move dz and dxn there.  Measured on these inputs: 6f dw 4.4e-7, db
# 3.2e-7; 7f dm 6.0e-5, dw2 3.6e-5, dw1 3.0e-5, db1 1.6e-5, ds 8.9e-6, db2
# 3.8e-8 (of max|ref|).
TOL_WGRAD_BF16 = 2e-4


def test_glu_bwd_bf16_matches_jax_glu_train_vjp():
    """Kernel 6f's plain version vs the JAX ``_glu_bwd_kernel`` with
    fast=True (interpret mode) through jax.vjp of ``_glu_train(True,
    ...)`` on bf16 y, residual and cotangent: dy (bf16) within about one
    bf16 rounding, dw and db (f32) to TOL_WGRAD_BF16."""
    j, t = _chmix_data(1)
    _, vjp = jax.vjp(lambda *a: jchmix._glu_train(True, *a),
                     j["x"], j["skip"], j["w"], j["b"])
    dy, dres, dw, db = vjp(j["g"])
    assert dy.dtype == jnp.bfloat16
    out = ops.glu_res_bwd_ref(t["x"], t["w"], t["b"], t["g"])
    assert out[0].dtype == BF and out[1].dtype == out[2].dtype == torch.float32
    _close_to_one_rounding(out[0].float().numpy(), _flat(dy))
    assert _rel(out[1], dw) <= TOL_WGRAD_BF16
    assert _rel(out[2], db) <= TOL_WGRAD_BF16
    np.testing.assert_array_equal(_f32(dres), _f32(j["g"]))
    for fn in (ops.glu_res_bwd, ops.glu_res_bwd_bf16):
        assert all(torch.equal(a, b) for a, b in zip(
            fn(t["x"], t["w"], t["b"], t["g"]), out))


@pytest.mark.parametrize("with_skip,hidden", [
    pytest.param(False, 2, id="False"), pytest.param(True, 2, id="True"),
    pytest.param(False, 1, id="False-F=H")])
def test_ff_bwd_bf16_matches_jax_ff_train_vjp(with_skip, hidden):
    """Kernel 7f's plain version vs the JAX ``_ff_bwd_kernel`` with
    fast=True (interpret mode) through jax.vjp of ``_ff_train(True, ...)``
    / ``_ff_train_skip(True, ...)`` on bf16 x, skip and cotangent: dx
    (bf16) within about one bf16 rounding, dm, ds, dw1, db1, dw2, db2
    (f32) to TOL_WGRAD_BF16; at the shipped hidden width F = 2H and at F
    = H (a config's model.ff 1)."""
    j, t = _chmix_data(0)
    H = t["x"].shape[1]
    for d in (j, t):
        d["w1"], d["b1"] = d["w1"][:hidden * H], d["b1"][:hidden * H]
        d["w2"] = d["w2"][:, :hidden * H]
    t["w2"] = t["w2"].contiguous()
    names = ("m", "s", "w1", "b1", "w2", "b2")
    if with_skip:
        _, vjp = jax.vjp(lambda x, sk, *a: jchmix._ff_train_skip(
            True, x, sk, *a), j["x"], j["skip"], *(j[k] for k in names))
        dx, dskip, *rest = vjp(j["g"])
        np.testing.assert_array_equal(_f32(dskip), _f32(j["g"]))
    else:
        _, vjp = jax.vjp(lambda *a: jchmix._ff_train(True, *a),
                         j["x"], *(j[k] for k in names))
        dx, *rest = vjp(j["g"])
    assert dx.dtype == jnp.bfloat16
    args = (t["x"], *(t[k] for k in names), t["g"])
    out = ops.ln_ff_res_bwd_ref(*args)
    assert out[0].dtype == BF
    _close_to_one_rounding(out[0].float().numpy(), _flat(dx))
    for name, o, r in zip(names, out[1:], rest):
        assert o.dtype == torch.float32, name
        assert _rel(o, _f32(r).reshape(o.shape)) <= TOL_WGRAD_BF16, name
    for fn in (ops.ln_ff_res_bwd, ops.ln_ff_res_bwd_bf16):
        assert all(torch.equal(a, b) for a, b in zip(fn(*args), out))


def test_bf16_training_wrappers_are_their_plain_versions_on_cpu():
    """On CPU tensors the four bf16 training wrappers, and the Functions
    that route to them, run their plain versions and count no launch;
    the Functions' gradients come back in the activations' and the
    parameters' dtypes."""
    _, t = _chmix_data(2, S=2, Rc=64)
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    x, g = t["x"].requires_grad_(True), t["g"]
    khat = torch.fft.rfft(torch.randn(16, 256, generator=torch.Generator()
                                      .manual_seed(0)), n=256)
    khat.requires_grad_(True)
    w = t["w"].requires_grad_(True)
    w1 = t["w1"].requires_grad_(True)
    y = ops.fftconv_train(x, khat)
    y = ops.mix_glu_res_train(y, x, w, t["b"])
    y = ops.ln_ff_res_train(y, t["m"], t["s"], w1, t["b1"], t["w2"],
                            t["b2"], t["skip"])
    assert y.dtype == BF
    (y.float() * g.float()).sum().backward()
    assert x.grad.dtype == BF and khat.grad.dtype == torch.complex64
    assert w.grad.dtype == w1.grad.dtype == torch.float32
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before
    assert {"fftconv_bf16", "fftconv_dkf_bf16", "glu_res_bwd_bf16",
            "ln_ff_res_bwd_bf16"} <= set(ops.COUNTED)


# ---------------------------------------------------------------------------
# One training step of the whole model at bf16.  Distances between two
# gradients are per tensor: |a - b|_2 / |b|_2.  On these inputs JAX's own
# flat and compact bf16 paths differ by a median of 1.0e-2 over the 130
# tensors, 0.33 at the worst (u_layers.1.fc_t.bias: the step bias sums a
# bf16 broadcast over every position), and by 1.8e-2 of the largest
# gradient at the largest single entry; their losses by 3.4e-5 relative.
# The port (either route) is held to twice that against each JAX path:
# median <= 2e-2, every tensor <= 0.66, max entry error <= 3.6e-2 of max
# |ref|, loss <= 4e-4 relative (measured: median 9.5e-3 / 7.2e-3, worst
# 0.13 / 0.32, max entry 4.1e-3 / 1.8e-2, loss 8.9e-5 / 1.2e-4 vs flat /
# compact).  Its bf16 gradients must differ from its own f32 ones by a
# median > 5e-3 (measured 2.7e-2): bf16 really ran.

def _grad_distance(mine, ref):
    """(median, max) over tensors of |a - b|_2 / |b|_2, and the largest
    entry error over max |ref|."""
    per = [float((mine[n] - r).norm() / r.norm()) for n, r in ref.items()]
    worst = max(float((mine[n] - r).abs().max()) for n, r in ref.items())
    scale = max(float(r.abs().max()) for r in ref.values())
    return float(np.median(per)), max(per), worst / scale


@pytest.fixture(scope="module")
def bf16_step(sashimi_small):
    """Shared inputs and the JAX bf16 loss and gradients (port names) of
    one step, on the flat path and on the compact path, with the port's
    own f32 gradients."""
    _, params = sashimi_small
    p = perturbed(params, seed=1)
    jm = JaxSashimi(d_model=8, n_layers=1, pool=(4, 4), expand=2, ff=2,
                    L=16000, dtype=jnp.bfloat16)
    rng = np.random.RandomState(3)
    audio = (0.5 * rng.randn(2, 1, 16000)).astype(np.float32)
    t = np.array([3, 170], np.int32)
    z = rng.randn(2, 1, 16000).astype(np.float32)
    abar = np.asarray(jax_schedule(DIFFUSION).alpha_bar)[t].reshape(2, 1, 1)

    def jax_grads(compact):
        def loss_fn(q):
            x_t = jnp.sqrt(abar) * audio + jnp.sqrt(1.0 - abar) * z
            k = jm.apply(q, 16000, "v2", method=JaxSashimi.compute_kernels) \
                if compact else None
            eps = jm.apply(q, x_t, jnp.asarray(t), None, kernels=k,
                           train=True)
            return jnp.mean((eps.astype(jnp.float32) - z) ** 2)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p)
        grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
        return float(loss), params_from_jax(grads, SMALL_CFG)

    def port(precision, route):
        model = construct_model(SMALL_CFG, precision,
                                generator=torch.Generator().manual_seed(0))
        load_into(model, params_from_jax(p, SMALL_CFG))
        loss = training_loss(model, torch.from_numpy(audio),
                             schedule_from_cfg(DIFFUSION),
                             t=torch.from_numpy(t), z=torch.from_numpy(z),
                             ops=getattr(ops, route))
        loss.backward()
        return loss.item(), {n: q.grad for n, q in model.named_parameters()}
    return {"flat": jax_grads(False), "compact": jax_grads(True),
            "port": port, "f32": port("f32", "FUSED")[1]}


@pytest.mark.parametrize("route", ["FUSED", "PLAIN"])
def test_bf16_train_step_matches_jax_flat_and_compact(bf16_step, route):
    """Loss and every parameter gradient of one bf16 step, through the
    Functions (FUSED: the kernels' plain backward formulas on the CPU) and
    through torch autograd (PLAIN), vs JAX ``Sashimi(dtype=bfloat16)`` on
    both its paths, at the bars stated above the fixture.  init_conv's
    weight_v has an exactly-zero gradient (W = g sign(v)) and is left
    out, as in the f32 test."""
    loss, grads = bf16_step["port"]("bf16", route)
    ref_flat = bf16_step["flat"][1]
    named = {n: g for n, g in grads.items()
             if n != "init_conv.0.conv.weight_v"}
    assert set(ref_flat) == set(grads)
    assert all(g.dtype == torch.float32 for g in grads.values())
    jl_flat, jl_v2 = bf16_step["flat"][0], bf16_step["compact"][0]
    assert abs(jl_flat - jl_v2) <= 1e-4 * jl_flat   # the bar's basis
    for jloss, ref in ((jl_flat, ref_flat), bf16_step["compact"]):
        ref = {n: ref[n].reshape(g.shape) for n, g in named.items()}
        assert abs(loss - jloss) <= 4e-4 * abs(jloss)
        median, most, entry = _grad_distance(named, ref)
        assert median <= 2e-2 and most <= 0.66 and entry <= 3.6e-2, (
            median, most, entry)
    f32 = {n: bf16_step["f32"][n] for n in named}
    assert _grad_distance(named, f32)[0] > 5e-3
