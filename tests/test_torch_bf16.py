"""Port parity for the bf16 SC09 sampling path: the plain versions of the
bf16 kernel forms (1f, 2f, 3f) against the JAX package's ``fast=True``
Pallas kernels run in interpret mode, the polynomial GELU, and the whole
``sashimi_small`` model (d8, n1) at bf16 against JAX ``Sashimi(dtype=
bfloat16)`` on its flat and compact paths, alone and in a 3-step sampler.
Inputs from numpy seeds; activations rounded to bf16 once, for both."""

import functools

import numpy as np
import pytest
import torch

from test_torch_common import SMALL_CFG, perturbed, port_model

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.sashimi import Sashimi as JaxSashimi
from diffwave_sashimi_tpu.ops import chmix as jchmix
from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.diffusion.sampling import sampling
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.runtime.checkpoint import load_into
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

BF = torch.bfloat16
FAST3 = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None,
         "fast_steps": 3}


def _bf16(x):
    """numpy f32 -> (the same values rounded to bf16: jax array, torch)."""
    t = torch.from_numpy(x).to(BF)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_gelu_fast_matches_jax():
    """The port's polynomial GELU is the JAX one (1e-6: the same f32
    operations, in another evaluation order at most)."""
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    ref = np.asarray(f2._gelu_fast(jnp.asarray(x)))
    out = ops.gelu_fast(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    assert np.abs(out - ref).max() <= 1e-6


@pytest.mark.parametrize("L,n,B,H", [(1000, 2048, 2, 16), (500, 1024, 3, 8)])
def test_conv_bf16_matches_jax_fast_kernel(L, n, B, H):
    """Plain kernel-1f version vs the JAX kernel with fast=True on its bf16
    layout (``_conv2_impl``, interpret mode).  The JAX chain runs in bf16
    (conv rel. error ~4e-3, ops/fftconv_pallas.py:38-41), the port's in
    f32, and both round the output to bf16: max error <= 1.5e-2 of
    max|ref|."""
    rng = np.random.RandomState(1)
    u = rng.randn(B, H, L).astype(np.float32)
    a = (0.5 + rng.rand(B, L)).astype(np.float32)
    c = (0.3 * rng.randn(B, L)).astype(np.float32)
    bias = (0.3 * rng.randn(B, H)).astype(np.float32)
    k = (0.05 * rng.randn(H, n)).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    ju, tu = _bf16(u)

    lay = f2.choose_layout(L, n, H, bf16=True)
    kfr, kfi = f2.kernel_spectrum(jnp.asarray(k), lay)

    def comp(x):                         # (B, L) -> compact (B, S, Rc)
        return f2.to_compact(jnp.asarray(x)[:, None], lay)[:, :, 0]

    yc = f2._conv2_impl(f2.to_compact(ju, lay), kfr, kfi,
                        jnp.asarray(D).reshape(H // lay.HB, lay.HB, 1), lay,
                        True, "gelu_d", prologue=(comp(a), comp(c),
                                                  jnp.asarray(bias)))
    assert yc.dtype == jnp.bfloat16
    ref = _f32(f2.from_compact(yc, lay, L))

    khat = torch.fft.rfft(torch.from_numpy(k), n=n)
    args = [tu] + [torch.from_numpy(x) for x in (a, c, bias)] + [
        khat, torch.from_numpy(D)]
    out = ops.fftconv_ln_bias_gelu_d_ref(*args)
    assert out.dtype == BF
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 1.5e-2 * np.abs(ref).max(), err
    before = ops.fftconv_ln_bias_gelu_d_bf16.launches
    assert torch.equal(ops.fftconv_ln_bias_gelu_d(*args), out)
    assert torch.equal(ops.fftconv_ln_bias_gelu_d_bf16(*args), out)
    assert ops.fftconv_ln_bias_gelu_d_bf16.launches == before


def _chmix_inputs(B=2, H=16, L=256, F=32, seed=2):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    return dict(y=f(B, H, L), x=f(B, H, L) + 0.5, skip=f(B, H, L),
                w=f(2 * H, H) / 4, b=f(2 * H), w1=f(F, H) / 4, b1=f(F),
                w2=f(H, F) / 6, b2=f(H), m=f(1), s=np.abs(f(1)) + 0.5)


def _compact(x, S=2):
    """(B, H, L) -> the JAX compact (B, S, H, L / S) with t = s Rc + r,
    and back: the channel kernels are position-wise."""
    B, H, L = x.shape
    return jnp.transpose(x.reshape(B, H, S, L // S), (0, 2, 1, 3))


def _flat(xc):
    B, S, H, Rc = xc.shape
    return np.transpose(_f32(xc), (0, 2, 1, 3)).reshape(B, H, S * Rc)


def _full(a):
    return pl.BlockSpec(a.shape, lambda *_: (0,) * a.ndim)


def _io(xc):
    return pl.BlockSpec((1,) + xc.shape[1:], lambda b: (b, 0, 0, 0))


def _close_to_one_rounding(out, ref):
    """Within about one bf16 rounding of the output: the kernel and its
    plain version sum the f32 products in other orders, so a value near a
    rounding boundary may land on the neighbouring bf16 value (2^-8
    relative), and a few such steps may compound through the GELU."""
    err = np.abs(out - ref)
    assert (err <= 1e-5 + 2 ** -7 * np.abs(ref)).mean() > 0.999, err.max()
    assert err.max() <= 1e-2 * max(1.0, np.abs(ref).max()), err.max()


def test_glu_bf16_matches_jax_fast_kernel():
    """Plain kernel-2f version vs JAX ``_glu_kernel`` with fast=True in
    interpret mode (block specs of ``mix_glu_res``)."""
    d = _chmix_inputs()
    jy, ty = _bf16(d["y"])
    jr, tr = _bf16(d["x"])
    yc, rc = _compact(jy), _compact(jr)
    b2 = jnp.asarray(d["b"]).reshape(-1, 1)
    w = jnp.asarray(d["w"])
    ref = pl.pallas_call(
        functools.partial(jchmix._glu_kernel, fast=True),
        grid=(yc.shape[0],),
        in_specs=[_io(yc), _io(rc), _full(w), _full(b2)], out_specs=_io(rc),
        out_shape=jax.ShapeDtypeStruct(rc.shape, rc.dtype),
        interpret=True)(yc, rc, w, b2)
    ref = _flat(ref)
    tw, tb = torch.from_numpy(d["w"]), torch.from_numpy(d["b"])
    out = ops.glu_res_ref(ty, tr, tw, tb)
    assert out.dtype == BF
    _close_to_one_rounding(out.float().numpy(), ref)
    assert torch.equal(ops.mix_glu_res(ty, tr, tw, tb), out)
    assert torch.equal(ops.mix_glu_res_bf16(ty, tr, tw, tb), out)


# (B, H, L, F): the narrow case, a wider one at B > 1 whose L is not a
# multiple of kernel 3f's position tile (P 128 at H 32), and F = H (a
# config's ``model.ff`` 1)
FF_NARROW, FF_WIDE, FF_SQUARE = ((2, 16, 256, 32), (3, 32, 250, 64),
                                 (2, 32, 200, 32))


@pytest.mark.parametrize("with_skip,shape", [
    pytest.param(False, FF_NARROW, id="False"),
    pytest.param(True, FF_NARROW, id="True"),
    pytest.param(False, FF_WIDE, id="False-B3-H32-L250"),
    pytest.param(True, FF_WIDE, id="True-B3-H32-L250"),
    pytest.param(True, FF_SQUARE, id="True-B2-H32-F32-L200")])
def test_ff_bf16_matches_jax_fast_kernel(with_skip, shape):
    """Plain kernel-3f version vs JAX ``_ff_kernel`` with fast=True and
    emit_stats in interpret mode: the output within about one bf16
    rounding; the statistics (f32, of the f32 output before it is
    rounded) to atol 1e-4, rtol 2^-7 (a bf16 rounding of a product's
    operand that lands the other way moves them by about that much)."""
    B, H, L, F = shape
    if shape == FF_WIDE:
        assert L % ops.chmix.ff_bf16_plan(B, H, F, L)[0]
    d = _chmix_inputs(B=B, H=H, L=L, F=F)
    jx, tx = _bf16(d["x"])
    js, ts = _bf16(d["skip"])
    xc, sc = _compact(jx), _compact(js)
    j = {k: jnp.asarray(d[k]) for k in ("w1", "w2")}
    b1c = jnp.asarray(d["b1"]).reshape(-1, 1)
    b2c = jnp.asarray(d["b2"]).reshape(-1, 1)
    ms = jnp.asarray(np.stack([d["m"][0], d["s"][0]]).reshape(2, 1))
    ins = [xc] + ([sc] if with_skip else []) + [j["w1"], b1c, j["w2"], b2c,
                                                 ms]
    st = jax.ShapeDtypeStruct(xc.shape[:2] + xc.shape[3:], jnp.float32)
    st_spec = pl.BlockSpec((1,) + st.shape[1:], lambda b: (b, 0, 0))
    o, mo, vo = pl.pallas_call(
        functools.partial(jchmix._ff_kernel, fast=True, has_skip=with_skip,
                          emit_stats=True),
        grid=(xc.shape[0],),
        in_specs=[_io(xc)] + ([_io(sc)] if with_skip else [])
        + [_full(a) for a in ins[-5:]],
        out_specs=[_io(xc), st_spec, st_spec],
        out_shape=[jax.ShapeDtypeStruct(xc.shape, xc.dtype), st, st],
        interpret=True)(*ins)
    ref = _flat(o)
    B = xc.shape[0]
    ref_m, ref_v = (np.asarray(v).reshape(B, -1) for v in (mo, vo))
    t = {k: torch.from_numpy(d[k]) for k in ("m", "s", "w1", "b1", "w2",
                                             "b2")}
    args = (tx, t["m"], t["s"], t["w1"], t["b1"], t["w2"], t["b2"],
            ts if with_skip else None, True)
    out, mean, var = ops.ln_ff_res_ref(*args)
    assert out.dtype == BF and mean.dtype == var.dtype == torch.float32
    _close_to_one_rounding(out.float().numpy(), ref)
    np.testing.assert_allclose(mean.numpy(), ref_m, atol=1e-4, rtol=2 ** -7)
    np.testing.assert_allclose(var.numpy(), ref_v, atol=1e-4, rtol=2 ** -7)
    for fn in (ops.ln_ff_res, ops.ln_ff_res_bf16):
        got = fn(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, (out, mean, var)))


@pytest.mark.parametrize("H,F,ok", [
    (16, 32, True), (32, 64, True), (128, 256, True), (256, 512, True),
    (512, 1024, True), (128, 128, True), (512, 512, True), (256, 128, True),
    (24, 48, False), (128, 264, False), (0, 32, False), (520, 1040, False),
    (528, 1056, True), (1024, 2048, True), (1040, 2080, False),
    (1024, 4096, False)])
def test_ff_bf16_width_check(H, F, ok):
    """Kernel 3f's width rule, checked without a card: H and F multiples
    of 16, H at most 1024, tiles within one block; every shipped width
    (d_model 128, expand 2, ff 2: H 128, 256, 512) and every tier of
    d_model 256 (H up to 1024) passes, F = H and F < H pass, and a refusal
    names the width."""
    if ok:
        ops.chmix.check_ff_bf16_widths(H, F)
        return
    with pytest.raises(ValueError) as e:
        ops.chmix.check_ff_bf16_widths(H, F)
    assert (f"= {H}" in str(e.value)) or (f"= {F}" in str(e.value))


def _shipped_tiers(experiment, L, B):
    """(B, H, F, L) of each UNet tier of an experiment's shipped model at
    generated length L and batch B."""
    m = load_config(overrides=[f"experiment={experiment}"]).model
    out, H = [], m.d_model
    for i in range(len(m.pool) + 1):
        out.append((B, H, m.ff * H, L))
        if i < len(m.pool):
            H, L = H * m.expand, L // m.pool[i]
    return out


@pytest.mark.parametrize("tier", [
    *_shipped_tiers("sc09", 16000, 4),           # SC09 sampling, B4
    *_shipped_tiers("ljspeech", 143360, 2),      # a 6.5 s utterance, B2
    *_shipped_tiers("ljspeech_harder", 44000, 2)],
    ids=lambda t: "B{}-H{}-F{}-L{}".format(*t))
def test_ff_bf16_plan_fits_shared_memory(tier):
    """Kernel 3f's tile plan on the H100's 132 SMs at every shipped tier:
    its widths pass the check, a block's shared memory is within the 227
    KB a block may use, and where P = 16384 / H below H 512 two blocks fit
    one SM's 228 KB (1 KB reserved a block); a wider P only where the
    grid (ceil(L / P) x B blocks) still fills two waves of one block an
    SM."""
    B, H, F, L = tier
    ops.chmix.check_ff_bf16_widths(H, F)
    P, smem = ops.chmix.ff_bf16_plan(B, H, F, L, sms=132)
    assert P in (32, 64, 128)
    assert smem <= ops.chmix.SMEM_LIMIT == 227 * 1024
    if H * P == 16384 and H < 512:
        assert 2 * (smem + 1024) <= 228 * 1024
    if H * P > 16384:
        assert H > 256 and P == 64 and B * -(-L // P) >= 2 * 132


@pytest.mark.parametrize("H,F", [(16, 16), (128, 64), (128, 128),
                                 (128, 256), (128, 512), (512, 256),
                                 (512, 512), (512, 1024), (1024, 2048),
                                 (1024, 1024), (768, 3072)])
def test_ff_bf16_plan_holds_every_tile(H, F):
    """Kernel 3f's shared memory holds its layout at any accepted F, not
    only F = 2H: 18 P f32 sums and statistics, the H-row bf16 input tile,
    and a region that takes both the F-row bf16 GELU tile and, after it,
    GEMM 2's H-row f32 output tile (rows padded to P + 8); the larger of
    the two sets the region when F != 2H."""
    ops.chmix.check_ff_bf16_widths(H, F)
    for B, L in ((4, 16000), (2, 143360), (1, 100)):
        P, smem = ops.chmix.ff_bf16_plan(B, H, F, L, sms=132)
        head = 18 * P * 4 + H * (P + 8) * 2
        assert smem >= head + F * (P + 8) * 2
        assert smem >= head + H * (P + 8) * 4
        assert smem <= ops.chmix.SMEM_LIMIT


# ---------------------------------------------------------------------------
# The whole model at bf16.  JAX's own flat and compact bf16 paths differ
# from each other by 1.3e-2 (rms, relative) on these inputs, and each from
# its f32 path by as much; the port is held to the same: rms <= 2e-2 and
# max <= 4e-2 of max|ref| against each, and it must differ from its own
# f32 eps (bf16 really ran).

def _rms(out, ref):
    return float(np.sqrt(((out - ref) ** 2).mean() / (ref ** 2).mean()))


@pytest.fixture(scope="module")
def small_bf16(sashimi_small):
    """(JAX bf16 model, perturbed params, port bf16 model, port f32)."""
    _, params = sashimi_small
    p = perturbed(params)
    jm = JaxSashimi(d_model=8, n_layers=1, pool=(4, 4), expand=2, ff=2,
                    L=16000, dtype=jnp.bfloat16)
    tm = construct_model(SMALL_CFG, "bf16",
                         generator=torch.Generator().manual_seed(0))
    load_into(tm, params_from_jax(p, SMALL_CFG))
    return jm, p, tm.eval(), port_model(p)


def test_bf16_eps_matches_jax_flat_and_compact_paths(small_bf16):
    jm, p, tm, tm32 = small_bf16
    rng = np.random.RandomState(0)
    audio = (0.5 * rng.randn(2, 1, 16000)).astype(np.float32)
    steps = np.array([7.0, 100.5], np.float32)
    ref_flat = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(audio),
                                            jnp.asarray(steps)))
    kernels = jax.jit(lambda q: jm.apply(
        q, 16000, "v2", method=JaxSashimi.compute_kernels))(p)
    ref_v2 = np.asarray(jax.jit(lambda q, a, s, k: jm.apply(
        q, a, s, kernels=k))(p, jnp.asarray(audio), jnp.asarray(steps),
                             kernels))
    with torch.no_grad():
        out = tm(torch.from_numpy(audio), torch.from_numpy(steps))
        out32 = tm32(torch.from_numpy(audio), torch.from_numpy(steps))
    assert out.dtype == torch.float32 and ref_flat.dtype == np.float32
    out = out.numpy()
    for ref in (ref_flat, ref_v2):
        assert _rms(out, ref) <= 2e-2, _rms(out, ref)
        assert np.abs(out - ref).max() <= 4e-2 * np.abs(ref).max()
    assert _rms(out, out32.numpy()) > 1e-3


def test_bf16_sampler_matches_jax_loop_with_injected_noise(small_bf16):
    """3 aligned fast steps at bf16 with one shared noise stack (x_t f32,
    eps cast to f32, as diffusion/sampling.py:100): x_0 rms <= 2e-2 and
    max <= 4e-2 of max|ref|, the eps bar (the update adds eps at most
    (1 - alpha) / sqrt(1 - abar) / sqrt(alpha) per step)."""
    jm, p, tm, _ = small_bf16
    apply = jax.jit(jm.apply)
    js = jax_schedule(FAST3, fast=True)
    a, ab, sg, te = (np.asarray(r) for r in
                     (js.alpha, js.alpha_bar, js.sigma, js.t_embed))
    shape = (2, 1, 16000)
    noise = np.random.RandomState(7).randn(js.T + 1, *shape).astype(
        np.float32)
    x = noise[0]
    for i, t in enumerate(range(js.T - 1, -1, -1)):
        eps = np.asarray(apply(p, jnp.asarray(x),
                               jnp.full((2,), te[t], jnp.float32)),
                         np.float32)
        x = (x - (1.0 - a[t]) / np.sqrt(1.0 - ab[t]) * eps) / np.sqrt(a[t])
        if t > 0:
            x = x + sg[t] * noise[i + 1]
    out = sampling(tm, shape, schedule_from_cfg(FAST3, fast=True),
                   noise=torch.from_numpy(noise))
    assert out.dtype == torch.float32
    out = out.numpy()
    assert _rms(out, x) <= 2e-2, _rms(out, x)
    assert np.abs(out - x).max() <= 4e-2 * np.abs(x).max()
