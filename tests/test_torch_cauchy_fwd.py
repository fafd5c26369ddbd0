"""Kernel 4's design (csrc/cauchy.cu::cauchy_fwd_kernel<K>), checked
without a card: its plan (``ops.cauchy.cauchy_fwd_plan``) at every shape
the shipped paths launch it at and off them, and its refusals; a plain
torch model of the kernel's schedule (each thread's P positions, the
records of [c, d, a_k, b_k] padded to float4s, the fixed order over n, the
power-of-two scale with one reciprocal, the G1 form) against the plain
version ``cauchy_quad_ref``, a complex128 evaluation and the JAX
``_cauchy_quad`` forward (its ``_fwd_kernel`` in interpret mode), on the
coefficients and nodes of a freshly initialised S4 kernel; the wrapper's
launch arguments (one (K, M, Lz, 2) output); that the S4 kernel
construction reads that output with no copy; on CPU tensors the wrapper is
its plain version.  Tolerances are on the max error relative to the max
|reference|."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)

import jax.numpy as jnp

from diffwave_sashimi_tpu.ops.cauchy_pallas import _cauchy_quad
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.models.s4 import SSKernelNPLR, _fft_nodes
from diffwave_sashimi_torch.ops import cauchy as cq
from diffwave_sashimi_torch.ops import cuda_lib
from test_torch_cauchy_bwd import (_card_inputs, _pow2_inverse, _s4_inputs,
                                   _shipped_shapes)

SMS = 132                       # an H100 SXM's SMs
RAGGED = [(3, 6, 20, 777), (8, 5, 32, 1001), (1, 4, 7, 65), (6, 16, 64, 501)]


def _covers(plan, Lz):
    span = plan.threads * cq.FWD_P
    return (plan.threads % 32 == 0 and 32 <= plan.threads <= cq.FWD_THREADS
            and (plan.splits - 1) * span < Lz <= plan.splits * span)


@pytest.mark.parametrize("shape", _shipped_shapes())
def test_plan_at_every_shipped_shape(shape):
    """At every shipped shape a block is FWD_THREADS threads of FWD_P
    positions, the blocks cover [0, Lz) with no empty one, every SM gets
    at least two blocks, and the shared memory is the channel's 32
    records of 4 float4s (K 6)."""
    K, M, N, Lz = shape
    plan = cq.cauchy_fwd_plan(K, M, N, Lz, SMS)
    assert plan == (cq.FWD_THREADS,
                    math.ceil(Lz / (cq.FWD_THREADS * cq.FWD_P)), 2048)
    assert _covers(plan, Lz)
    assert M * plan.splits >= 2 * SMS


@pytest.mark.parametrize("shape", RAGGED)
def test_plan_at_ragged_shapes(shape):
    """Off the shipped shapes (odd K, K 8, N below and above 32, lengths
    that fill no block): the blocks cover [0, Lz) with no empty one, and
    give every SM two blocks as far as the positions allow (a block holds
    at least one warp)."""
    K, M, N, Lz = shape
    plan = cq.cauchy_fwd_plan(K, M, N, Lz, SMS)
    P = cq.FWD_P
    assert _covers(plan, Lz)
    assert M * plan.splits >= min(2 * SMS, M * math.ceil(Lz / (32 * P)))
    assert plan.smem == N * math.ceil((2 * K + 2) / 4) * 16


@pytest.mark.parametrize("K,N,what", [(0, 32, "K 0"), (9, 32, "K 9"),
                                      (6, 0, "N 0"), (6, 3633, "N 3633")])
def test_plan_refuses_by_name(K, N, what):
    """K outside 1-8 has no instance; N records past one block's shared
    memory (3632 states at K 6) do not fit."""
    with pytest.raises(ValueError, match=f"kernel 4 .*{what}"):
        cq.cauchy_fwd_plan(K, 128, N, 8001, SMS)


def test_source_constants_are_the_plans():
    """The plan's constants are the kernel's (csrc/cauchy.cu): its most
    threads a block (its __launch_bounds__, with one block an SM, so that
    ptxas keeps every sum in registers), its positions a thread, KMAX, the
    shared memory a block may use, the K instances the entry point
    dispatches to, and the record's float4s."""
    src = (Path(cq.__file__).parents[1] / "csrc" / "cauchy.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["FWD_THREADS"] == cq.FWD_THREADS
    assert const["FWD_P"] == cq.FWD_P
    assert const["KMAX"] == cq.FWD_KMAX
    assert const["FWD_SMEM_MAX"] == cq.FWD_SMEM_MAX
    assert re.search(
        r"__launch_bounds__\(FWD_THREADS, 1\)\s*cauchy_fwd_kernel", src)
    assert [int(k) for k in re.findall(r"DWST_FWD_CASE\((\d+)\)", src)] \
        == list(range(1, cq.FWD_KMAX + 1))
    assert "return (2 * K + 2 + 3) / 4;" in src
    assert "atomicAdd" not in src


# ---- a plain torch model of the kernel's schedule ------------------------

def schedule_model(a, b, c, d, z, plan):
    """What cauchy_fwd_kernel<K> computes, in f32 torch ops in the
    kernel's order (products and sums rounded apart where the kernel fuses
    them): block (s, m)'s thread t owns positions l = s T P + t + j T,
    j < P (T threads a block), each with z and z^2 held, and walks the
    channel's records n = 0..N-1 (each [c, d, a_0.., b_0..] padded to
    float4s), adding a_k G1 + b_k G0 to its 2K sums.  Positions past Lz
    run on z = 0 and are not stored.  Returns the (K, M, Lz, 2) output."""
    K, M, N = a.shape
    Lz, T, P, S = z.shape[0], plan.threads, cq.FWD_P, plan.splits
    R = 4 * ((2 * K + 2 + 3) // 4)
    rec = torch.zeros(M, N, R)
    rec[..., 0], rec[..., 1] = c, d
    rec[..., 2:2 + K] = a.permute(1, 2, 0)
    rec[..., 2 + K:2 + 2 * K] = b.permute(1, 2, 0)
    l = (torch.arange(S)[:, None, None] * T * P
         + torch.arange(T)[None, :, None]
         + torch.arange(P)[None, None, :] * T).flatten()     # (S T P,)
    ok = l < Lz
    zl = torch.where(ok, z[l.clamp(max=Lz - 1)],
                     torch.zeros((), dtype=z.dtype))
    zr, zi = zl.real.contiguous(), zl.imag.contiguous()
    z2r, z2i = zr * zr - zi * zi, 2.0 * zr * zi
    accr = torch.zeros(K, M, l.shape[0])
    acci = torch.zeros(K, M, l.shape[0])
    for n in range(N):
        q = rec[:, n, :, None]                                 # (M, R, 1)
        cn, dn = q[:, 0], q[:, 1]
        den_r = z2r + cn * zr + dn
        den_i = z2i + cn * zi
        s = _pow2_inverse(torch.maximum(den_r.abs(), den_i.abs()))
        sr, si = den_r * s, den_i * s
        t = (1.0 / (sr * sr + si * si)) * s
        g0r, g0i = sr * t, -si * t
        g1r, g1i = zr * g0r - zi * g0i, zr * g0i + zi * g0r
        for k in range(K):
            ak, bk = q[:, 2 + k], q[:, 2 + K + k]
            accr[k] = accr[k] + ak * g1r + bk * g0r
            acci[k] = acci[k] + ak * g1i + bk * g0i
    out = torch.full((K, M, Lz, 2), float("nan"))
    out[:, :, l[ok], 0] = accr[:, :, ok]
    out[:, :, l[ok], 1] = acci[:, :, ok]
    return out


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def _references(a, b, c, d, z):
    """(cauchy_quad_ref, complex128, JAX _cauchy_quad forward), each as a
    (K, M, Lz, 2) array."""
    plain = torch.stack(ops.cauchy_quad_ref(a, b, c, d, z), -1)
    wide = torch.stack(ops.cauchy_quad_ref(
        *(t.double() for t in (a, b, c, d)), z.to(torch.complex128)), -1)
    j = lambda t: jnp.asarray(t.numpy())                      # noqa: E731
    jre, jim = _cauchy_quad(j(a), j(b), j(c), j(d), j(z.real.contiguous()),
                            j(z.imag.contiguous()))
    return plain, wide, np.stack([np.asarray(jre), np.asarray(jim)], -1)


CASES = [(1000, None), (4000, None), (16000, 96)]       # Lz 501, 2001, tail


@pytest.mark.parametrize("L,tail", CASES, ids=["Lz501", "Lz2001", "nyquist"])
def test_schedule_model_matches_plain_complex128_and_jax(L, tail):
    """The schedule model at H 8 (K 6, N 32) on a fresh S4 kernel's
    coefficients vs cauchy_quad_ref (complex64), a complex128 evaluation
    and the JAX forward kernel in interpret mode: 1e-4 of max|ref|.  The
    Nyquist case's last node has |z| > 1e4, where |den|^2 would leave the
    f32 range without the scaling."""
    a, b, c, d, z, _, _ = _s4_inputs(8, L, tail)
    out = schedule_model(a, b, c, d, z, cq.cauchy_fwd_plan(6, 8, 32,
                                                           z.shape[0], SMS))
    assert torch.isfinite(out).all()
    for ref in _references(a, b, c, d, z):
        assert _rel(out, ref) < 1e-4
    if tail:
        assert float(z.abs().max()) > 1e4


@pytest.mark.parametrize("K,M,N,Lz", RAGGED)
def test_schedule_model_at_ragged_shapes(K, M, N, Lz):
    """Off the shipped shapes (odd K, K 8, N 7 to 64, lengths that fill no
    block), on seeded residues over an S4 kernel's eigenvalues, at the
    plan's launch: the schedule model vs cauchy_quad_ref and complex128,
    1e-4 of max|ref|; every position written once."""
    L = 2 * (Lz - 1)
    kern = SSKernelNPLR(M, N=2 * N, l_max=L, channels=1,
                        generator=torch.Generator().manual_seed(K))
    rng = np.random.RandomState(K + M)
    with torch.no_grad():
        w = kern.cauchy_operands()[1]
    v = torch.from_numpy((rng.randn(K, M, N) + 1j * rng.randn(K, M, N))
                         .astype(np.complex64))
    a, b, c, d = cq.quad_operands(v, w)
    z = torch.from_numpy(_fft_nodes(L)[1])
    out = schedule_model(a, b, c, d, z, cq.cauchy_fwd_plan(K, M, N, Lz, SMS))
    assert torch.isfinite(out).all()
    plain = torch.stack(ops.cauchy_quad_ref(a, b, c, d, z), -1)
    wide = torch.stack(ops.cauchy_quad_ref(
        *(t.double() for t in (a, b, c, d)), z.to(torch.complex128)), -1)
    assert _rel(out, plain) < 1e-4 and _rel(out, wide) < 1e-4


# ---- the wrapper ---------------------------------------------------------

@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: SMS)
    return calls


@pytest.mark.parametrize("shape", _shipped_shapes()[:3] + RAGGED[:1])
def test_wrapper_launch_arguments(launches, shape):
    """The wrapper allocates one float32 (K, M, Lz, 2) output, passes its
    address, hands over exactly the ctypes signature's arguments with the
    plan last, and counts one launch."""
    K, M, N, Lz = shape
    before = cq.cauchy_quad.launches
    out = cq.cauchy_quad(*_card_inputs(K, M, N, Lz))
    assert cq.cauchy_quad.launches == before + 1
    (name, args), = launches
    assert name == "dwst_cauchy"
    sig = cuda_lib._SIGNATURES[name]
    assert len(args) + 1 == len(sig)
    for x, t in zip(args, sig):
        assert isinstance(x, int) and (t is cuda_lib._P or abs(x) < 2 ** 31)
    assert out.shape == (K, M, Lz, 2) and out.dtype == torch.float32
    assert out.is_contiguous() and args[5] == out.data_ptr()
    assert args[6:] == (K, M, N, Lz, *cq.cauchy_fwd_plan(K, M, N, Lz, SMS))


@pytest.mark.parametrize("K,N,what", [(9, 32, "K 9"), (2, 8000, "N 8000")])
def test_wrapper_refuses_before_any_launch(launches, K, N, what):
    before = cq.cauchy_quad.launches
    with pytest.raises(ValueError, match=f"kernel 4 .*{what}"):
        cq.cauchy_quad(*_card_inputs(K, 4, N, 96))
    assert launches == [] and cq.cauchy_quad.launches == before


def test_wrapper_is_its_plain_version_on_cpu():
    """On CPU tensors the wrapper returns cauchy_quad_ref's results bit for
    bit, as one (K, M, Lz, 2) tensor, and counts no launch."""
    a, b, c, d, z, _, _ = _s4_inputs(4, 1000, seed=7)
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    out = ops.cauchy_quad(a, b, c, d, z)
    re_, im_ = ops.cauchy_quad_ref(a, b, c, d, z)
    assert out.shape == (*re_.shape, 2)
    assert torch.equal(out[..., 0], re_) and torch.equal(out[..., 1], im_)
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before


@pytest.mark.parametrize("grad", [True, False], ids=["train", "sample"])
def test_kernel_construction_reads_the_output_in_place(monkeypatch, grad):
    """The tensor that ``SSKernelNPLR.forward`` multiplies by dt (what its
    ``ops.cauchy`` returns) is a view of the very tensor kernel 4's
    wrapper returned: the same storage and address, no copy, under
    autograd (training) and without (sampling)."""
    returned, used, quad = [], [], cq.cauchy_quad

    def spy_quad(*args):
        returned.append(quad(*args))
        return returned[-1]

    def spy_sym(v, z, w):
        r = cq.cauchy_sym_fused(v, z, w)
        used.append(r)
        return r
    monkeypatch.setattr(cq, "cauchy_quad", spy_quad)
    kern = SSKernelNPLR(4, N=64, l_max=256, channels=2,
                        generator=torch.Generator().manual_seed(1))
    with torch.set_grad_enabled(grad):
        k = kern(256, ops.FUSED._replace(cauchy=spy_sym))
    (out,), (r,) = returned, used
    assert r.is_complex() and r.shape == (2, 3, 4, 129)
    assert r.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
    assert r.data_ptr() == out.data_ptr()
    assert torch.equal(torch.view_as_real(r).reshape(out.shape), out)
    if grad:
        k.pow(2).sum().backward()
        assert kern.log_dt.grad is not None
