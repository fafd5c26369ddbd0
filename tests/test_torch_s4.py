"""Port parity: the S4 NPLR kernel construction and the layer's kernel
spectrum vs the JAX package, at H = 8, N = 64 and the two L extremes of the
SC09 model (L = 16000 top tier, L = 1000 deepest tier)."""

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)

import jax

from diffwave_sashimi_tpu.models import s4 as js4
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.models import s4 as ts4


def _load(module, tree):
    """Copy a JAX param subtree into a port module by leaf name."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    module.load_state_dict(sd, strict=True)


def _rel(out, ref):
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("L,rank", [(1000, 1), (16000, 1), (1000, 2)])
def test_sskernel_nplr_matches_jax(L, rank):
    """(2, H, L) bidirectional kernel: max error <= 1e-4 of max|ref| (the
    complex64 Cauchy sum, Woodbury and irfft round in another order).
    Rank 3 is not compared: the JAX package's generic-rank einsum raises."""
    jk = js4.SSKernelNPLR(H=8, N=64, l_max=L, channels=2, rank=rank)
    params = jax.jit(jk.init, static_argnums=1)(jax.random.PRNGKey(L), L)
    ref = np.asarray(jax.jit(jk.apply, static_argnums=1)(params, L))
    tk = ts4.SSKernelNPLR(8, N=64, l_max=L, channels=2, rank=rank)
    _load(tk, params["params"])
    with torch.no_grad():
        out = tk(L, ops.PLAIN).numpy()
        fused_cpu = tk(L, ops.FUSED).numpy()
    assert out.shape == ref.shape == (2, 8, L)
    assert _rel(out, ref) < 1e-4
    np.testing.assert_array_equal(fused_cpu, out)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_woodbury_matches_dense_inverse(rank):
    """Each Woodbury branch against r00 - r01 (I + r11)^-1 r10 with a dense
    complex128 inverse per (h, l): max error <= 1e-5 of max|ref|."""
    rng = np.random.RandomState(rank)
    shape = (1 + rank, 2 + rank, 3, 5)
    r = (0.3 * (rng.randn(*shape) + 1j * rng.randn(*shape))).astype(
        np.complex64)
    ref = np.empty((1, 2, 3, 5), np.complex128)
    for h in range(3):
        for l in range(5):
            R = r[:, :, h, l].astype(np.complex128)
            ref[:, :, h, l] = R[:1, :2] - R[:1, 2:] @ np.linalg.inv(
                np.eye(rank) + R[1:, 2:]) @ R[1:, :2]
    out = ts4.woodbury(torch.from_numpy(r), rank).numpy()
    assert _rel(out, ref) < 1e-5


def test_s4_kernel_spectrum_matches_jax():
    """compute_kernel_freq (bidirectional combine at the power-of-two n,
    anticausal taps at the end of the buffer, rfft): max error <= 1e-4 of
    max|ref|."""
    L = 1000
    j = js4.S4(d_model=8, l_max=L, bidirectional=True)
    x = np.zeros((1, 8, L), np.float32)
    params = jax.jit(j.init)(jax.random.PRNGKey(5), x)
    ref = np.asarray(jax.jit(lambda p: j.apply(
        p, L, method=js4.S4.compute_kernel_freq))(params))[0]
    t = ts4.S4(8, l_max=L, bidirectional=True)
    p = params["params"]
    sd = {"D": p["D"], "output_linear.0.weight": p["output_linear"]["w"],
          "output_linear.0.bias": p["output_linear"]["b"]}
    sd.update({f"kernel.kernel.{k}": v for k, v in p["kernel"].items()})
    t.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = t.compute_kernel_freq(L, ops.PLAIN).numpy()
    assert out.shape == ref.shape == (8, 2048 // 2 + 1)
    assert _rel(out, ref) < 1e-4
