"""NPLR state-space discretisation (complex64, init time only).

Port of ``diffwave_sashimi_tpu/ops/nplr.py``: :func:`discretize` (bilinear
dA, dB of A = diag(w) - P Q^*), :func:`matrix_power`, :func:`setup_C`
(the train-length transform C~ = (I - dA^L)^* C, applied when a fresh
model is built) and :func:`power_contract`.  The JAX package pins these
contractions to full f32 precision because the repeated squarings amplify
rounding; torch matmuls here run in full complex64 (TF32 does not apply on
the CPU, where the model is built).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _conj(x: torch.Tensor) -> torch.Tensor:
    """Append the conjugate half: (..., N) -> (..., 2N)."""
    return torch.cat([x, x.conj()], dim=-1)


def discretize(w, P, B, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: (H, N), P: (R, H, N), B: (H, N) complex; dt: (H,) real.
    Returns dA (H, 2N, 2N) and dB (H, 2N), conjugate-expanded."""
    rank = P.shape[0]
    Q = P.conj()
    D = 1.0 / (2.0 / dt[:, None] - w)
    E = 2.0 / dt[:, None] + w
    eye_r = torch.eye(rank, dtype=w.dtype, device=w.device)
    R_mat = eye_r + 2.0 * torch.einsum("rhn,hn,shn->hrs", Q, D, P).real.to(
        w.dtype)
    QD = torch.einsum("rhn,hn->hrn", Q, D)
    Rs = QD / R_mat[..., :1] if rank == 1 else torch.linalg.solve(R_mat, QD)
    Rs = Rs.movedim(0, 1)                                   # (R, H, N)
    Pc, Qc, Rc = _conj(P), _conj(Q), _conj(Rs)
    Dc, Ec, Bc = _conj(D), _conj(E), _conj(B)

    def linear_step(state, u):
        ns = Ec * state - torch.einsum("rhn,rhm,...hm->...hn", Pc, Qc, state)
        ns = ns + 2.0 * Bc * u[:, None]
        return Dc * (ns - torch.einsum("rhn,rhm,...hm->...hn", Pc, Rc, ns))

    H, N = w.shape
    eye = torch.eye(2 * N, dtype=w.dtype, device=w.device)[:, None, :]
    dA = linear_step(eye, torch.zeros(H, dtype=w.dtype, device=w.device))
    dA = dA.permute(1, 2, 0)                                # (H, m, n)
    dB = linear_step(torch.zeros(1, H, 2 * N, dtype=w.dtype, device=w.device),
                     torch.ones(H, dtype=w.dtype, device=w.device))[0]
    return dA, dB


def matrix_power(L: int, A: torch.Tensor) -> torch.Tensor:
    """A^L for (..., N, N) by binary exponentiation."""
    out = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    base, l = A, L
    while l > 0:
        if l % 2 == 1:
            out = base @ out
        l //= 2
        if l > 0:
            base = base @ base
    return out


def power_contract(L: int, A: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A^L, sum_i A^i v[..., i]) by reverse divide and conquer.
    A: (..., N, N); v: (..., N, L)."""
    I = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    powers = [A]
    l_rem, l = L, 1
    while True:
        if l_rem % 2 == 1:
            I = powers[-1] @ I
        l_rem //= 2
        if l_rem == 0:
            break
        l *= 2
        powers.append(powers[-1] @ powers[-1])
    k = v.shape[-1] - l
    if k > 0:
        v_tail = powers[-1] @ v[..., l:]
        v = v[..., :l].clone()
        v[..., :k] += v_tail
    powers.pop()
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v.reshape(v.shape[:-1] + (2, half))
        v = v[..., 0, :] + powers.pop() @ v[..., 1, :]
    return I, v[..., 0]


def setup_C(C: torch.Tensor, dA: torch.Tensor, L: int) -> torch.Tensor:
    """C~ = C - (dA^L)^T C on the conjugate-expanded C; C (c, H, N)."""
    dA_L = matrix_power(L, dA)
    C_full = _conj(C)
    prod = torch.einsum("hmn,chn->chm", dA_L.transpose(-1, -2), C_full)
    return (C_full - prod)[..., : C.shape[-1]]
