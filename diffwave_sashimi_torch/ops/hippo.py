"""HiPPO-LegS NPLR initialisation (numpy, float64, init time only).

Port of the ``legs`` branch of ``diffwave_sashimi_tpu/ops/hippo.py``
(``transition`` -> ``rank_correction`` -> ``nplr`` -> ``combination``),
which is what the SaShiMi S4 layers use.  The other measures (legt,
fourier, diagonal) are not ported yet.  Returned shapes keep half of the
N states (conjugate pairs implied):  w (S, N/2), P (rank, S, N/2),
B (S, N/2), all complex128.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def legs_nplr(N: int, rank: int, S: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(w, P, B) for S copies of the LegS measure with a rank-``rank``
    correction (rows beyond the first are zero)."""
    q = np.arange(N, dtype=np.float64)
    col, row = np.meshgrid(q, q)
    r = 2 * q + 1
    M = -(np.where(row >= col, r, 0) - np.diag(q))
    T = np.sqrt(np.diag(2 * q + 1))
    A = T @ M @ np.linalg.inv(T)
    B = np.diag(T).copy()
    P = np.sqrt(0.5 + q)[None, :]
    if rank > 1:
        P = np.concatenate([P, np.zeros((rank - 1, N))], axis=0)
    AP = A + np.einsum("rn,rm->nm", P, P)

    # AP = cI + skew: diagonalise the skew part with a Hermitian eigensolve
    w_re = np.mean(np.diagonal(AP))
    w_im, V = np.linalg.eigh(AP * -1j)
    w = w_re + 1j * w_im
    idx = np.argsort(w.imag)          # keep one of each conjugate pair
    w = w[idx][: N // 2]
    V = V[:, idx][:, : N // 2]
    V_inv = V.conj().T
    B_half = V_inv @ B.astype(np.complex128)
    P_half = np.einsum("ij,rj->ri", V_inv, P.astype(np.complex128))
    return (np.tile(w, (S, 1)), np.tile(P_half[:, None, :], (1, S, 1)),
            np.tile(B_half, (S, 1)))
