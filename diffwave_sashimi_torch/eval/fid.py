"""Frechet distance and Inception Score for SC09 sample evaluation.

Port of ``diffwave_sashimi_tpu/eval/fid.py``, kept as a copy (float64
numpy, the same operations in the same order, so the same features give
the same bits): the metric math of the SaShiMi paper's SC09 protocol
(arXiv:2202.09729 §4); :mod:`.classifier` gives the features and class
probabilities they are computed from."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) feature matrix -> (mean (D,), covariance (D, D))."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via
    eigendecomposition — no scipy.linalg.sqrtm (keeps the dependency
    surface at numpy and avoids its complex-drift warnings)."""
    w, v = np.linalg.eigh((a + a.T) / 2)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FID(N(mu1, sig1), N(mu2, sig2)) = |mu1-mu2|^2 +
    Tr(sig1 + sig2 - 2 (sig1 sig2)^{1/2})."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    # stabilized product sqrt: sqrt(s1) s2 sqrt(s1) is symmetric PSD and has
    # the same eigenvalues as s1 s2
    s1h = _sqrtm_psd(sigma1 + eps * np.eye(len(mu1)))
    inner = _sqrtm_psd(s1h @ (sigma2 + eps * np.eye(len(mu2))) @ s1h)
    val = float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                - 2.0 * np.trace(inner))
    return max(val, 0.0)   # eps regularization can leave ~1e-5 negative


def inception_score(probs: np.ndarray, splits: int = 10,
                    eps: float = 1e-12) -> Tuple[float, float]:
    """IS over class probabilities (N, C):
    exp(E_x KL(p(y|x) || p(y))), mean +- std over ``splits`` folds."""
    probs = np.asarray(probs, np.float64)
    n = len(probs)
    splits = max(1, min(splits, n))
    scores = []
    for part in np.array_split(probs, splits):
        py = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + eps) - np.log(py + eps))).sum(axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


__all__ = ["gaussian_stats", "frechet_distance", "inception_score"]
