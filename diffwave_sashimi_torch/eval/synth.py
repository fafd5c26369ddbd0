"""Deterministic synthetic SC09-style corpus for the self-contained
quality loop.

Port of ``diffwave_sashimi_tpu/eval/synth.py``, kept as a copy (the same
draws from ``RandomState(seed)`` in the same order, so the same
``(root, n_per_class, seed)`` writes byte-equal wavs).  The committed
classifier ``eval_assets/classifier_synth.pkl`` was trained on this
corpus, so it is meaningful only against the exact clips this function
regenerates: per-"digit" harmonic tones at class-distinct fundamentals
with mild jitter and noise.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile

SR = 16000
L = 16000
CLASSES = ("zero", "one", "two")


def synth_sc09_corpus(root: str, n_per_class: int = 24,
                      seed: int = 0) -> str:
    """Write a labeled directory tree of synthetic 'digits'; returns root.

    Class ci is a 3-harmonic tone at f0 = 300 + 200*ci Hz with per-clip
    frequency jitter, amplitude envelope, and -40 dB noise — linearly
    separable for a log-mel CNN but non-trivial (the jitter/noise keep
    per-clip features spread, so FID between disjoint splits is small
    but nonzero)."""
    rng = np.random.RandomState(seed)
    t = np.arange(L) / SR
    for ci, label in enumerate(CLASSES):
        d = os.path.join(root, label)
        os.makedirs(d, exist_ok=True)
        f0 = 300 + 200 * ci
        for i in range(n_per_class):
            f = f0 + rng.randn() * 10
            a = np.zeros(L)
            for h, w in ((1, 1.0), (2, 0.5), (3, 0.25)):
                a += w * np.sin(2 * np.pi * f * h * t + rng.rand() * 6.28)
            env = 0.5 + 0.4 * np.sin(2 * np.pi * (2 + rng.rand()) * t)
            a = 0.3 * a * env / np.abs(a).max()
            a = a + 0.003 * rng.randn(L)
            wavfile.write(os.path.join(d, f"s{i}_nohash_0.wav"), SR,
                          (a * 32000).astype(np.int16))
    return root
