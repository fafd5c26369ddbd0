"""SC09 (SpeechCommands digits) dataset.

Port of ``diffwave_sashimi_tpu/data/sc09.py`` (the reference's
SpeechCommands wrapper): walk ``data_path`` for ``**/*.wav``, keep only
files with ``_nohash_`` in the name, skip the ``_background_noise_``
folder, pad-or-trim every clip from the start to ``segment_length``
samples, scale to [-1, 1], and return ``(waveform (1, L), sample_rate,
label)`` with the label taken from the parent directory name.
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from .wav import MAX_WAV_VALUE, load_wav_raw


class SpeechCommands:
    def __init__(self, data_path: str, segment_length: int = 16000,
                 sampling_rate: int = 16000):
        self.data_path = data_path
        self.segment_length = int(segment_length)
        self.sampling_rate = int(sampling_rate)
        files = sorted(glob.glob(os.path.join(data_path, "**", "*.wav"),
                                 recursive=True))
        self.files: List[Tuple[str, str]] = []
        for f in files:
            label = os.path.basename(os.path.dirname(f))
            if label == "_background_noise_":
                continue
            if "_nohash_" not in os.path.basename(f):
                continue
            self.files.append((f, label))

    def __len__(self) -> int:
        return len(self.files)

    def label(self, idx: int) -> str:
        return self.files[idx][1]

    def __getitem__(self, idx: int):
        path, label = self.files[idx]
        audio, sr = load_wav_raw(path)
        L = self.segment_length
        wav = np.zeros(L, np.float32)
        n = min(len(audio), L)
        wav[:n] = audio[:n] / MAX_WAV_VALUE     # pad-or-trim from the start
        return wav[None, :], sr, label
