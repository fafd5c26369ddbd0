"""Data layer of the port: the unconditional SC09 dataset and loader."""

from .loader import DataLoader, dataloader
from .sc09 import SpeechCommands
from .wav import MAX_WAV_VALUE, load_wav_raw

__all__ = ["DataLoader", "dataloader", "SpeechCommands", "MAX_WAV_VALUE",
           "load_wav_raw"]
