"""Data layer of the port: the SC09 and LJSpeech (``mel2samp``) datasets
and their loader.  The vocoder's mel front end lives in ``stft`` and
``mel2samp``; the latter is also a CLI (``python -m``), so this package
does not import it."""

from .loader import DataLoader, dataloader
from .sc09 import SpeechCommands
from .wav import MAX_WAV_VALUE, load_wav_float, load_wav_raw

__all__ = ["DataLoader", "dataloader", "SpeechCommands", "MAX_WAV_VALUE",
           "load_wav_float", "load_wav_raw"]
