"""Generation runtime: checkpoint -> reverse diffusion -> wav files.

Port of ``diffwave_sashimi_tpu/runtime/generate.py`` for SaShiMi and
WaveNet, unconditional or mel-conditioned, at f32 or bf16 (the shipped
``compute.precision``): resolve ``exp/<run>/checkpoint/<iter>.pkl`` by
``ckpt_iter`` ('max' | int), build SaShiMi's S4 kernels once, run the
T-step sampler in batches, and write
``exp/<run>/waveforms/<iter>/<iter//1000>k_<i>.wav``.  The sampling
time is taken between ``torch.cuda.synchronize()`` calls and reported with
the realtime factor.

``rank`` of ``world`` (JAX's arguments; nothing here starts ranks): the
rank draws from a generator seeded by (seed, rank) and numbers its wavs
from ``n_samples x rank``; rank 0 draws and writes what the single
process does.

Vocoding (``mel_name``): the mel is computed from
``{data_path}/{mel_name}.wav``, or read precomputed from ``mel_path``
(:mod:`..data.mel2samp`); the generated length is frames x hop_length; the
blocks' mel terms are computed once per run; and ``fidelity.json`` beside
the wavs compares rank 0's first sample with the source wav.

``conv_int8`` (``+compute.conv_int8=true``) runs SaShiMi's S4 conv as the
int8 conv, kernel 12 (``ops.FUSED_INT8``), at either precision.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch
from scipy.io import wavfile

from ..config import load_config
from ..data.mel2samp import Mel2Samp, load_mel_file
from ..data.wav import load_wav_float, load_wav_raw
from ..diffusion.sampling import sampling
from ..diffusion.schedule import schedule_from_cfg
from .. import ops as port_ops
from ..models import check_supported, construct_model
from ..utils.audio_metrics import compare
from ..utils.exp import local_directory
from .checkpoint import load_into, load_state_dict, resolve_iter


PROFILE_DIR_TODO = ("compute.profile_dir (a trace of generation) is not "
                    "ported: ROADMAP.md queue 1, item 6")
CKPT_SMOOTH_TODO = ("generate.ckpt_smooth (checkpoint smoothing) is not "
                    "ported: ROADMAP.md queue 1, item 6")


def resolve_device(device=None) -> torch.device:
    """``device``, by default the first card; raises when a card is asked
    for and there is none (the CPU runs only when the caller asks)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run on the CPU")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_condition(dataset_cfg, mel_path: Optional[str],
                      mel_name: Optional[str]):
    """(mel (1, 80, frames) numpy or None, audio_length): the length is
    frames x hop_length when vocoding, else ``segment_length`` (JAX
    runtime/generate.py:94-112)."""
    if mel_name is None:
        return None, int(dataset_cfg["segment_length"])
    if mel_path is not None:
        mel = load_mel_file(os.path.join(mel_path, f"{mel_name}.wav"))
    else:
        ds_cfg = {k: v for k, v in dict(dataset_cfg).items()
                  if k != "_name_"}
        audio, _ = load_wav_raw(os.path.join(dataset_cfg["data_path"],
                                             f"{mel_name}.wav"))
        mel = Mel2Samp(**ds_cfg).get_mel(audio)
    mel = np.asarray(mel, np.float32)[None]
    return mel, mel.shape[-1] * int(dataset_cfg["hop_length"])


def write_fidelity(path: str, ref_wav: str, generated: np.ndarray, sr: int,
                   mel_name: str, ckpt_iter: int) -> dict:
    """The fidelity metrics of ``generated`` (L,) against the source wav,
    written to ``path`` as JSON (non-finite values as null)."""
    ref, _ = load_wav_float(ref_wav)
    n = min(ref.shape[-1], generated.shape[-1])
    m = {k: (float(v) if np.isfinite(v) else None)
         for k, v in compare(ref[:n], generated[:n], sr).items()}
    m.update(mel_name=mel_name, ckpt_iter=ckpt_iter)
    with open(path, "w") as f:
        json.dump(m, f, indent=1)
    return m


@torch.no_grad()
def generate(diffusion_cfg, model_cfg, dataset_cfg, ckpt_iter="max",
             n_samples: int = 1, name: Optional[str] = None,
             batch_size: Optional[int] = None, ckpt_smooth=None,
             mel_path: Optional[str] = None, mel_name: Optional[str] = None,
             seed: int = 0, precision: str = "f32", conv_int8: bool = False,
             device=None, rank: int = 0, world: int = 1) -> np.ndarray:
    """Sample ``n_samples`` waveforms; returns (n_samples, 1, L) numpy.
    ``device`` defaults to the first card (see :func:`resolve_device`).
    ``rank`` of ``world`` sets the seed and the wavs' numbers."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of world {world}")
    check_supported(model_cfg, precision, device_type=torch.device(
        "cuda" if device is None else device).type)
    if conv_int8 and model_cfg["_name_"] != "sashimi":
        raise ValueError("compute.conv_int8 switches SaShiMi's S4 conv; "
                         f"model {model_cfg['_name_']!r} has none")
    if ckpt_smooth is not None:
        raise NotImplementedError(CKPT_SMOOTH_TODO)
    # f32 means f32: no TF32 in the 1x1 convolutions or the plain matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(device)

    local_path, output_directory = local_directory(
        name, model_cfg, diffusion_cfg, dataset_cfg, "waveforms")
    schedule = schedule_from_cfg(diffusion_cfg, fast=True)
    ckpt_path = os.path.join("exp", local_path, "checkpoint")
    ckpt_iter = resolve_iter(ckpt_path, ckpt_iter)
    sd = load_state_dict(ckpt_path, ckpt_iter, model_cfg)
    if sd is None:
        raise FileNotFoundError(
            f"no valid checkpoint at iter {ckpt_iter} in {ckpt_path}")
    # build on the device that runs it: the random init, overwritten by the
    # checkpoint, is the S4 C~ setup's matrix powers, seconds on a CPU
    with torch.device(device):
        model = construct_model(model_cfg, precision)
    load_into(model, sd)
    model.eval()
    output_directory = os.path.join(output_directory, str(ckpt_iter))
    os.makedirs(output_directory, mode=0o775, exist_ok=True)

    mel, audio_length = resolve_condition(dataset_cfg, mel_path, mel_name)
    batch_size = batch_size or n_samples
    if n_samples % batch_size:
        raise ValueError(f"n_samples {n_samples} must be a multiple of "
                         f"batch_size {batch_size}")
    # (seed, rank) -> seed + rank x an odd 32-bit constant: rank 0's is the
    # single process's seed, and the ranks' differ also in the low 32 bits,
    # all that the CPU's generator keeps
    gen = torch.Generator(device=device).manual_seed(seed + rank * 0x9E3779B9)
    ops = port_ops.FUSED_INT8 if conv_int8 else port_ops.FUSED
    shape = (batch_size, 1, audio_length)
    _sync(device)
    t0 = time.perf_counter()
    mel_conds = None if mel is None else model.compute_mel_conds(
        torch.from_numpy(mel).to(device), audio_length)
    _sync(device)
    cond_s = time.perf_counter() - t0
    chunks, secs = [], []
    for _ in range(n_samples // batch_size):
        _sync(device)
        t0 = time.perf_counter()
        x = sampling(model, shape, schedule, device=device, generator=gen,
                     mel_conds=mel_conds, ops=ops)
        _sync(device)
        secs.append(time.perf_counter() - t0)
        chunks.append(x.cpu().numpy())
    generated = np.concatenate(chunks, axis=0)

    sr = int(dataset_cfg["sampling_rate"])
    total = sum(secs)
    print(f"generated {n_samples} samples of {audio_length / sr:.2f}s at "
          f"iteration {ckpt_iter} on {device} at {precision}"
          f"{' with the int8 S4 conv' if conv_int8 else ''} in {total:.3f}s "
          f"({n_samples * audio_length / sr / total:.3f}x realtime, "
          f"{1000 * total / (len(secs) * schedule.T):.3f} ms per sampling "
          f"step at batch {batch_size}; includes building any S4 kernels"
          + ("" if mel is None else f"; the mel terms took {cond_s:.3f}s "
             f"once, before") + ")", flush=True)
    for i in range(n_samples):
        wav = f"{ckpt_iter // 1000}k_{n_samples * rank + i}.wav"
        wavfile.write(os.path.join(output_directory, wav), sr,
                      generated[i, 0].astype(np.float32))
    # the fidelity report compares rank 0's first sample, as in JAX
    ref_wav = None if mel_name is None or rank else os.path.join(
        dataset_cfg["data_path"], f"{mel_name}.wav")
    if ref_wav is not None and os.path.exists(ref_wav):
        try:
            m = write_fidelity(os.path.join(output_directory,
                                            "fidelity.json"),
                               ref_wav, generated[0, 0], sr, mel_name,
                               ckpt_iter)
            print(f"fidelity vs {mel_name}: " + ", ".join(
                f"{k}={v:.4g}" for k, v in m.items()
                if isinstance(v, float)), flush=True)
        except Exception as e:  # metrics must never fail generation
            traceback.print_exc()
            print(f"fidelity metrics skipped: {type(e).__name__}: {e}",
                  flush=True)
    elif ref_wav is not None:
        print(f"no fidelity.json: no source wav at {ref_wav}", flush=True)
    return generated


def main(argv=None):
    """CLI: ``python -m diffwave_sashimi_torch.runtime.generate
    experiment=sc09 generate.n_samples=4`` (bf16, the config's default;
    ``compute.precision=f32`` for f32, ``+compute.conv_int8=true`` for the
    int8 conv), ``experiment=sc09_wavenet``, or vocoding,
    ``experiment=ljspeech generate.mel_name=<wav name>
    dataset.data_path=<dir>`` (Hydra-style overrides of the repository's
    configs/)."""
    cfg = load_config(overrides=list(argv if argv is not None
                                     else sys.argv[1:]))
    if cfg.get_path("compute.profile_dir") is not None:
        raise NotImplementedError(PROFILE_DIR_TODO)
    print(cfg.to_yaml())
    generate(cfg.diffusion, cfg.model, cfg.dataset,
             name=cfg.train.get("name"),
             precision=cfg.get_path("compute.precision", "bf16"),
             conv_int8=bool(cfg.get_path("compute.conv_int8", False)),
             **dict(cfg.generate))


if __name__ == "__main__":
    main()
