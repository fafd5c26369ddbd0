"""CLI: FID + Inception Score for SC09 samples.

Port of ``diffwave_sashimi_tpu/eval/sc09_eval.py``, with the same
sub-commands, flags and one-line JSON output; the classifier runs on the
card unless ``--device cpu`` asks for the CPU.

    # one-time: train the scoring classifier on the REAL dataset
    python -m diffwave_sashimi_torch.eval.sc09_eval train \
        --data <sc09_root> --classifier clf.pkl [--epochs 5]

    # score a directory of generated wavs against the real set
    python -m diffwave_sashimi_torch.eval.sc09_eval score \
        --real <sc09_root> --generated exp/<run>/waveforms/<iter> \
        --classifier clf.pkl [--n 2048]

Prints one JSON line: {"fid": ..., "is": ..., "is_std": ..., ...}.
This is the paper's SC09 quality protocol (arXiv:2202.09729 §4) made
runnable offline; absolute values depend on the classifier checkpoint, so
always compare runs under the same one.  Classifier files are the JAX
package's (``eval_assets/classifier_synth.pkl`` among them).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from . import classifier as clf
from .fid import frechet_distance, gaussian_stats, inception_score
from ..data.wav import load_wav_float

SEG = 16000


def _load_dir(path: str, n: int, seed: int = 0) -> np.ndarray:
    """Up to n wavs from a directory tree, pad/trim to SEG, (N, SEG)."""
    files = sorted(glob.glob(os.path.join(path, "**", "*.wav"),
                             recursive=True))
    files = [f for f in files
             if "_background_noise_" not in f]
    if not files:
        raise FileNotFoundError(f"no wavs under {path}")
    if len(files) > n:
        files = [files[i] for i in
                 np.random.RandomState(seed).choice(len(files), n,
                                                    replace=False)]
    out = np.zeros((len(files), SEG), np.float32)
    for i, f in enumerate(files):
        a, _ = load_wav_float(f)
        m = min(len(a), SEG)
        out[i, :m] = a[:m]
    return out


def score(real: str, generated: str, classifier: str, n: int = 2048,
          batch: int = 64, device=None) -> dict:
    """FID of the generated wavs' features against the real ones', and IS
    of their class probabilities (``device``: the classifier's, by
    default the first card)."""
    model, meta = clf.load_classifier(classifier)
    real_a = _load_dir(real, n)
    gen_a = _load_dir(generated, n)
    _, real_f = clf.extract(model, real_a, batch, device)
    gen_p, gen_f = clf.extract(model, gen_a, batch, device)
    mu_r, sig_r = gaussian_stats(real_f)
    mu_g, sig_g = gaussian_stats(gen_f)
    is_mean, is_std = inception_score(gen_p)
    return {
        "fid": round(frechet_distance(mu_r, sig_r, mu_g, sig_g), 4),
        "is": round(is_mean, 4),
        "is_std": round(is_std, 4),
        "n_real": len(real_a),
        "n_generated": len(gen_a),
        "classifier": classifier,
        "classifier_train_acc": meta.get("acc"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="sc09_eval", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    tr.add_argument("--data", required=True)
    tr.add_argument("--classifier", default="sc09_classifier.pkl")
    tr.add_argument("--epochs", type=int, default=5)
    tr.add_argument("--batch", type=int, default=32)
    sc = sub.add_parser("score")
    sc.add_argument("--real", required=True)
    sc.add_argument("--generated", required=True)
    sc.add_argument("--classifier", required=True)
    sc.add_argument("--n", type=int, default=2048)
    sc.add_argument("--batch", type=int, default=64)
    for p in (tr, sc):
        p.add_argument("--device", default=None,
                       help="torch device of the classifier (default: the "
                            "first card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    if args.cmd == "train":
        r = clf.train_classifier(args.data, args.classifier,
                                 epochs=args.epochs, batch=args.batch,
                                 device=args.device)
        out = {"classifier": args.classifier,
               "final_loss": r.get("loss"), "final_acc": r.get("acc")}
    else:
        out = score(args.real, args.generated, args.classifier,
                    n=args.n, batch=args.batch, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
