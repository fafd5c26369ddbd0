"""FID/IS of the flagship SaShiMi-DiffWave sampler on the synthetic corpus.

Port of ``scripts/flagship_fid.py`` with its flags and protocol: train
``experiment=sc09`` (at ``--d-model``, 64 by default as in JAX; 128 is the
shipped width) unconditionally on the deterministic synthetic corpus
(:func:`.synth.synth_sc09_corpus`, seed 0) with ``compute.remat=true``,
banking a checkpoint every min(3000, iters) iterations; then score, with
the committed classifier ``eval_assets/classifier_synth.pkl`` against the
corpus (:func:`.sc09_eval.score`):

  * every banked checkpoint at the exact T=200 schedule (the trend);
  * the final checkpoint at DiffWave's 6-step fast schedule
    (:data:`FAST_BETA_6`), aligned (the default) and with the reference's
    raw indices (``align: false``).

``--large-n N`` rescores only the final checkpoint at N samples a schedule
(T200, T6 aligned) and merges a ``final_large_n`` entry into the existing
artifact; ``--t6-only`` rescores only the T6 points into it.  The artifact
is written to ``--out`` under ``--workdir`` (never into ``eval_assets/``).
Training, sampling (at ``generate()``'s default precision, f32, as the JAX
script samples) and scoring run on the card; ``--cpu`` runs them on the
CPU.

    python -m diffwave_sashimi_torch.eval.flagship --d-model 128 \\
        --iters 18000 --workdir <dir>
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "eval_assets")
CLASSIFIER = os.path.join(ASSETS, "classifier_synth.pkl")

# DiffWave's published 6-step fast variance schedule (ref utils.py:133-135).
FAST_BETA_6 = [0.0001, 0.001, 0.01, 0.05, 0.2, 0.5]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="flagship", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--gen-batch", type=int, default=8)
    ap.add_argument("--n-gen", type=int, default=72)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "flagship_fid_ws"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse checkpoints already in workdir")
    ap.add_argument("--override", action="append", default=[],
                    help="extra config overrides (smoke runs)")
    ap.add_argument("--t6-only", action="store_true",
                    help="skip the T200 trend; update only the fast-T6 "
                         "entries of an existing artifact")
    ap.add_argument("--out", default="flagship_fid.json",
                    help="artifact filename under --workdir (e.g. "
                         "flagship_fid_d128.json for the full-width run)")
    ap.add_argument("--large-n", type=int, default=0,
                    help="rescore ONLY the final banked checkpoint, "
                         "generating this many samples per schedule (T200 "
                         "+ aligned T6), and merge a 'final_large_n' entry "
                         "into the existing --out artifact.  Implies "
                         "--skip-train.")
    args = ap.parse_args(argv)
    if args.large_n:
        args.skip_train = True
        args.n_gen = args.large_n
    return args


def main(argv=None) -> dict:
    """Run the protocol; returns the artifact written.  The working
    directory is ``--workdir`` while it runs, and is restored after."""
    args = parse_args(argv)
    cwd = os.getcwd()
    os.makedirs(args.workdir, exist_ok=True)
    os.chdir(args.workdir)
    try:
        return _run(args)
    finally:
        os.chdir(cwd)


def _run(args: argparse.Namespace) -> dict:
    import torch

    from ..config import load_config
    from ..runtime.generate import generate, resolve_device
    from ..runtime.train import train, train_kwargs
    from ..utils.exp import local_directory
    from .sc09_eval import score
    from .synth import synth_sc09_corpus

    device = resolve_device("cpu" if args.cpu else None)
    where = "CPU" if args.cpu else torch.cuda.get_device_name(device)
    t0 = time.time()
    corpus = synth_sc09_corpus(os.path.join(args.workdir, "corpus"))
    overrides = [
        "experiment=sc09", f"model.d_model={args.d_model}",
        f"dataset.data_path={corpus}",
        f"train.n_iters={args.iters}",
        f"train.iters_per_ckpt={min(3000, args.iters)}",  # bank the trend
        "train.iters_per_logging=200",
        f"train.batch_size_per_gpu={args.batch}",
        "generate.n_samples=0",            # no in-training generation
        "mesh.data=1",
        "compute.remat=true",
    ] + list(args.override)
    cfg = load_config(overrides=overrides)
    name = cfg.train.get("name")
    if not args.skip_train:
        train(**train_kwargs(cfg), device=device)
    t_train = time.time() - t0

    run, gen_root = local_directory(name, cfg.model, cfg.diffusion,
                                    cfg.dataset, "waveforms")
    ckpt_dir = os.path.join("exp", run, "checkpoint")
    banked = sorted(int(f[:-4]) for f in os.listdir(ckpt_dir)
                    if f.endswith(".pkl") and f[:-4].isdigit())
    out = os.path.join(args.workdir, args.out)

    def gen_and_score(ckpt_iter, diffusion_cfg, tag):
        """Generate n_gen wavs from one checkpoint, score vs the corpus,
        and move the wav dir aside under ``tag`` so schedules don't mix."""
        generate(diffusion_cfg, cfg.model, cfg.dataset, name=name,
                 ckpt_iter=ckpt_iter, n_samples=args.n_gen,
                 batch_size=args.gen_batch, device=device)
        wav_dir = os.path.join(gen_root, str(ckpt_iter))
        r = score(corpus, wav_dir, CLASSIFIER, n=args.n_gen, device=device)
        dst = wav_dir + "_" + tag
        shutil.rmtree(dst, ignore_errors=True)
        shutil.move(wav_dir, dst)
        print(f"[flagship] iter {ckpt_iter} {tag}: FID {r['fid']} "
              f"IS {r['is']}", flush=True)
        return r

    diff_fast = dict(cfg.diffusion, beta=FAST_BETA_6)
    # Large-n mode: robust headline numbers for the FINAL checkpoint only
    # (single-draw FID at n_gen=72 is high-variance).
    if args.large_n:
        with open(out) as f:
            artifact = json.load(f)
        r = gen_and_score(banked[-1], cfg.diffusion, f"T200n{args.large_n}")
        r6 = gen_and_score(banked[-1], diff_fast,
                           f"T6alignedn{args.large_n}")
        artifact["final_large_n"] = {
            "n": args.large_n, "iter": banked[-1],
            "T200": {"fid": r["fid"], "is": r["is"]},
            "fast_T6_aligned": {"fid": r6["fid"], "is": r6["is"]},
        }
        artifact["wall_s_large_n"] = round(time.time() - t0, 1)
        return _write(out, artifact)

    # 1) exact-schedule trend over every banked checkpoint
    trend = []
    if not args.t6_only:
        for it in banked:
            r = gen_and_score(it, cfg.diffusion, "T200")
            trend.append({"iter": it, "fid": r["fid"], "is": r["is"]})

    # 2) fast T=6 points from the final checkpoint: ALIGNED (the DiffWave
    #    paper's alpha-bar step matching, the default) and the reference's
    #    raw 0..5 indices (align=false), side by side
    r6 = gen_and_score(banked[-1], diff_fast, "T6aligned")
    r6_raw = gen_and_score(banked[-1], dict(diff_fast, align=False), "T6raw")

    prev = {}
    if args.t6_only:
        with open(out) as f:
            prev = json.load(f)
        trend = prev.get("trend_T200", [])
    # start from the previous artifact so auxiliary keys written by other
    # modes (e.g. final_large_n from --large-n) survive a t6-only update
    artifact = dict(prev)
    artifact.update({
        "protocol": "synthetic SC09-style corpus (eval/synth.py seed 0); "
                    "classifier eval_assets/classifier_synth.pkl; "
                    "FID/IS via eval/sc09_eval.score "
                    "(diffwave_sashimi_torch)",
        "model": (f"sashimi d{args.d_model} n{cfg.model['n_layers']} "
                  f"pool(4,4) ({args.iters} iters, {where}, B{args.batch})"),
        "trend_T200": trend,
        "fast_T6_aligned": {"iter": banked[-1], "fid": r6["fid"],
                            "is": r6["is"]},
        "fast_T6_raw_ref_behavior": {"iter": banked[-1],
                                     "fid": r6_raw["fid"],
                                     "is": r6_raw["is"]},
        "n_generated": args.n_gen,
        "train_wall_s": prev.get("train_wall_s", round(t_train, 1)),
        "wall_s": round(time.time() - t0, 1),
    })
    return _write(out, artifact)


def _write(path: str, artifact: dict) -> dict:
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"[flagship] wrote {path}", flush=True)
    print(json.dumps(artifact), flush=True)
    return artifact


if __name__ == "__main__":
    main(sys.argv[1:])
