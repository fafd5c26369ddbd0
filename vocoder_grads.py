#!/usr/bin/env python3
"""How far the vocoder's bf16 training gradients through the kernels lie
from the plain bf16 path's, beside how far the plain bf16 path lies from
f32, tensor by tensor.

    python3 vocoder_grads.py [--harder] [SEED ...]   # repository root, one GPU

chip_smoke.py's phase 25 holds one training step of the seeded
``experiment=ljspeech`` model at full width and depth (B4, L 16000, a
seeded mel) with the kernels (ops.FUSED) against the plain versions
(ops.PLAIN), at f32 and at bf16. This script runs that step at each
seed (by default chip_smoke.py's two, SEED + 31 and SEED + 33, and
SEED + 34 to SEED + 36). For every parameter tensor it records three
relative L2 distances:

- ``err``: kernels vs plain at bf16;
- ``own``: the plain bf16 path vs the plain f32 path;
- ``vs_f32``: the kernels at bf16 vs the plain f32 path.

Each scalar gradient is a sum over every position: the mel upsampler's
``weight_g`` and ``bias``, TransposedLN's ``m`` and ``s``, and the output
conv's ``bias``. For each mel upsampler stage, with W = g v / |v|, the script
also records the gradient of the effective weight W:
dW = dg v/|v| + (|v| / g) dv. A scalar's error |d(dg)| is bounded by
|d(dW)|, so ``cs`` is the scalar's absolute error over |dW|: the
per-tensor bar applied to the layer's weight gradient in the direction
the scalar sees. Each kind of scalar across the blocks (the parameter's
name without its block, as ``norm2.m``) is also stacked into one tensor,
``group:<name>``, and its three distances recorded. The output is one
JSON line per seed with the tensors whose ``err`` passes 0.05, every
scalar, every group and every stage's effective weight, then a summary
by kind and the card's name and power limit. The whole record goes to
``chiprun_out/vocoder_grads.json``. ``--harder`` runs phase 26's step
instead: ``experiment=ljspeech_harder`` (B2, L 44000) at its gradient
check's depth, n_layers 2 (``vocoder_grads_harder.json``).
"""

import json
import os
import re
import subprocess
import sys

import torch

import chip_smoke as cs

SEEDS = (cs.SEED + 31, cs.SEED + 33, cs.SEED + 34, cs.SEED + 35,
         cs.SEED + 36)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def effective_weight_grads(model, grads):
    """{stage prefix: dW} of every mel upsampler stage (W = g v / |v|)."""
    params = dict(model.named_parameters())
    out = {}
    for name in grads:
        if not (".upsample_conv2d." in name and name.endswith("weight_g")):
            continue
        pre = name[:-len("weight_g")]
        v, g = params[pre + "weight_v"].detach(), params[name].detach()
        vn = v.norm()
        out[pre] = grads[name] * v / vn + (vn / g) * grads[pre + "weight_v"]
    return out


def kind(name):
    """A scalar gradient's kind: ``upsample_weight_g``, ``norm1_m``, ..."""
    parts = name.split(".")
    if "upsample_conv2d" in parts:
        return "upsample_" + parts[-1]
    if parts[-2].startswith("norm"):
        return parts[-2] + "_" + parts[-1]
    return "other_" + parts[-1]


def group_of(name):
    """The parameter's name without its block (``c_layers.1.norm2.m`` ->
    ``norm2.m``): the scalars of one kind across the blocks."""
    return re.sub(r"^[a-z]+_layers\.\d+\.", "", name)


def stacked(grads, names):
    return torch.stack([grads[n].reshape(()) for n in names])


def one_seed(model, seed, dev, ds, B):
    L, hop = ds["segment_length"], ds["hop_length"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    audio = 0.3 * torch.randn(B, 1, L, device=dev, generator=gen)
    t = torch.randint(0, cs.VOC_DIFFUSION_CFG["T"], (B,), device=dev,
                      generator=gen)
    z = torch.randn(B, 1, L, device=dev, generator=gen)
    mel = torch.randn(B, 80, L // hop + 1, device=dev, generator=gen)
    step = [audio, t, z]
    _, f32 = cs.step_grads(torch, model, *step, "PLAIN", mel,
                           cs.VOC_DIFFUSION_CFG)
    bfm = cs.bf16_copy(torch, model)
    _, fused = cs.step_grads(torch, bfm, *step, "FUSED", mel,
                             cs.VOC_DIFFUSION_CFG)
    _, plain = cs.step_grads(torch, bfm, *step, "PLAIN", mel,
                             cs.VOC_DIFFUSION_CFG)
    del bfm
    rows = {}
    for n, p in plain.items():
        if n == "init_conv.0.conv.weight_v":
            continue
        r = {"numel": p.numel(), "err": rel(fused[n], p),
             "own": rel(p, f32[n]), "vs_f32": rel(fused[n], f32[n])}
        if p.numel() == 1 or r["err"] > 0.05:
            rows[n] = r
    dws = {k: effective_weight_grads(model, g)
           for k, g in (("fused", fused), ("plain", plain), ("f32", f32))}
    for pre, dw in dws["plain"].items():
        rows[pre + "W"] = {"numel": dw.numel(),
                           "err": rel(dws["fused"][pre], dw),
                           "own": rel(dw, dws["f32"][pre]),
                           "vs_f32": rel(dws["fused"][pre], dws["f32"][pre])}
        g = pre + "weight_g"
        rows[g]["cs"] = float((fused[g] - plain[g]).abs().max() / dw.norm())
        rows[g]["cs_own"] = float((plain[g] - f32[g]).abs().max()
                                  / dws["f32"][pre].norm())
    groups = {}
    for n, p in plain.items():
        if p.numel() == 1:
            groups.setdefault(group_of(n), []).append(n)
    for k, names in groups.items():
        pl = stacked(plain, names)
        rows["group:" + k] = {
            "numel": len(names), "err": rel(stacked(fused, names), pl),
            "own": rel(pl, stacked(f32, names)),
            "vs_f32": rel(stacked(fused, names), stacked(f32, names))}
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("vocoder_grads.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    harder = "--harder" in sys.argv
    seeds = [int(s) for s in sys.argv[1:] if s != "--harder"] or SEEDS
    if harder:
        cfg = dict(cs.HARDER_MODEL_CFG, n_layers=cs.HARDER_GRAD_LAYERS)
        ds, B = cs.HARDER_DATASET_CFG, cs.HARDER_SAMPLES
    else:
        cfg, ds, B = cs.VOC_MODEL_CFG, cs.VOC_DATASET_CFG, cs.N_SAMPLES
    model = cs.build_model(torch, cfg).to(dev)
    record, summary = {}, {}
    for seed in seeds:
        rows = one_seed(model, seed, dev, ds, B)
        record[seed] = rows
        print(json.dumps({"seed": seed, "rows": rows}), flush=True)
        for n, r in rows.items():
            if n.startswith("group:"):
                k = "scalar_groups"
            elif r["numel"] != 1:
                k = "upsample_W" if n.endswith(".W") else "tensor_err>0.05"
            else:
                k = kind(n)
            s = summary.setdefault(k, {"n": 0, "max_err": 0.0,
                                       "max_err_over_own": 0.0,
                                       "max_own": 0.0, "max_cs": 0.0})
            s["n"] += 1
            s["max_err"] = max(s["max_err"], r["err"])
            s["max_own"] = max(s["max_own"], r["own"])
            s["max_err_over_own"] = max(s["max_err_over_own"],
                                        r["err"] / r["own"] if r["own"]
                                        else float("inf"))
            s["max_cs"] = max(s["max_cs"], r.get("cs", 0.0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    os.makedirs("chiprun_out", exist_ok=True)
    out = "vocoder_grads_harder.json" if harder else "vocoder_grads.json"
    with open(os.path.join("chiprun_out", out), "w") as f:
        json.dump({"card": smi, "seeds": record, "summary": summary}, f)
    print(f"card: {smi}")
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
