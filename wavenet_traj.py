#!/usr/bin/env python3
"""How far bf16 WaveNet training drifts from f32 training, beside the
drift that comes from run-to-run noise, for two forms of the training tail.

    python3 wavenet_traj.py      # from the repository root, one GPU

chip_smoke.py's bf16 trajectory gate (phase 23b) runs TRAJ_STEPS Adam
steps of the seeded ``experiment=sc09_wavenet`` model (res 256, skip 256,
36 layers, B4, L 16000) at bf16 and at f32 on the same seeded batches, t
and z. It requires the per-step losses to satisfy |bf16 - f32| <= atol +
rtol |f32| (TRAJ_TOL). This script prints each pair of trajectories'
largest share of that bar (1.0 means the loss is at the bar) for:

- the bf16 training tail in two forms: ``shipped``, the tail
  ``models/wavenet.py`` trains through (``ops.gate_res_skip_ref``: the gate
  and the residual sum computed in f32 and each rounded once to bf16), and
  ``per_op``, the JAX training tail's ops (``diffwave_sashimi_tpu/models/
  wavenet.py:98-103``) each rounded to bf16 (the 1x1 convs' products and
  biases in bf16), as XLA computes them on the CPU;
- two seeded sets of batches: the gate's (SEED + 15) and SEED + 16;
- cuDNN left nondeterministic (as in the gate) and set deterministic.

The noise floor is printed beside these shares: f32 against f32, and bf16
against bf16 for the same tail, each pair run twice. The script
also prints the card's name and power limit. It imports nothing of the
JAX package.
"""

import copy
import json
import math
import subprocess

import torch

import chip_smoke as cs
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import wavenet as wavenet_mod
from diffwave_sashimi_torch.runtime.train import make_optimizer

SEEDS = (cs.SEED + 15, cs.SEED + 16)
SHIPPED_TAIL = wavenet_mod.gate_res_skip_ref


def per_op_tail(h, x, wr, br, ws, bs):
    """The JAX training tail with every op's result in the activations'
    dtype: tanh, sigmoid and their product, the 1x1 convs (bf16 weights,
    f32 accumulation, bf16 bias added to the bf16 product), x + res and
    its product with sqrt(1/2) in x's dtype."""
    C, dt = x.shape[1], h.dtype
    out = torch.tanh(h[:, :C]) * torch.sigmoid(h[:, C:])

    def conv(w, b):
        return torch.einsum("ck,bkl->bcl", w.to(dt), out) + b.to(dt)[:, None]
    half = torch.tensor(math.sqrt(0.5), dtype=x.dtype, device=x.device)
    return (x + conv(wr, br)) * half, conv(ws, bs)


def trajectory(model, bf16, draws, schedule):
    """Per-step losses of Adam (lr 2e-4) over ``draws`` from the model's
    parameters, at bf16 or f32, as ``chip_smoke.check_bf16_trajectory``
    runs them."""
    m = cs.bf16_copy(torch, model) if bf16 else copy.deepcopy(model)
    optim = make_optimizer(m, 2e-4)
    losses = []
    for audio, t, z in draws:
        optim.zero_grad(set_to_none=True)
        loss = training_loss(m, audio, schedule, t=t, z=z, ops=ops.FUSED)
        loss.backward()
        optim.step()
        losses.append(loss.item())
    return losses


def share(mine, ref):
    """The largest |mine - ref| over TRAJ_TOL's bar at ref."""
    tol = cs.TRAJ_TOL
    return max(abs(a - b) / (tol["atol"] + tol["rtol"] * abs(b))
               for a, b in zip(mine, ref))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("wavenet_traj.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = cs.build_model(torch, cs.WNET_MODEL_CFG).to(dev)
    schedule = schedule_from_cfg(cs.DIFFUSION_CFG)
    rows = []
    for seed in SEEDS:
        g = torch.Generator(device=dev).manual_seed(seed)
        draws = [(0.3 * torch.randn(cs.N_SAMPLES, 1, 16000, device=dev,
                                    generator=g),
                  torch.randint(0, 200, (cs.N_SAMPLES,), device=dev,
                                generator=g),
                  torch.randn(cs.N_SAMPLES, 1, 16000, device=dev,
                              generator=g))
                 for _ in range(cs.TRAJ_STEPS)]
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            f32 = [trajectory(model, False, draws, schedule)
                   for _ in range(2)]
            for name, tail in (("shipped", SHIPPED_TAIL),
                               ("per_op", per_op_tail)):
                wavenet_mod.gate_res_skip_ref = tail
                try:
                    bf16 = [trajectory(model, True, draws, schedule)
                            for _ in range(2)]
                finally:
                    wavenet_mod.gate_res_skip_ref = SHIPPED_TAIL
                row = {"seed": seed, "cudnn_deterministic": det,
                       "tail": name,
                       "bf16_vs_f32": share(bf16[0], f32[0]),
                       "bf16_vs_bf16": share(bf16[1], bf16[0]),
                       "f32_vs_f32": share(f32[1], f32[0]),
                       "max_rel_diff": max(abs(a - b) / abs(b) for a, b
                                           in zip(bf16[0], f32[0]))}
                rows.append(row)
                print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(json.dumps({"traj_tol": cs.TRAJ_TOL, "steps": cs.TRAJ_STEPS,
                      "rows": rows}))


if __name__ == "__main__":
    main()
