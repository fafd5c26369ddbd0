#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (diffwave_sashimi_torch).

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each fatal on failure (non-zero exit, no result line):

1. build the CUDA kernels from ``diffwave_sashimi_torch/csrc`` and require
   a CUDA device;
2. build the shipped SC09 model (d_model 128, n_layers 6, pool [4, 4],
   expand 2, ff 2, L 16000) from a seed, with a perturbed (normally
   zero-initialised) final conv, and save it as a checkpoint in a
   temporary ``exp/`` directory;
3. hold each of the four kernels against its plain PyTorch version on the
   card at the shapes the sampling path gives it at all three UNet tiers;
4. the main path: ``generate()`` at T = 200, f32, a few samples, with every
   kernel's launch count set to 0 just before and read just after (each
   must be > 0), and finite output of the right shape;
5. one eps forward through the kernels against the plain path on the card;
6. timings (CUDA events, after warm-up): each kernel and its plain
   version, and the eps forward (one sampling step) both ways at the main
   path's batch and at batch 16.

It prints the card's name and power limit, one JSON line with the kernels,
and last ``{"ok": true, "device": {...}}``.  The config blocks below are
``load_config(["experiment=sc09"])`` written out (a CPU test pins them),
so this script imports nothing of the JAX package.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
N_SAMPLES = 4                 # the main path's batch
TOL_KERNEL = 1e-4             # |kernel - plain| <= TOL * max(1, max|plain|)
TOL_EPS = (1e-3, 1e-2)        # eps: |kernel - plain| <= atol + rtol * |plain|

DIFFUSION_CFG = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}
MODEL_CFG = {"_name_": "sashimi", "unconditional": True, "in_channels": 1,
             "out_channels": 1, "diffusion_step_embed_dim_in": 128,
             "diffusion_step_embed_dim_mid": 512,
             "diffusion_step_embed_dim_out": 512, "unet": True,
             "d_model": 128, "n_layers": 6, "pool": [4, 4], "expand": 2,
             "ff": 2, "L": 16000}
DATASET_CFG = {"_name_": "sc09", "data_path": "data/sc09",
               "segment_length": 16000, "sampling_rate": 16000}

KERNELS = {
    "fftconv_ln_bias_gelu_d": ("diffwave_sashimi_torch/csrc/fftconv.cu",
                               "diffwave_sashimi_tpu/ops/fftconv2.py:427"),
    "glu_res": ("diffwave_sashimi_torch/csrc/chmix.cu",
                "diffwave_sashimi_tpu/ops/chmix.py:119"),
    "ln_ff_res": ("diffwave_sashimi_torch/csrc/chmix.cu",
                  "diffwave_sashimi_tpu/ops/chmix.py:182"),
    "cauchy": ("diffwave_sashimi_torch/csrc/cauchy.cu",
               "diffwave_sashimi_tpu/ops/cauchy_pallas.py:54"),
}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call of fn() by CUDA events, after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn, reps):
    """Times in turns (plain, kernel, kernel, plain); mean of each pair."""
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(out, ref):
    return float((out - ref).abs().max()), float(ref.abs().max())


def build_model(torch):
    from diffwave_sashimi_torch.models import construct_model
    gen = torch.Generator().manual_seed(SEED)
    model = construct_model(MODEL_CFG, "f32", generator=gen)
    fc2 = model.final_conv[2].conv
    with torch.no_grad():     # zero-init head: perturb, or eps is all 0
        fc2.weight.copy_(0.1 * torch.randn(fc2.weight.shape, generator=gen))
        fc2.bias.copy_(0.1 * torch.randn(fc2.bias.shape, generator=gen))
    return model


def tier_blocks(model):
    """(H, L, block) for the first block of each UNet tier."""
    from diffwave_sashimi_torch.models.sashimi import DiffWaveBlock
    seen, out = set(), []
    for blk in model.modules():
        if isinstance(blk, DiffWaveBlock):
            H = blk.layer.D.shape[1]
            if H not in seen:
                seen.add(H)
                out.append((H, blk.layer.l_max, blk))
    return sorted(out, key=lambda t: t[0])


def check_kernels(torch, model, dev, results):
    """Phase 3 (+ kernel timings): every kernel vs its plain version at
    the sampling path's shapes of every tier."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.models.s4 import _fft_nodes
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B = N_SAMPLES
    for H, L, blk in tier_blocks(model):
        tier = f"H{H}_L{L}"
        layer = blk.layer
        khat = layer.compute_kernel_freq(L, ops.PLAIN)
        x = torch.randn(B, H, L, device=dev, generator=gen)
        var, mean = torch.var_mean(x, dim=1, unbiased=False)
        a = blk.norm1.s * torch.rsqrt(var)
        c = (blk.norm1.m - mean) * a
        bias = blk.fc_t(torch.randn(B, 512, device=dev, generator=gen))
        D = layer.D[0]
        lin = layer.output_linear[0]
        ff1, ff2 = blk.ff["ff"][0], blk.ff["ff"][2]
        w1 = ff1.effective_weight()[:, :, 0]
        w2 = ff2.effective_weight()[:, :, 0]
        skip = torch.randn(B, H, L, device=dev, generator=gen)
        kern = layer.kernel["kernel"]
        C = torch.view_as_complex(kern.C)
        Pm = kern._broadcast(torch.view_as_complex(kern.P), 1)
        Bm = kern._broadcast(torch.view_as_complex(kern.B), 1)
        v = (torch.cat([Bm, Pm])[:, None] * torch.cat([C, Pm.conj()])[None])
        z = torch.from_numpy(_fft_nodes(L)[1]).to(dev)
        wt = kern._w() * kern.log_dt.exp()[:, None]
        y = ops.fftconv_ln_bias_gelu_d_ref(x, a, c, bias, khat, D)

        cases = {
            "fftconv_ln_bias_gelu_d": (
                lambda: ops.fftconv_ln_bias_gelu_d(x, a, c, bias, khat, D),
                lambda: ops.fftconv_ln_bias_gelu_d_ref(x, a, c, bias, khat,
                                                       D)),
            "glu_res": (lambda: ops.mix_glu_res(y, x, lin.weight, lin.bias),
                        lambda: ops.glu_res_ref(y, x, lin.weight, lin.bias)),
            "ln_ff_res": (
                lambda: ops.ln_ff_res(x, blk.norm2.m, blk.norm2.s, w1,
                                      ff1.bias, w2, ff2.bias, skip, True),
                lambda: ops.ln_ff_res_ref(x, blk.norm2.m, blk.norm2.s, w1,
                                          ff1.bias, w2, ff2.bias, skip,
                                          True)),
            "cauchy": (lambda: ops.cauchy_sym_fused(v, z, wt),
                       lambda: ops.cauchy_sym(v, z, wt)),
        }
        for name, (kfn, pfn) in cases.items():
            out, ref = kfn(), pfn()
            torch.cuda.synchronize()
            if name == "ln_ff_res":    # (out, mean, var): check all three
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                err = max(e for e, _ in errs)
                scale = max(s for _, s in errs)
            else:
                err, scale = max_err(out, ref)
            bound = TOL_KERNEL * max(1.0, scale)
            reps = 3 if name == "cauchy" else 20
            ms, plain_ms = paired_ms(kfn, pfn, reps)
            ok = err <= bound and all(torch.isfinite(t).all() for t in
                                      (out if isinstance(out, tuple)
                                       else (out,)))
            log(f"kernel {name} {tier}: max_abs_err {err:.3e}, rel "
                f"{err / max(scale, 1e-30):.3e} of max|plain| {scale:.3e} "
                f"(bound {bound:.3e}) {'ok' if ok else 'FAIL'}; "
                f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
            r = results.setdefault(name, {"max_abs_err": 0.0, "tiers": {}})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["tiers"][tier] = {"max_abs_err": err, "max_abs_plain": scale,
                                "ms": ms, "plain_ms": plain_ms}
            if not ok:
                raise AssertionError(f"kernel {name} disagrees at {tier}")


def main():
    t_start = time.perf_counter()
    import numpy as np
    import torch
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import cuda_lib
    from diffwave_sashimi_torch.runtime.checkpoint import save_checkpoint
    from diffwave_sashimi_torch.runtime.generate import generate
    from diffwave_sashimi_torch.utils.exp import local_directory

    # phase 1: build, then require the card
    t0 = time.perf_counter()
    cuda_lib.library()
    log(f"phase build: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke test runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"card: {smi[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 2: the seeded full-width model, saved as a checkpoint
    t0 = time.perf_counter()
    model = build_model(torch)
    cwd = os.getcwd()
    exp_root = tempfile.TemporaryDirectory(prefix="dwst_smoke_")
    os.chdir(exp_root.name)
    try:
        run, _ = local_directory(None, MODEL_CFG, DIFFUSION_CFG, DATASET_CFG,
                                 "checkpoint")
        save_checkpoint(os.path.join("exp", run, "checkpoint"), 1000, model)
        model = model.to(dev).eval()
        log(f"phase model: d128/n6/L16000 built and saved in "
            f"{time.perf_counter() - t0:.1f} s")

        # phase 3: kernels vs plain at every tier
        results = {}
        with torch.no_grad():
            check_kernels(torch, model, dev, results)

        # phase 4: the main path through generate()
        counters = (ops.fftconv_ln_bias_gelu_d, ops.mix_glu_res,
                    ops.ln_ff_res, ops.cauchy_sym_fused)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        audio = generate(DIFFUSION_CFG, MODEL_CFG, DATASET_CFG,
                         ckpt_iter="max", n_samples=N_SAMPLES, seed=SEED,
                         device="cuda")
        gen_s = time.perf_counter() - t0
        launches = dict(zip(KERNELS, (fn.launches for fn in counters)))
        log(f"phase generate: {gen_s:.2f} s wall; launches {launches}")
        if any(n == 0 for n in launches.values()):
            raise AssertionError(f"a kernel never ran on the main path: "
                                 f"{launches}")
        if audio.shape != (N_SAMPLES, 1, 16000) or \
                not np.isfinite(audio).all():
            raise AssertionError(f"bad output {audio.shape}")
        wavs = os.listdir(os.path.join("exp", run, "waveforms", "1000"))
        if sorted(wavs) != [f"1k_{i}.wav" for i in range(N_SAMPLES)]:
            raise AssertionError(f"wav layout {sorted(wavs)}")
        log(f"output: shape {audio.shape}, finite, std {audio.std():.4f}, "
            f"wavs {sorted(wavs)}")
    finally:
        os.chdir(cwd)
        exp_root.cleanup()

    # phase 5: eps through the kernels vs the plain path, on the card
    with torch.no_grad():
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        x = torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
        steps = torch.tensor([199, 120, 40, 3][:N_SAMPLES], device=dev)
        k_fused = model.compute_kernels(16000, ops.FUSED)
        k_plain = model.compute_kernels(16000, ops.PLAIN)
        eps = model(x, steps, k_fused, ops.FUSED)
        eps_plain = model(x, steps, k_plain, ops.PLAIN)
        err, scale = max_err(eps, eps_plain)
        atol, rtol = TOL_EPS
        ok = bool(torch.isfinite(eps).all()) and bool(
            ((eps - eps_plain).abs() <= atol + rtol * eps_plain.abs()).all())
        log(f"phase eps: kernels vs plain max_abs_err {err:.3e} (max|plain| "
            f"{scale:.3e}, atol {atol} rtol {rtol}) {'ok' if ok else 'FAIL'}")
        if not ok or scale == 0.0:
            raise AssertionError("eps through the kernels disagrees")

        # phase 6: one sampling step's eps forward, kernels vs plain, at
        # the main path's batch and at 16
        steps_ms = {}
        for B in (N_SAMPLES, 16):
            xb = torch.randn(B, 1, 16000, device=dev, generator=g)
            sb = torch.randint(0, 200, (B,), device=dev, generator=g)
            steps_ms[B] = paired_ms(
                lambda: model(xb, sb, k_fused, ops.FUSED),
                lambda: model(xb, sb, k_plain, ops.PLAIN), 5)
    T, sr = DIFFUSION_CFG["T"], DATASET_CFG["sampling_rate"]
    rtf = {B: B * 16000 / sr / (T * ms / 1000) for B, (ms, _) in
           steps_ms.items()}
    for B, (ms, plain_ms) in steps_ms.items():
        log(f"timing: eps forward (one sampling step) at B{B} {ms:.3f} ms "
            f"with kernels vs {plain_ms:.3f} ms plain; T={T} -> "
            f"{rtf[B]:.3f}x realtime from the step time")
    log(f"timing: generate() at B{N_SAMPLES}: "
        f"{N_SAMPLES * 16000 / sr / gen_s:.3f}x realtime from its wall time "
        f"(model build + load, S4 kernels, {T} steps, wav writes)")
    log(f"card: {smi[0]}")

    tier1 = "H128_L16000"
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["tiers"][tier1]["ms"],
         "plain_ms": results[name]["tiers"][tier1]["plain_ms"],
         "tiers": results[name]["tiers"]}
        for name, (src, rep) in KERNELS.items()],
        "step_ms": {str(B): ms for B, (ms, _) in steps_ms.items()},
        "step_plain_ms": {str(B): p for B, (_, p) in steps_ms.items()},
        "realtime_factor": {str(B): r for B, r in rtf.items()},
        "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # any failed phase: non-zero exit, no result
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
