#!/usr/bin/env python3
"""Kernels 9 and 6 and the f32 vocoder step against another checkout's.

    python3 vs_checkout.py OTHER     # from the repository root, one GPU

OTHER is a checkout of another commit (for instance the parent's, unpacked
by ``git archive`` into a directory that ``.gitignore`` lists).  The
script loads OTHER's ``diffwave_sashimi_torch/ops`` as a package of its
own beside this checkout's: each builds its kernels from its own sources
into its own ``build/`` directory.  On seeded inputs it holds, this
checkout's build against OTHER's:

- kernel 9, every entry (the f32 sampling form, 9f on ``long_plan``'s
  route, the training entries at f32 and bf16 with K and with conj(K)) at
  every n of ``chip_smoke.py``'s phase 15 and at ``ljspeech_harder``'s
  training shape: the two outputs equal bit for bit, and each entry timed
  in CUDA graphs in turns (this, OTHER, OTHER, this);
- kernel 6 (f32) at SC09's three B4 training tiers: the two builds'
  gradients within 1e-4 x max(1, max|OTHER's|) of each other, the whole
  calls timed in CUDA graphs in turns;
- the f32 vocoder's eps forward (``chip_smoke.VOC_MODEL_CFG`` from a seed,
  B2 L143360, a random mel) timed in turns with the same step with its
  kernel-9 launches sent to OTHER's build (CUDA events, as
  ``chip_smoke.paired_ms``), and the largest difference of the two eps.

It prints the card's name and power limit, a line a measurement, then one
JSON line, and exits non-zero on a difference.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
# (B, H, L, n): the n of chip_smoke.py's phase 15 (the f32 vocoder's top
# and middle tiers first), then ljspeech_harder's training shape
SHAPES = ((2, 128, 143360, 1 << 18), (2, 256, 35840, 1 << 16),
          (2, 128, 100000, 1 << 17), (2, 512, 3000, 4096),
          (2, 128, 300000, 1 << 19), (2, 128, 44000, 1 << 17))
# kernel 6's (B, H, L): SC09's f32 training tiers
GLU_BWD_TIERS = ((4, 128, 16000), (4, 256, 4000), (4, 512, 1000))
TOL = 1e-4
SEED = 0


def load_ops(checkout, alias):
    """A checkout's ``diffwave_sashimi_torch/ops`` as the package
    ``alias`` (its modules import each other relatively, and nothing
    outside ``ops``)."""
    pkg = os.path.join(checkout, "diffwave_sashimi_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def in_turns(torch, cs, fns):
    """{key: mean ms} of ``cs.graph_ms`` of each of two functions, timed
    in the order a, b, b, a."""
    order = list(fns) + list(fns)[::-1]
    times = [(k, cs.graph_ms(torch, fns[k])) for k in order]
    return {k: sum(t for q, t in times if q == k) / 2 for k in fns}


def kernel_9(torch, cs, mine, theirs, gen, dev):
    """Every kernel-9 entry at SHAPES: bits and times, this vs OTHER."""
    fl = importlib.import_module("diffwave_sashimi_torch.ops.fftconv_long")
    out, differ = {}, []
    for B, H, L, n in SHAPES:
        x = torch.randn(B, H, L, device=dev, generator=gen)
        a = 1.0 + 0.1 * torch.randn(B, L, device=dev, generator=gen)
        c = 0.1 * torch.randn(B, L, device=dev, generator=gen)
        bias = 0.1 * torch.randn(B, H, device=dev, generator=gen)
        D = torch.randn(H, device=dev, generator=gen)
        k = 0.05 * torch.randn(H, n, device=dev, generator=gen) * torch.exp(
            -torch.arange(n, device=dev) / (n / 16))
        kp = fl.long_spectrum(torch.fft.rfft(k, n=n))
        xb = x.to(torch.bfloat16)
        del k

        def entries(o):
            return {
                "f32_sampling": lambda: o.fftconv_long_ln_bias_gelu_d(
                    x, a, c, bias, kp, D),
                f"9f_{fl.long_plan(n).route}": lambda: (
                    o.fftconv_long_ln_bias_gelu_d_bf16(xb, a, c, bias, kp,
                                                       D)),
                "train_f32": lambda: o.fftconv_long(x, kp),
                "train_f32_conj": lambda: o.fftconv_long(x, kp, True),
                "train_bf16": lambda: o.fftconv_long(xb, kp),
                "train_bf16_conj": lambda: o.fftconv_long(xb, kp, True)}
        ours, other = entries(mine), entries(theirs)
        tier = f"B{B}_H{H}_L{L}_n{n}"
        out[tier] = {}
        for key in ours:
            same = bool(torch.equal(ours[key](), other[key]()))
            ms = in_turns(torch, cs, {"graph_ms": ours[key],
                                      "other_graph_ms": other[key]})
            out[tier][key] = dict(bit_equal=same, **ms)
            if not same:
                differ.append(f"{tier}: {key}")
            print(f"kernel 9 {tier} {key}: {json.dumps(out[tier][key])}",
                  flush=True)
        del x, xb, kp, a, c, bias, D
        torch.cuda.empty_cache()
    return out, differ


def kernel_6(torch, cs, mine, theirs, gen, dev):
    """Kernel 6 (f32) at GLU_BWD_TIERS: agreement and times."""
    out, differ = {}, []
    for B, H, L in GLU_BWD_TIERS:
        def f(*shape, sc=1.0):
            return sc * torch.randn(*shape, device=dev, generator=gen)
        args = (f(B, H, L), f(2 * H, H, sc=H ** -0.5), f(2 * H, sc=0.1),
                f(B, H, L))
        got, want = mine.glu_res_bwd(*args), theirs.glu_res_bwd(*args)
        err = max(float((p - q).abs().max()) / max(1.0, float(q.abs().max()))
                  for p, q in zip(got, want))
        ms = in_turns(torch, cs, {
            "graph_ms": lambda: mine.glu_res_bwd(*args),
            "other_graph_ms": lambda: theirs.glu_res_bwd(*args)})
        tier = f"B{B}_H{H}_L{L}"
        out[tier] = dict(rel_err=err, **ms)
        if not err <= TOL:
            differ.append(f"kernel 6 {tier}: {err:.3e}")
        print(f"kernel 6 {tier}: {json.dumps(out[tier])}", flush=True)
        del args, got, want
    return out, differ


def vocoder_step(torch, cs, mine, theirs, dev):
    """The f32 vocoder's eps forward at B2, in turns with its kernel-9
    launches sent to OTHER's build."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import cuda_lib
    name = "dwst_fftconv_long_ln_bias_gelu_d"
    if cuda_lib._SIGNATURES[name] != theirs.cuda_lib._SIGNATURES[name]:
        sys.exit(f"{name} has another signature in OTHER")
    model = cs.build_model(torch, cs.VOC_MODEL_CFG).to(dev).eval()
    hop = cs.VOC_DATASET_CFG["hop_length"]
    frames = 1 + int(cs.VOC_SECONDS
                     * cs.VOC_DATASET_CFG["sampling_rate"]) // hop
    L, B = frames * hop, cs.VOC_SAMPLES
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    x = torch.randn(B, 1, L, device=dev, generator=g)
    steps = torch.tensor([49, 7][:B], device=dev)
    mel = torch.randn(1, 80, frames, device=dev, generator=g)
    conds = model.compute_mel_conds(mel, L)
    kernels = model.compute_kernels(L, ops.FUSED)
    launch = cuda_lib.launch

    def step():
        return model(x, steps, kernels, ops.FUSED, mel_conds=conds)

    def step_other():
        def routed(fn, *args):
            (theirs.cuda_lib.launch if fn == name else launch)(fn, *args)
        cuda_lib.launch = routed
        try:
            return step()
        finally:
            cuda_lib.launch = launch
    diff = float((step() - step_other()).abs().max())
    ms, other_ms = cs.paired_ms(step, step_other, 3)
    out = {"B": B, "L": L, "step_ms": ms, "other_kernel_9_step_ms": other_ms,
           "eps_max_abs_diff": diff}
    print(f"f32 vocoder step: {json.dumps(out)}", flush=True)
    return out


def main():
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage: python3 vs_checkout.py OTHER_CHECKOUT (on a card)")
    other = os.path.abspath(sys.argv[1])
    sys.path.insert(0, ROOT)
    from diffwave_sashimi_torch import ops as mine
    cs = importlib.import_module("chip_smoke")
    theirs = load_ops(other, "other_ops")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(2) as pool:      # both builds at once
        list(pool.map(lambda o: o.cuda_lib.library(), (mine, theirs)))
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        k9, d9 = kernel_9(torch, cs, mine, theirs, gen, dev)
        step = vocoder_step(torch, cs, mine, theirs, dev)
    k6, d6 = kernel_6(torch, cs, mine, theirs, gen, dev)
    print(json.dumps({"other": other, "kernel_9": k9, "kernel_6": k6,
                      "f32_vocoder_step": step, "differ": d9 + d6}))
    if d9 + d6:
        sys.exit(f"differs from {other}: {d9 + d6}")


if __name__ == "__main__":
    main()
