#!/usr/bin/env python3
"""What kernel 8's time is made of, measured by taking parts away.

    python3 cauchy_bwd_parts.py      # from the repository root, one GPU

A profiler trace sees a kernel only as a whole.  This script builds
variants of ``diffwave_sashimi_torch/csrc/cauchy.cu`` into
``build/cauchy_bwd_parts/``, each a copy of the source with one edit, and
times each variant's ``dwst_cauchy_bwd`` in turns with the shipped source,
in CUDA graphs of 10 launches (so that no host time is in it), on the
cotangent as the training path hands it over (the views of one complex
tensor), at the K 6, N 32 shapes of SC09's three tiers (M 128, 256, 512 at
Lz 8001, 2001, 501) and of d_model 256's deepest (M 1024, Lz 501):

- ``shipped``: the source as it is, at the plan's span and at half of it
  (a 32-position chain a thread, more blocks);
- ``no_newton``: the approximate reciprocal without its Newton step;
- ``chunk8``: each warp staging 8 positions at a time, not 16;
- ``no_reciprocal``: G0 taken as the scaled conjugate denominator (the
  reciprocal, its scale and G0's products gone);
- ``no_k_loop``: the K loop's sums gone (da, db, A and Bb), the
  denominator chain, T, W and the dc, dd sums left.

The variants other than ``shipped`` and ``no_newton`` compute other
functions; only the shipped one is checked against the plain version here.
It also prints each shape's operations' bound and the card's name and
power limit.  ``chip_smoke.py``'s phase 1 reports the shipped instances'
registers and spills.
"""

import ctypes
import os
import subprocess

from chip_smoke import graph_ms

NO_NEWTON = ("  return fmaf(r, fmaf(-q, r, 1.0f), r);\n}", "  return r;\n}")
CHUNK8 = ("constexpr int BWD_CHUNK = 16;", "constexpr int BWD_CHUNK = 8; ")
NO_RECIPROCAL = (
    "  const float t = reciprocal_1_8(sr * sr + si * si) * s;\n"
    "  const float g0r = sr * t, g0i = -si * t;",
    "  const float g0r = sr, g0i = -si;")
NO_K_LOOP = (
    "    sa[k] = fmaf(gi, g1i, fmaf(gr, g1r, sa[k]));\n"
    "    sb[k] = fmaf(gi, g0i, fmaf(gr, g0r, sb[k]));\n"
    "    Ar = fmaf(an[k], gr, Ar);\n"
    "    Ai = fmaf(-an[k], gi, Ai);\n"
    "    Br = fmaf(bn[k], gr, Br);\n"
    "    Bi = fmaf(-bn[k], gi, Bi);",
    "    if (k == 0) {\n"
    "      Ar = gr;\n"
    "      Ai = gi;\n"
    "      sa[0] += g1r;\n"
    "      sb[0] += g0r;\n"
    "    }")
VARIANTS = {"shipped": (), "no_newton": (NO_NEWTON,), "chunk8": (CHUNK8,),
            "no_reciprocal": (NO_RECIPROCAL,), "no_k_loop": (NO_K_LOOP,)}
# (M, L): SC09's three tiers and d_model 256's deepest; K 6, N 32
SHAPES = ((128, 16000), (256, 4000), (512, 1000), (1024, 1000))
K, N = 6, 32
PEAK_FP32 = 67e12                 # the H100's fp32 rate (FLOP/s)


def build():
    """Each variant's source written and compiled, all at once, into
    build/cauchy_bwd_parts/<name>.so; returns {name: the loaded entry
    point}."""
    from diffwave_sashimi_torch.ops import cuda_lib
    src = (cuda_lib._CSRC / "cauchy.cu").read_text()
    out = os.path.join("build", "cauchy_bwd_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"cauchy_bwd_parts: variant {name}: the "
                                 f"source no longer holds {old!r} once")
            text = text.replace(old, new)
        path = os.path.join(out, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib._FLAGS, "-I", str(cuda_lib._CSRC),
             "-shared", path, "-o", os.path.join(out, name + ".so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"cauchy_bwd_parts: nvcc failed on {name}\n"
                             f"{log}")
        fn = getattr(ctypes.CDLL(os.path.abspath(
            os.path.join(out, name + ".so"))), "dwst_cauchy_bwd")
        fn.argtypes = cuda_lib._SIGNATURES["dwst_cauchy_bwd"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def s4_inputs(torch, M, L, dev):
    """The real coefficients and nodes a freshly initialised bidirectional
    S4 kernel of M channels hands kernel 8 (K 6, N 32), on the card."""
    from diffwave_sashimi_torch.models.s4 import SSKernelNPLR, _fft_nodes
    from diffwave_sashimi_torch.ops import cauchy
    kern = SSKernelNPLR(M, N=2 * N, l_max=L, channels=2,
                        generator=torch.Generator().manual_seed(M))
    with torch.no_grad():
        quad = cauchy.quad_operands(*kern.cauchy_operands()[:2])
    z = torch.from_numpy(_fft_nodes(L)[1])
    return [t.contiguous().to(dev) for t in quad] + [z.to(dev)]


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cauchy_bwd_parts: no CUDA device")
    from diffwave_sashimi_torch.ops import cauchy, cuda_lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    entries = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for M, L in SHAPES:
        a, b, c, d, z = s4_inputs(torch, M, L, dev)
        Lz = z.shape[0]
        G = torch.randn(K, M, Lz, dtype=torch.complex64, device=dev,
                        generator=gen)
        plan = cauchy.cauchy_bwd_plan(K, M, N, Lz, cuda_lib.sm_count(dev))
        half = plan.span // 2
        out = torch.empty(2 * K + 2, M, N, device=dev)
        part = torch.empty(-(-Lz // half), 2 * K + 2, M, N, device=dev)

        def call(fn, span):
            return lambda: fn(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                z.data_ptr(), G.real.data_ptr(), G.imag.data_ptr(), 2,
                out.data_ptr(), part.data_ptr(), K, M, N, Lz, span,
                -(-Lz // span), plan.smem,
                torch.cuda.current_stream().cuda_stream)
        if call(entries["shipped"], plan.span)() != 0:
            raise SystemExit(f"cauchy_bwd_parts: launch refused at M{M}")
        torch.cuda.synchronize()
        ref = torch.cat([r.reshape(-1, M, N) for r in cauchy.cauchy_bwd_ref(
            a, b, c, d, z, G.real, G.imag)])
        err = float((out - ref).abs().max() / max(1.0, float(
            ref.abs().max())))
        if not err <= 1e-4:
            raise SystemExit(f"cauchy_bwd_parts: shipped kernel off by {err}")
        cases = [("shipped", plan.span), ("shipped", half)] + [
            (name, plan.span) for name in VARIANTS if name != "shipped"]
        times, turns = {}, []
        for name, span in cases:                # in turns with shipped
            turns.append(graph_ms(torch, call(entries["shipped"],
                                              plan.span)))
            times[f"{name} span {span}"] = graph_ms(
                torch, call(entries[name], span))
        bound = 1e3 * (30 + 16 * K) * M * N * Lz / PEAK_FP32
        print(f"K{K} M{M} N{N} Lz{Lz} (plan span {plan.span}, splits "
              f"{plan.splits}): " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; shipped in turns {min(turns):.4f}-{max(turns):.4f}; "
              f"operations' bound {bound:.4f} ms; max err {err:.2e}",
              flush=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
