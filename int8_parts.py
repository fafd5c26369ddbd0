#!/usr/bin/env python3
"""Where kernel 12, the int8 S4 conv, spends its time, part by part.

    python3 int8_parts.py        # from the repository root, one GPU

A profiler trace sees a kernel only as a whole.  This script builds
``diffwave_sashimi_torch/csrc/fftconv_int8.cu`` alone, three ways, into
``build/int8_parts/``: as shipped; with ``-DDWST_INT8_STAMPS``, where
thread 0 of every block records ``clock64()`` at the stage boundaries and
inside the first part (the source's ``STAMP``s, empty in the shipped
build); and with ``-DDWST_INT8_NO_TWIDDLE``, where the twiddle and
spectrum reads are taken away (constants in their place: a timing
variant, its output wrong).  At SC09's three tiers, at B4 and B16, with
bf16 and f32 activations on the main path's form (rows offset by a step
bias, the mean split by the window conv W), it prints each build's time
a call in a CUDA graph (the three builds in turns: shipped, stamped, no
twiddles, then back), the shipped build's largest difference to the
plain version, and the stamped build's mean SM cycles of each part over
the blocks; then ptxas's registers and spills of each instance, and the
card's name and power limit.  It writes the same as JSON to
``chiprun_out/int8_parts.json``.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

SOURCE, ENTRY = "fftconv_int8.cu", "dwst_fftconv_int8"
VARIANTS = {"shipped": [], "stamps": ["-DDWST_INT8_STAMPS"],
            "no_twiddle": ["-DDWST_INT8_NO_TWIDDLE"]}
# the part that starts at each STAMP(k), k < 10 (STAMP(10) ends the last)
PARTS = ("mean and x (stage 1's factors copied under it)", "S1, max pass",
         "S1, quantizing pass", "Nyquist bin, S2's factors landed",
         "S2, max pass", "S2, quantizing pass", "iA's factors landed",
         "iA, max pass", "iA, quantizing pass", "iB and epilogue")
# the first part's pieces: STAMP(11) after the mean, STAMP(12) after x's
# max, STAMP(13) after x's stores
FIRST = ("mean", "x read, its max", "x quantized and stored",
         "stage 1's factors landed")
STAMPS = len(PARTS) + len(FIRST)
STAMP_BLOCKS = 8192
# (H, L, n): SC09's three tiers
TIERS = ((128, 16000, 32768), (256, 4000, 8192), (512, 1000, 2048))
BATCHES = (4, 16)


def build(nvcc, flags, src, out_dir, variant):
    """The source as a shared library; returns its path and ptxas's report
    (-Xptxas -v) of it."""
    so = os.path.join(out_dir, f"{SOURCE}.{variant}.so")
    r = subprocess.run([nvcc, *flags, *VARIANTS[variant], "-Xptxas", "-v",
                        "-shared", str(src), "-o", so],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {variant}:\n{r.stdout}{r.stderr}")
    return so, r.stdout + r.stderr


def ptxas_lines(text):
    """{kernel instance: registers and spills} from ptxas's report."""
    out, lines = {}, text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?(fftconv_int8_kernel)"
                      r"I(f|13__nv_bfloat16)Li(\d+)E", line)
        if m:
            name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}"
                    f", {m.group(3)}>")
            props = " ".join(lines[i + 1:i + 5])
            regs = re.search(r"Used (\d+) registers", props)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", props)
            out[name] = {"registers": int(regs.group(1)) if regs else None,
                         "spill_stores": int(spill.group(1)) if spill
                         else None,
                         "spill_loads": int(spill.group(2)) if spill
                         else None}
    return out


def graph_ms(torch, fn, reps=10, replays=5):
    """Device time a call of fn(): ``reps`` calls captured in one CUDA
    graph (after 3 uncaptured ones), replayed ``replays`` times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def stamp_cycles(torch, reader, rows):
    """The stamped build's last call: mean SM cycles of each of PARTS and
    of FIRST over the blocks, and of the whole block."""
    st = torch.zeros(rows, STAMPS, dtype=torch.int64)
    if reader(st.data_ptr(), rows):
        raise RuntimeError("reading the stamps failed")
    t = st.double()
    main_ = t[:, :len(PARTS) + 1]
    first = t[:, [0, 11, 12, 13, 1]]
    return (dict(zip(PARTS, (main_[:, 1:] - main_[:, :-1]).mean(0).tolist())),
            dict(zip(FIRST, (first[:, 1:] - first[:, :-1]).mean(0).tolist())),
            float((main_[:, -1] - main_[:, 0]).mean()))


def main():
    import torch
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import cuda_lib, int8conv
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "int8_parts")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, src = cuda_lib._nvcc(), cuda_lib._CSRC / SOURCE
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda var: build(nvcc, cuda_lib._FLAGS, src, out_dir, var),
            VARIANTS)))
    P, I = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for var, (so, _) in built.items():
        lib = ctypes.CDLL(so)
        entries[var] = getattr(lib, ENTRY)
        entries[var].argtypes = cuda_lib._SIGNATURES[ENTRY]
        if var == "stamps":
            reader = lib.dwst_read_int8_stamps
            reader.argtypes = [P, I]
    report = {"card": smi, "ptxas": ptxas_lines(built["shipped"][1]),
              "cases": []}
    print(f"ptxas: {json.dumps(report['ptxas'])}", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for H, L, n in TIERS:
        khat = torch.fft.rfft(0.05 * torch.randn(H, L, device=dev,
                                                 generator=g), n=n)
        W = ops.int8_spectrum(khat, L)[1]
        layout = int8conv.int8_layout(n, L)
        plan = int8conv.int8_plan(n, L)
        qc, qs = int8conv._on_device(n, L, dev)
        D = torch.randn(H, device=dev, generator=g)
        for B in BATCHES:
            a = 0.5 + torch.rand(B, L, device=dev, generator=g)
            c = 0.3 * torch.randn(B, L, device=dev, generator=g)
            bias = 1.5 * torch.randn(B, H, device=dev, generator=g)
            x = torch.randn(B, H, L, device=dev, generator=g)
            for dtype in (torch.bfloat16, torch.float32):
                u = x.to(dtype)
                out = torch.empty_like(u)

                def call(var):
                    e = entries[var](
                        u.data_ptr(), a.data_ptr(), c.data_ptr(),
                        bias.data_ptr(), khat.data_ptr(), D.data_ptr(),
                        W.data_ptr(), qc.data_ptr(), qs.data_ptr(),
                        out.data_ptr(), B, H, L, n, *layout,
                        int(dtype == torch.bfloat16),
                        *int8conv.plan_args(plan),
                        torch.cuda.current_stream().cuda_stream)
                    if e:
                        raise RuntimeError(f"{var}: CUDA error {e}")
                ref = ops.fftconv_int8_ref(u, a, c, bias, khat, D, W)
                call("shipped")
                torch.cuda.synchronize()
                r = {"B": B, "H": H, "L": L, "n": n,
                     "dtype": str(dtype).split(".")[-1],
                     "plan": plan._asdict(),
                     "max_abs_err_vs_plain":
                         float((out.float() - ref.float()).abs().max()),
                     "max_abs_plain": float(ref.float().abs().max()),
                     "finite": bool(torch.isfinite(out).all())}
                order = list(VARIANTS)
                times = {var: [] for var in order}
                for var in order + order[::-1]:
                    times[var].append(graph_ms(torch, lambda: call(var)))
                for var, ts in times.items():
                    r[f"{var}_graph_ms"] = sum(ts) / 2
                    r[f"{var}_graph_ms_runs"] = ts
                call("stamps")
                torch.cuda.synchronize()
                r["cycles"], r["first_part_cycles"], r["cycles_total"] = \
                    stamp_cycles(torch, reader, min(B * H, STAMP_BLOCKS))
                report["cases"].append(r)
                print(json.dumps(r), flush=True)
                print(f"kernel 12 B{B} H{H} L{L} n {n} {r['dtype']}: graph "
                      f"{r['shipped_graph_ms']:.4f} ms, without twiddle "
                      f"reads {r['no_twiddle_graph_ms']:.4f}; "
                      f"{r['cycles_total']:.0f} SM cycles a block",
                      flush=True)
                for label in PARTS:
                    cy = r["cycles"][label]
                    print(f"  {label:48s} {cy:9.0f} "
                          f"{cy / r['cycles_total']:6.1%}")
                for label, cy in r["first_part_cycles"].items():
                    print(f"    first part: {label:34s} {cy:9.0f}")
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "int8_parts.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:
        import traceback
        traceback.print_exc()
        print(f"int8_parts FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
