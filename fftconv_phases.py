#!/usr/bin/env python3
"""Where the radix-16 routes of kernels 1f and 5f spend their time, phase
by phase.

    python3 fftconv_phases.py        # from the repository root, one GPU

A profiler trace sees a kernel only as a whole.  This script builds
``diffwave_sashimi_torch/csrc/fftconv.cu`` with ``-DDWST_R16_STAMPS`` into
``build/fftconv_phases/``: thread 0 of every block of
``fftconv_r16_kernel`` and ``fftconv_dkf_r16_kernel`` then records
``clock64()`` at each phase boundary (the source's ``R16_STAMP``s, empty
in the shipped build).  It runs kernel 1f's sampling form and training
entry at every size the bf16 paths launch 1f at (SC09's three tiers at
B4, the vocoder's deepest at B2), and kernels 5f and 5 (the last chunk's
phases) at SC09's three tiers and d_model 256's top tier at B4, at every
chunk size (rows) the plan could take there, and prints the mean SM
cycles of each phase over the blocks, beside the stamped build's time a
call and its largest difference to the plain version.  It also prints
what ``nvcc -Xptxas -v`` reports of the shipped build's radix-16
instances of both (registers a thread, spills, and any function the
compiler left as a call), and the card's name and power limit.
"""

import ctypes
import importlib
import os
import re
import subprocess
import sys

# the phase that starts at each of the kernel's R16_STAMP(k), k < 5
# (R16_STAMP(5) ends the last)
PHASES = ("load pass (device memory, radix R0)", "forward radix-16 passes",
          "merged pass (last forward, spectrum, first inverse)",
          "inverse radix-16 passes", "store pass (radix R0, device memory)")
STAMPS = len(PHASES) + 1
# (B, H, L, n): SC09's three tiers at B4, the vocoder's deepest at B2
CASES = ((4, 128, 16000, 32768), (4, 256, 4000, 8192),
         (4, 512, 1000, 2048), (2, 512, 8960, 16384))
# kernels 5 and 5f: the phase that starts at each R16_STAMP(k), k < 5, of
# the kernel's chunk loop (the final cluster barrier is not stamped)
DKF_PHASES = ("load pass (device memory, radix R0)",
              "forward radix-16 passes",
              "last forward pass in place, split",
              "cluster barrier (the peers' transforms)",
              "batch sum over the cluster's shared memory")
# (B, H, L, n): SC09's three tiers and d_model 256's top tier, at B4
DKF_CASES = ((4, 128, 16000, 32768), (4, 256, 4000, 8192),
             (4, 512, 1000, 2048), (4, 256, 16000, 32768))


def ptxas_report(nvcc, flags, csrc, out_dir):
    """Lines of ``-Xptxas -v`` about the shipped radix-16 instances:
    (instance, registers and spills), and the names of any functions
    compiled as calls."""
    r = subprocess.run(
        [nvcc, *flags, "-Xptxas", "-v", "-c", str(csrc / "fftconv.cu"),
         "-o", os.path.join(out_dir, "fftconv.o")],
        capture_output=True, text=True, check=True)
    log = (r.stdout + r.stderr).splitlines()
    out, calls, entries = [], [], set()
    for line in log:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.add(m.group(1))
    for i, line in enumerate(log):
        r16 = re.search(r"(fftconv_r16_kernel)ILi(\d+)ELb(\d)E"
                        r"(f|13__nv_bfloat16)E", line)
        dkf = re.search(r"(fftconv_dkf_r16_kernel)ILi(\d+)ELi(\d+)E"
                        r"(f|13__nv_bfloat16)E", line)
        if "Compiling entry" in line and r16:
            name, m, t, ty = r16.groups()
            args = (f"{m}, {'true' if t == '1' else 'false'}, "
                    f"{'float' if ty == 'f' else 'bf16'}")
        elif "Compiling entry" in line and dkf:
            name, m, q, t = dkf.groups()
            args = f"{m}, {q}, {'float' if t == 'f' else 'bf16'}"
        if "Compiling entry" in line and (r16 or dkf):
            rest = log[i + 1:i + 4]
            out.append((f"{name}<{args}>",
                        "; ".join(x.split(":", 1)[-1].strip() for x in rest
                                  if "spill" in x or "registers" in x)))
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
            if name not in entries:     # a device function left as a call
                calls.append(name)
    return out, calls


def main():
    import torch
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import cuda_lib
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "fftconv_phases")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, csrc = cuda_lib._nvcc(), cuda_lib._CSRC
    so = os.path.join(out_dir, "fftconv_stamped.so")
    subprocess.run([nvcc, *cuda_lib._FLAGS, "-DDWST_R16_STAMPS", "-shared",
                    str(csrc / "fftconv.cu"), "-o", so], check=True)
    lib = ctypes.CDLL(so)
    report, calls = ptxas_report(nvcc, cuda_lib._FLAGS, csrc, out_dir)
    for name, line in report:
        print(f"ptxas, {name}: {line}")
    print(f"functions compiled as calls: {calls or 'none'}")
    P, I = ctypes.c_void_p, ctypes.c_int
    sampling = lib.dwst_fftconv_r16_ln_bias_gelu_d_bf16
    sampling.argtypes = [P] * 7 + [I] * 6 + [P]
    conv = lib.dwst_fftconv_r16_bf16
    conv.argtypes = [P] * 3 + [I] * 7 + [P]
    lib.dwst_read_r16_stamps.argtypes = [P, I]
    dkf_entries = {torch.bfloat16: lib.dwst_fftconv_dkf_bf16,
                   torch.float32: lib.dwst_fftconv_dkf}
    for fn in dkf_entries.values():
        fn.argtypes = [P] * 3 + [I] * 7 + [P]

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for B, H, L, n in CASES:
        u = torch.randn(B, H, L, device=dev, generator=g).to(torch.bfloat16)
        khat = torch.fft.rfft(0.05 * torch.randn(H, min(L, 16000),
                                                 device=dev, generator=g),
                              n=n)
        a = 0.5 + torch.rand(B, L, device=dev, generator=g)
        c = 0.3 * torch.randn(B, L, device=dev, generator=g)
        bias = 0.3 * torch.randn(B, H, device=dev, generator=g)
        D = torch.randn(H, device=dev, generator=g)
        out, plan = torch.empty_like(u), fc.radix16_plan(n)
        for form in ("sampling", "conv", "conj"):
            def call():
                stream = torch.cuda.current_stream().cuda_stream
                if form == "sampling":
                    e = sampling(u.data_ptr(), a.data_ptr(), c.data_ptr(),
                                 bias.data_ptr(), khat.data_ptr(),
                                 D.data_ptr(), out.data_ptr(), B, H, L, n,
                                 plan.threads, plan.smem, stream)
                else:
                    e = conv(u.data_ptr(), khat.data_ptr(), out.data_ptr(),
                             B, H, L, n, int(form == "conj"), plan.threads,
                             plan.smem, stream)
                if e:
                    raise RuntimeError(f"stamped build: CUDA error {e}")
            for _ in range(3):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 10
            ref = (ops.fftconv_ln_bias_gelu_d_ref(u, a, c, bias, khat, D)
                   if form == "sampling"
                   else ops.fftconv_ref(u, khat, form == "conj"))
            diff = float((out.float() - ref.float()).abs().max())
            stamps = torch.zeros(4096, STAMPS, dtype=torch.int64)
            if lib.dwst_read_r16_stamps(stamps.data_ptr(), STAMPS):
                raise RuntimeError("reading the stamps failed")
            t = stamps[:min(B * H, 4096)].double()
            phases = (t[:, 1:] - t[:, :-1]).mean(0)
            total = float(t[:, -1].sub(t[:, 0]).mean())
            print(f"1f {form} B{B} H{H} L{L} n {n} (radices "
                  f"{plan.radices}, {plan.threads} threads; {ms:.4f} ms a "
                  f"call stamped; max abs diff to the plain version "
                  f"{diff:.3e}): {total:.0f} SM cycles a block")
            for label, cyc in zip(PHASES, phases.tolist()):
                print(f"  {label:52s} {cyc:8.0f} cycles  {cyc / total:6.1%}")

    for B, H, L, n in DKF_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, gx = (torch.randn(B, H, L, device=dev, generator=g)
                     .to(dtype) for _ in range(2))
            ref = ops.fftconv_dkf_ref(x, gx, n)
            plan = fc.dkf_plan(n, B)
            for rows in range(1, plan.rows + 1):
                run_dkf(torch, lib, dkf_entries[dtype], x, gx, n,
                        fc.dkf_plan(n, B, rows), ref)


def run_dkf(torch, lib, entry, u, g, n, plan, ref):
    """Kernel 5 or 5f (``entry``) on the radix-16 route of ``plan``, timed
    over 10 calls of the stamped build, its phases printed."""
    B, H, L = u.shape
    out = torch.empty_like(ref)

    def call():
        e = entry(u.data_ptr(), g.data_ptr(), out.data_ptr(), B, H, L, n,
                  plan.rows, plan.threads, plan.smem,
                  torch.cuda.current_stream().cuda_stream)
        if e:
            raise RuntimeError(f"stamped build: CUDA error {e}")
    for _ in range(3):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        call()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 10
    diff = float((out - ref).abs().max())
    stamps = torch.zeros(4096, STAMPS, dtype=torch.int64)
    if lib.dwst_read_r16_stamps(stamps.data_ptr(), STAMPS):
        raise RuntimeError("reading the stamps failed")
    t = stamps[:min(plan.cluster * H, 4096)].double()
    phases = (t[:, 1:] - t[:, :-1]).mean(0)
    total = float(t[:, -1].sub(t[:, 0]).mean())
    form = "5f" if u.dtype == torch.bfloat16 else "5"
    print(f"{form} B{B} H{H} L{L} n {n} rows {plan.rows} ({plan.per_block} "
          f"transforms a block, a cluster of {plan.cluster}, {plan.threads} "
          f"threads; {ms:.4f} ms a call "
          f"stamped; max abs diff to the plain version {diff:.3e}): "
          f"{total:.0f} SM cycles a block, the last chunk")
    for label, cyc in zip(DKF_PHASES, phases.tolist()):
        print(f"  {label:52s} {cyc:8.0f} cycles  {cyc / total:6.1%}")


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # no card, a build or a kernel failed
        print(f"fftconv_phases FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        sys.exit(1)
