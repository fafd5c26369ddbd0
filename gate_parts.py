#!/usr/bin/env python3
"""What kernel 11f's time is made of, measured by taking parts away.

    python3 gate_parts.py        # from the repository root, one GPU

A profiler trace sees a kernel only as a whole.  This script builds
variants of ``diffwave_sashimi_torch/csrc/wavenet_gate.cu`` into
``build/gate_parts/``, each a copy of the source with one edit, and times
each variant's ``dwst_gate_res_skip_bf16`` in turns with the shipped
source, by CUDA events, at the bf16 WaveNet's shapes (B4 and B16, C256
S256 L16000; B4 C128 S256 L8960) at every P the kernel is built for:

- ``shipped``: the source as it is;
- ``no_h``: h not read (the gate formed from zeros): x's reads, the
  products, the epilogue and the stores;
- ``prefetch_by_copy``: the A fragments one k-step ahead through a
  register copy (``mma_bf16.cuh::warp_gemm_frag``, kernels 2f's, 3f's and
  7f's loop) instead of the compile-time ring (``warp_gemm_ring``);
- ``no_gemm``: the products skipped (the sums left 0): loads, gate,
  epilogue and stores alone;
- ``no_gemm_no_gate``: also the gate's tanh and sigmoid replaced by a
  product: the kernel's data movement alone.

The variants other than ``shipped`` compute other functions; only the
shipped one is checked against the plain version here.  It also prints
what ``nvcc -Xptxas -v`` reports of each variant's tensor-core kernel
(registers a thread, spills), the bytes' bound of each shape, and the
card's name and power limit.
"""

import ctypes
import math
import os
import re
import subprocess
import sys

RING = "dwst_mma::warp_gemm_ring<MT, N8, T::AHEAD>(Wf,"
GATE = "f[j] = j < n ? tanhf(fa[j]) / (1.0f + expf(-fg[j])) : 0.0f;"
GEMM_CALL = "    if (active)\n      " + RING
NO_GEMM = ("#pragma unroll\n    for (int mt = 0; mt < MT; ++mt)\n"
           "#pragma unroll\n      for (int j = 0; j < N8; ++j)\n"
           "#pragma unroll\n        for (int e = 0; e < 4; ++e) "
           "acc[mt][j][e] = 0.0f;\n    if (false)\n      " + RING)
LOADS = ("av[u] = load8(hb + (size_t)k * L, m, vec);",
         "gv[u] = load8(hb + (size_t)(C + k) * L, m, vec);")
VARIANTS = {
    "shipped": (),
    "no_h": tuple((load, load.split(" = ")[0] + " = zero;")
                  for load in LOADS),
    "prefetch_by_copy": ((RING, "dwst_mma::warp_gemm_frag<MT, N8>(Wf,"),),
    "no_gemm": ((GEMM_CALL, NO_GEMM),),
    "no_gemm_no_gate": ((GEMM_CALL, NO_GEMM),
                        (GATE, "f[j] = fa[j] * fg[j];")),
}
SHAPES = ((4, 256, 256, 16000), (16, 256, 256, 16000), (4, 128, 256, 8960))
PEAK_BYTES = 3.35e12              # the H100's HBM rate (B/s)


def build():
    """Each variant's source written and compiled, all at once, into
    build/gate_parts/<name>.so; returns {name: the loaded entry point}."""
    from diffwave_sashimi_torch.ops import cuda_lib
    src = (cuda_lib._CSRC / "wavenet_gate.cu").read_text()
    out = os.path.join("build", "gate_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"gate_parts: variant {name}: the source "
                                 f"no longer holds {old!r} once")
            text = text.replace(old, new)
        path = os.path.join(out, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib._FLAGS, "-I", str(cuda_lib._CSRC),
             "-Xptxas", "-v", "-shared", path, "-o",
             os.path.join(out, name + ".so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"gate_parts: nvcc failed on {name}\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"gate_res_skip_tc_kernelILi(\d+)E", line)
            if m and "Compiling" in line:
                info = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", info)
                spill = re.search(r"(\d+) bytes spill stores", info)
                print(f"ptxas {name} P{m.group(1)}: "
                      f"{regs.group(1) if regs else '?'} registers, "
                      f"{spill.group(1) if spill else '?'} bytes of spill "
                      f"stores")
        fn = getattr(ctypes.CDLL(os.path.abspath(
            os.path.join(out, name + ".so"))), "dwst_gate_res_skip_bf16")
        fn.argtypes = cuda_lib._SIGNATURES["dwst_gate_res_skip_bf16"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def cuda_ms(torch, fn, reps=20):
    """Mean ms per call of fn() by CUDA events, after 3 warm-up calls."""
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gate_parts: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from diffwave_sashimi_torch.ops import wavenet_gate as wg
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    entries = build()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, C, S, L in SHAPES:
        wr, br, ws, bs = (torch.randn(*shape, device=dev, generator=gen)
                          / math.sqrt(C) for shape in
                          ((C, C), (C,), (S, C), (S,)))
        h = torch.randn(B, 2 * C, L, device=dev, generator=gen).bfloat16()
        x = torch.randn(B, C, L, device=dev, generator=gen).bfloat16()
        res, skip = torch.empty_like(x), x.new_empty((B, S, L))
        wf = x.new_empty((16 * -(-(C + S) // 16) * 16 * -(-C // 16),))
        ref = wg.gate_res_skip_ref(h, x, wr, br, ws, bs)
        nbytes = (4 * C + S) * B * L * 2 + (C * C + C + S * C + S) * 4
        shipped_p = wg.gate_bf16_plan(B, C, S, L)[0]
        for P in wg.GATE_BF16_PS:
            kp, mp = 16 * -(-C // 16), 16 * -(-(C + S) // 16)
            smem = (kp + min(mp, wg.GATE_BF16_ROWS[P])) * (P + 8) * 2

            def call(fn):
                return lambda: fn(
                    h.data_ptr(), x.data_ptr(), wr.data_ptr(),
                    br.data_ptr(), ws.data_ptr(), bs.data_ptr(),
                    res.data_ptr(), skip.data_ptr(), wf.data_ptr(), B, C, S,
                    L, P, smem, stream)
            if call(entries["shipped"])() != 0:
                raise SystemExit(f"gate_parts: launch refused at P{P}")
            torch.cuda.synchronize()
            err = max(float((o.float() - r.float()).abs().max()
                            / max(1.0, float(r.float().abs().max())))
                      for o, r in zip((res, skip), ref))
            if not err <= 1e-2:
                raise SystemExit(f"gate_parts: shipped kernel off by {err}")
            times, turns = {}, []
            for name, fn in entries.items():        # in turns with shipped
                turns.append(cuda_ms(torch, call(entries["shipped"])))
                times[name] = cuda_ms(torch, call(fn))
            print(f"B{B} C{C} S{S} L{L} P{P}"
                  f"{' (the plan)' if P == shipped_p else ''}: "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items())
                  + f"; shipped in turns {min(turns):.4f}-{max(turns):.4f}"
                  f"; bytes' bound {1e3 * nbytes / PEAK_BYTES:.4f} ms; "
                  f"max err {err:.2e}", flush=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
