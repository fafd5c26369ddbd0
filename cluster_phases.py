#!/usr/bin/env python3
"""Where kernel 9f's cluster route spends its time, phase by phase.

    python3 cluster_phases.py        # from the repository root, one GPU

A profiler trace sees a kernel only as a whole.  This script builds
``diffwave_sashimi_torch/csrc/fftconv_long.cu`` with
``-DDWST_PHASE_STAMPS`` into ``build/cluster_phases/``: thread 0 of every
block of ``fftconv_cluster_kernel`` then records ``clock64()`` at each
phase boundary (the source's ``STAMP``s, empty in the shipped build).  It
runs 9f's cluster route at the bf16 vocoder's top tier (B2 H128 L143360,
n 2^18, clusters of 16; the shipped route there is the three passes) and
middle tier (B2 H256 L35840, n 2^16, clusters of 4) and prints the mean SM
cycles of each phase over the blocks.  It also times the rate at which the
blocks of a cluster store into each other's shared memory (each of 1024
threads stores 16 8-byte values into a peer's, 128 KB a block, as the
kernel's exchanges do), for clusters of 16, 8 and 4, and prints what
``nvcc -Xptxas -v`` reports of the shipped build's cluster kernels
(registers a thread, spills), and the card's name and power limit.
"""

import ctypes
import os
import re
import subprocess
import sys

# the phase that starts at each of the kernel's STAMP(k), k < 11 (STAMP(11)
# ends the last)
PHASES = ("load", "column FFTs", "exchange 1: local reads, cluster sync",
          "exchange 1: stores to the peers", "exchange 1: cluster sync",
          "row FFTs, spectrum, inverse",
          "exchange 2: local reads, cluster sync",
          "exchange 2: stores to the peers", "exchange 2: cluster sync",
          "inverse column FFTs", "store")
STAMPS = len(PHASES) + 1

RATE_SRC = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__device__ long long rate_cycles[4096];
template <int C>
__global__ void __launch_bounds__(1024, 1) push_kernel() {
  extern __shared__ float2 z[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  for (int i = threadIdx.x; i < 16384; i += 1024) z[i] = make_float2(i, 0);
  cl.sync();
  const long long t0 = clock64();
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int x = threadIdx.x + e * 1024;
    unsigned a;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a)
        : "r"((unsigned)__cvta_generic_to_shared(z + x)),
          "r"(x / (16384 / C)));
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" :: "r"(a),
                 "f"((float)e), "f"((float)x));
  }
  cl.sync();
  if (threadIdx.x == 0) rate_cycles[blockIdx.x] = clock64() - t0;
}
template <int C>
static int run(int clusters, long long* out) {
  auto k = push_kernel<C>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 131072);
  cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = 131072;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = C;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  for (int rep = 0; rep < 3; ++rep) cudaLaunchKernelEx(&cfg, k);
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, rate_cycles,
                             sizeof(long long) * clusters * C);
  return (int)e;
}
extern "C" int push_rate(int C, int clusters, long long* out) {
  return C == 16 ? run<16>(clusters, out) : C == 8 ? run<8>(clusters, out)
                                                   : run<4>(clusters, out);
}
'''


def build(name, src, out_dir, nvcc, flags):
    lib = os.path.join(out_dir, name + ".so")
    subprocess.run([nvcc, *flags, "-shared", str(src), "-o", lib],
                   check=True)
    return ctypes.CDLL(lib)


def ptxas_report(nvcc, flags, csrc, out_dir):
    """(kernel, what ptxas says of its registers and spills) for each
    instance of the shipped fftconv_cluster_kernel."""
    r = subprocess.run(
        [nvcc, *flags, "-Xptxas", "-v", "-c", str(csrc / "fftconv_long.cu"),
         "-o", os.path.join(out_dir, "fftconv_long.o")],
        capture_output=True, text=True, check=True)
    log = (r.stdout + r.stderr).splitlines()
    out = []
    for i, line in enumerate(log):
        if "Compiling entry" in line and "fftconv_cluster_kernel" in line:
            rest = log[i + 1:i + 4]
            n1, n2 = re.search(r"cluster_kernelILi(\d+)ELi(\d+)E",
                               line).groups()
            out.append((f"<{n1}, {n2}>", "; ".join(
                x.split(":", 1)[-1].strip() for x in rest
                if "spill" in x or "registers" in x)))
    return out


def main():
    import importlib

    import torch
    from diffwave_sashimi_torch.ops import cuda_lib
    fl = importlib.import_module("diffwave_sashimi_torch.ops.fftconv_long")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "cluster_phases")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, csrc = cuda_lib._nvcc(), cuda_lib._CSRC
    lib = build("fftconv_long_stamped", csrc / "fftconv_long.cu", out_dir,
                nvcc, [*cuda_lib._FLAGS, "-DDWST_PHASE_STAMPS"])
    rate_src = os.path.join(out_dir, "push_rate.cu")
    with open(rate_src, "w") as f:
        f.write(RATE_SRC)
    rate = build("push_rate", rate_src, out_dir, nvcc, cuda_lib._FLAGS)
    for name, report in ptxas_report(nvcc, cuda_lib._FLAGS, csrc, out_dir):
        print(f"ptxas, fftconv_cluster_kernel{name}: {report}")
    P, I = ctypes.c_void_p, ctypes.c_int
    conv = lib.dwst_fftconv_long_ln_bias_gelu_d_bf16
    conv.argtypes = [P] * 8 + [I] * 8 + [P]
    lib.dwst_read_stamps.argtypes = [P, I]
    rate.push_rate.argtypes = [I, I, P]

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for B, H, L, n in ((2, 128, 143360, 1 << 18), (2, 256, 35840, 1 << 16)):
        u = torch.randn(B, H, L, device=dev, generator=g).to(torch.bfloat16)
        k = torch.zeros(H, n, device=dev)
        k[:, :4000] = 0.05 * torch.randn(H, 4000, device=dev, generator=g)
        kp = fl.long_spectrum(torch.fft.rfft(k, n=n))
        a = 0.5 + torch.rand(B, L, device=dev, generator=g)
        c = 0.3 * torch.randn(B, L, device=dev, generator=g)
        bias = 0.3 * torch.randn(B, H, device=dev, generator=g)
        D = torch.randn(H, device=dev, generator=g)
        out, plan = torch.empty_like(u), fl.cluster_plan(n)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):
            err = conv(u.data_ptr(), a.data_ptr(), c.data_ptr(),
                       bias.data_ptr(), kp.data_ptr(), D.data_ptr(), None,
                       out.data_ptr(), B, H, L, n, *plan[1:], stream)
            if err:
                raise RuntimeError(f"stamped build: CUDA error {err}")
        torch.cuda.synchronize()
        ref = fl.fftconv_long_ln_bias_gelu_d_bf16_ref(u, a, c, bias, kp, D)
        diff = float((out.float() - ref.float()).abs().max())
        stamps = torch.zeros(4096, STAMPS, dtype=torch.int64)
        if lib.dwst_read_stamps(stamps.data_ptr(), STAMPS):
            raise RuntimeError("reading the stamps failed")
        blocks = (B + 1) // 2 * H * plan.cluster
        t = stamps[:blocks].double()
        phases = (t[:, 1:] - t[:, :-1]).mean(0)
        total = float(t[:, -1].sub(t[:, 0]).mean())
        print(f"9f B{B} H{H} L{L} n {n} (clusters of {plan.cluster}; max "
              f"abs diff to the plain version {diff:.3e}): {total:.0f} SM "
              f"cycles a block and row, from the load to the store's end")
        for label, cyc in zip(PHASES, phases.tolist()):
            print(f"  {label:40s} {cyc:9.0f} cycles  {cyc / total:6.1%}")
    for C, clusters in ((16, 7), (8, 15), (4, 30)):
        cyc = torch.zeros(clusters * C, dtype=torch.int64)
        if rate.push_rate(C, clusters, cyc.data_ptr()):
            raise RuntimeError("the store-rate kernel failed")
        mean = float(cyc.double().mean())
        print(f"stores into the peers' shared memory, clusters of {C} "
              f"({clusters} at once): {mean:.0f} cycles for 128 KB a block, "
              f"{131072 / mean:.1f} bytes a cycle")


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # no card, a build or a kernel failed
        print(f"cluster_phases FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        sys.exit(1)
