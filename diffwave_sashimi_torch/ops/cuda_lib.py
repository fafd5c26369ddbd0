"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one library.

Each source is compiled by its own ``nvcc`` process (all started together)
into an object file, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``.  The build happens at first use,
into ``build/diffwave_sashimi_torch/<hash>/`` under the repository root,
keyed by a hash of the sources and flags, so an unchanged checkout reuses it.

Nothing here runs at import time: the CPU tests import every module of the
port on machines that have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "diffwave_sashimi_torch"
_SOURCES = ("fftconv.cu", "fftconv_long.cu", "fftconv_int8.cu", "chmix.cu",
            "cauchy.cu", "wavenet_gate.cu")
_HEADERS = ("fft_stockham.cuh", "activations.cuh", "mma_bf16.cuh",
            "mma_tf32.cuh", "cp_async.cuh")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as
# c_void_p so 64-bit addresses are not cut to 32-bit ints).
_SIGNATURES = {
    # u, a, c, bias, khat, D, out, B, H, L, n, stream (the _bf16 forms:
    # the same arguments, the activations bf16)
    "dwst_fftconv_ln_bias_gelu_d": [_P] * 7 + [_I] * 4 + [_P],
    "dwst_fftconv_ln_bias_gelu_d_bf16": [_P] * 7 + [_I] * 4 + [_P],
    # kernels 1's and 1f's radix-16 route: the same arguments and its plan
    # (threads, smem; ops/fftconv.py::conv_plan) before the stream
    "dwst_fftconv_r16_ln_bias_gelu_d": [_P] * 7 + [_I] * 6 + [_P],
    "dwst_fftconv_r16_ln_bias_gelu_d_bf16": [_P] * 7 + [_I] * 6 + [_P],
    # The channel mixers (kernels 2, 3, 6, 7 and their f forms) take P
    # (positions a block) and smem (its bytes of shared memory) from their
    # plans in ops/chmix.py, after their other ints.
    # kernel 2: y, res, W, b, out, wf (the split weight scratch), B, H, L,
    # and the plan (ops/chmix.py::glu_tf32_plan: P, blocks an SM, smem),
    # stream
    "dwst_glu_res": [_P] * 6 + [_I] * 6 + [_P],
    # the same with y, res and out bf16 and wb (the bf16 weight scratch)
    # after out
    "dwst_glu_res_bf16": [_P] * 6 + [_I] * 5 + [_P],
    # kernel 3: x, skip, W1, b1, W2, b2, m, s, out, mean, var, wf (the split
    # weight scratch), B, H, F, L, and the plan (ops/chmix.py::ff_tf32_plan:
    # P, FC hidden rows a chunk, blocks an SM, smem), stream
    "dwst_ln_ff_res": [_P] * 12 + [_I] * 8 + [_P],
    # the same with x, skip and out bf16 and wb (bf16 weight scratch, or
    # null) after var
    "dwst_ln_ff_res_bf16": [_P] * 12 + [_I] * 6 + [_P],
    # u, a, c, bias, khat, D, W, qc, qs, out, B, H, L, n, R, S, Rc, bf16,
    # and the plan (ops/int8conv.py::plan_args: threads, smem, b_off,
    # f_off, four stage offsets, panels, chunk, er_chunked, prefetch),
    # stream
    "dwst_fftconv_int8": [_P] * 10 + [_I] * 20 + [_P],
    # kernel 4: a, b, c, d, z, out, K, M, N, Lz, and its plan (threads,
    # splits, smem; ops/cauchy.py::cauchy_fwd_plan) before the stream
    "dwst_cauchy": [_P] * 6 + [_I] * 7 + [_P],
    # u, khat, out, B, H, L, n, conj, stream (the _bf16 forms of this and
    # the three training entries below: the same arguments, the
    # activations bf16)
    "dwst_fftconv": [_P] * 3 + [_I] * 5 + [_P],
    "dwst_fftconv_bf16": [_P] * 3 + [_I] * 5 + [_P],
    # the same, kernels 1's and 1f's radix-16 route, with threads and smem
    # before the stream
    "dwst_fftconv_r16": [_P] * 3 + [_I] * 7 + [_P],
    "dwst_fftconv_r16_bf16": [_P] * 3 + [_I] * 7 + [_P],
    # u, g, out, B, H, L, n, and the plan (rows, threads, smem; ops/
    # fftconv.py::dkf_plan; rows 0 the Stockham kernel), stream
    "dwst_fftconv_dkf": [_P] * 3 + [_I] * 7 + [_P],
    "dwst_fftconv_dkf_bf16": [_P] * 3 + [_I] * 7 + [_P],
    # kernel 6: y, g, W, b, dy, dz, part, grads, wf (the split weight
    # scratch), B, H, L, tc, and the plan (ops/chmix.py::glu_bwd_tf32_plan:
    # P, blocks an SM, smem), stream
    "dwst_glu_res_bwd": [_P] * 9 + [_I] * 7 + [_P],
    # kernel 6f: y, g, W, b, dy, dz, part, grads, wb (the bf16 weight
    # scratch), B, H, L, tc, P, smem, stream (y, g, dy bf16)
    "dwst_glu_res_bwd_bf16": [_P] * 9 + [_I] * 6 + [_P],
    # x, g, W1, b1, W2, m, s, dx, xn, hact, dz, stat_part, dms, part1,
    # grads1, part2, grads2, wf (the split-weight scratch), B, H, F, L, tc,
    # P, smem, stream
    "dwst_ln_ff_res_bwd": [_P] * 18 + [_I] * 7 + [_P],
    # kernel 7f: x, g, W1, b1, W2, m, s, dx, the same scratch and
    # gradients, wb (the bf16 weight scratch), B, H, F, L, tc, P, smem,
    # stream (x, g, dx bf16)
    "dwst_ln_ff_res_bwd_bf16": [_P] * 18 + [_I] * 7 + [_P],
    # kernel 8: a, b, c, d, z, g_re, g_im, gstride, out, part, K, M, N,
    # Lz, and its plan (span, splits, smem; ops/cauchy.py::
    # cauchy_bwd_plan) before the stream
    "dwst_cauchy_bwd": [_P] * 7 + [_I] + [_P] * 2 + [_I] * 7 + [_P],
    # u, a, c, bias, kp, D, scratch, out, B, H, L, n, stream
    "dwst_fftconv_long_ln_bias_gelu_d": [_P] * 8 + [_I] * 4 + [_P],
    # kernel 9f: the same arguments, u and out bf16, and its route's plan
    # (cluster, cols, rows, smem; ops/fftconv_long.py::long_plan) before
    # the stream
    "dwst_fftconv_long_ln_bias_gelu_d_bf16": [_P] * 8 + [_I] * 8 + [_P],
    # u, kp, scratch, out, B, H, L, n, conj, stream (u, out f32 or bf16)
    "dwst_fftconv_long": [_P] * 4 + [_I] * 5 + [_P],
    "dwst_fftconv_long_bf16": [_P] * 4 + [_I] * 5 + [_P],
    # kernel 5L: u, g, scratch, out, B, H, L, n, its route's blocks a
    # cluster (ops/fftconv_long.py::dkf_long_plan), stream (u, g f32 or
    # bf16)
    "dwst_fftconv_dkf_long": [_P] * 4 + [_I] * 5 + [_P],
    "dwst_fftconv_dkf_long_bf16": [_P] * 4 + [_I] * 5 + [_P],
    # n, smem (no stream): the clusters of 9f's cluster route the card
    # holds at once; 5L's: n
    "dwst_fftconv_long_max_clusters": [_I] * 2,
    "dwst_fftconv_dkf_long_max_clusters": [_I],
    # kernel 11: h, x, Wr, br, Ws, bs, res, skip, wf (the split weight
    # scratch), B, C, S, L, and the plan (ops/wavenet_gate.py::
    # gate_tf32_plan: P, blocks an SM, smem), stream
    "dwst_gate_res_skip": [_P] * 9 + [_I] * 7 + [_P],
    # kernel 11f: the same with h, x, res and skip bf16, wf (the bf16
    # weight scratch) after skip, and P and smem (ops/wavenet_gate.py::
    # gate_bf16_plan) after L
    "dwst_gate_res_skip_bf16": [_P] * 9 + [_I] * 6 + [_P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (torch.utils."
                           "cpp_extension.CUDA_HOME is None): the port's "
                           "kernels need nvcc to build")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for name in _SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *_FLAGS, "-c", str(_CSRC / name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}:\n{log.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        tmp_so = os.path.join(tmp, out.name)
        subprocess.run([nvcc, "-shared", *_FLAGS[:2], *objs, "-o", tmp_so],
                       check=True, capture_output=True)
        os.replace(tmp_so, out)       # atomic: a reader never sees half


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    out = _BUILD / _source_hash() / "libdwst_kernels.so"
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The number of SMs of a CUDA device."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(t, shape, dtype) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of shape and dtype:
    the kernels take raw pointers and trust these."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"kernel argument must be a contiguous CUDA {dtype} "
                         f"tensor of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def launch(name: str, *args) -> None:
    """Call a kernel entry point on the current stream; raise on a refused
    launch (the C side returns ``cudaGetLastError()``)."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
