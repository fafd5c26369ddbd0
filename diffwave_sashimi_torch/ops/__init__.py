"""Ops of the port: the kernel wrappers and their plain versions.

:data:`FUSED` routes the model through the kernel wrappers (the CUDA
kernels on CUDA tensors, the plain versions on CPU tensors); the training
entries are autograd Functions whose backward passes are kernels too.
:data:`PLAIN` routes it through the plain PyTorch versions everywhere and
trains through torch autograd of the plain forwards, which is how a run on
the card compares the kernels' outputs and gradients with plain ones.
:data:`FUSED_INT8` and :data:`PLAIN_INT8` are the same with the sampling
conv swapped for the int8 conv (kernel 12; ``+compute.conv_int8=true``).
Every wrapper takes the bf16 path's form (kernels 1f or 9f, 2f, 3f and
11f at sampling; 1f's training entry, 5f, 6f, 7f in training) for bf16
activations, by the tensors' dtype; past kernel 1's FFT sizes the training
conv takes kernel 9's training entries and kernel 5L at either precision,
each reading bf16 activations as they are.
"""

from typing import Callable, NamedTuple

from .cauchy import (cauchy_bwd, cauchy_bwd_ref, cauchy_quad,
                     cauchy_quad_ref, cauchy_sym, cauchy_sym_fused)
from .chmix import (glu_res_bwd, glu_res_bwd_bf16, glu_res_bwd_ref,
                    glu_res_ref, ln_ff_res, ln_ff_res_bf16, ln_ff_res_bwd,
                    ln_ff_res_bwd_bf16, ln_ff_res_bwd_ref, ln_ff_res_ref,
                    ln_ff_res_train, mix_glu_res, mix_glu_res_bf16,
                    mix_glu_res_train)
from .fftconv import (fftconv, fftconv_bf16, fftconv_dkf, fftconv_dkf_bf16,
                      fftconv_dkf_ref, fftconv_ln_bias_gelu_d,
                      fftconv_ln_bias_gelu_d_bf16, fftconv_ln_bias_gelu_d_ref,
                      fftconv_ref, fftconv_train, gelu_fast, gelu_fast_grad,
                      widen)
from .int8conv import (fftconv_int8, fftconv_int8_ref, int8_spectrum,
                       s4_conv_int8, s4_conv_int8_ref)
from .fftconv_long import (fftconv_dkf_long, fftconv_long,
                           fftconv_long_ln_bias_gelu_d,
                           fftconv_long_ln_bias_gelu_d_bf16,
                           fftconv_long_ln_bias_gelu_d_bf16_ref,
                           fftconv_long_ln_bias_gelu_d_ref, fftconv_long_ref,
                           fftconv_long_train, long_spectrum, s4_conv,
                           s4_conv_ref, sampling_spectrum)
from .wavenet_gate import gate_res_skip, gate_res_skip_bf16, gate_res_skip_ref


class Ops(NamedTuple):
    conv: Callable        # kernel 1 or 9 by FFT size (or 12): fused S4 conv
    glu: Callable         # kernel 2: output linear + GLU + residual
    ff: Callable          # kernel 3: norm2 + FF + residual (+ skip, stats)
    cauchy: Callable      # kernels 4 (+ 8): Cauchy sum of the S4 kernel
    conv_train: Callable  # kernels 1 (+ conj) and 5, or 9 (+ conj) and 5L
    glu_train: Callable   # kernels 2 and 6
    ff_train: Callable    # kernels 3 and 7
    gate: Callable        # kernel 11 (11f): WaveNet gate + res/skip tail
    # (khat, L) -> the sampling conv's spectrum, built once per run
    spectrum: Callable = sampling_spectrum


FUSED = Ops(s4_conv, mix_glu_res, ln_ff_res, cauchy_sym_fused,
            fftconv_train, mix_glu_res_train, ln_ff_res_train, gate_res_skip)
PLAIN = Ops(s4_conv_ref, glu_res_ref, ln_ff_res_ref,
            cauchy_sym, fftconv_ref, glu_res_ref, ln_ff_res_ref,
            gate_res_skip_ref)
FUSED_INT8 = FUSED._replace(conv=s4_conv_int8, spectrum=int8_spectrum)
PLAIN_INT8 = PLAIN._replace(conv=s4_conv_int8_ref, spectrum=int8_spectrum)

# every kernel wrapper with a launch count, by kernel name
COUNTED = {"fftconv_ln_bias_gelu_d": fftconv_ln_bias_gelu_d,
           "glu_res": mix_glu_res, "ln_ff_res": ln_ff_res,
           "cauchy": cauchy_quad, "fftconv": fftconv,
           "fftconv_dkf": fftconv_dkf, "glu_res_bwd": glu_res_bwd,
           "ln_ff_res_bwd": ln_ff_res_bwd, "cauchy_bwd": cauchy_bwd,
           "fftconv_long_ln_bias_gelu_d": fftconv_long_ln_bias_gelu_d,
           "fftconv_long": fftconv_long,
           "fftconv_dkf_long": fftconv_dkf_long,
           "gate_res_skip": gate_res_skip,
           "fftconv_ln_bias_gelu_d_bf16": fftconv_ln_bias_gelu_d_bf16,
           "glu_res_bf16": mix_glu_res_bf16, "ln_ff_res_bf16": ln_ff_res_bf16,
           "fftconv_int8": fftconv_int8, "fftconv_bf16": fftconv_bf16,
           "fftconv_dkf_bf16": fftconv_dkf_bf16,
           "glu_res_bwd_bf16": glu_res_bwd_bf16,
           "ln_ff_res_bwd_bf16": ln_ff_res_bwd_bf16,
           "fftconv_long_ln_bias_gelu_d_bf16":
               fftconv_long_ln_bias_gelu_d_bf16,
           "gate_res_skip_bf16": gate_res_skip_bf16}
