"""Ops of the port: the four kernel wrappers and their plain versions.

:data:`FUSED` routes the model through the kernel wrappers (the CUDA
kernels on CUDA tensors, the plain versions on CPU tensors); :data:`PLAIN`
routes it through the plain PyTorch versions everywhere, which is how a
run on the card compares the kernels' model output with the plain one.
"""

from typing import Callable, NamedTuple

from .cauchy import cauchy_sym, cauchy_sym_fused
from .chmix import glu_res_ref, ln_ff_res, ln_ff_res_ref, mix_glu_res
from .fftconv import fftconv_ln_bias_gelu_d, fftconv_ln_bias_gelu_d_ref


class Ops(NamedTuple):
    conv: Callable      # kernel 1: fused S4 FFT conv (+ norm1/bias, D, GELU)
    glu: Callable       # kernel 2: output linear + GLU + residual
    ff: Callable        # kernel 3: norm2 + FF + residual (+ skip, stats)
    cauchy: Callable    # kernel 4: Cauchy sum of the S4 kernel construction


FUSED = Ops(fftconv_ln_bias_gelu_d, mix_glu_res, ln_ff_res, cauchy_sym_fused)
PLAIN = Ops(fftconv_ln_bias_gelu_d_ref, glu_res_ref, ln_ff_res_ref,
            cauchy_sym)
