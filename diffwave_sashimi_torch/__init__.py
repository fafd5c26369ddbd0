"""diffwave_sashimi_torch: the PyTorch + CUDA port of diffwave_sashimi_tpu.

The JAX package beside it is the reference this port is held against.  The
port keeps the reference's flat (B, H, L) activation layout and its torch
state-dict names, and runs the SaShiMi S4 blocks through four hand-written
Hopper kernels (``csrc/``): the fused S4 FFT convolution, the fused output
linear + GLU + residual, the fused norm + feed-forward + residual, and the
Cauchy sum that builds the S4 kernels.  On a CPU tensor each kernel wrapper
runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
