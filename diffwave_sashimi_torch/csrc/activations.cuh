// Activations and bf16 I/O helpers shared by the kernels.
//
// gelu_erf is the exact GELU of the f32 path.  gelu_fast is the bf16
// path's polynomial GELU, diffwave_sashimi_tpu/ops/fftconv2.py::
// _gelu_fast with its coefficients and clamp: a weighted least-squares fit
// of gelu(x) - x/2 as a degree-7 polynomial in x^2 on [-4, 4], |err| <
// 1.3e-3, x itself above 4; gelu_fast_and_grad also gives its derivative.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dwst_act {

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// gelu_fast's polynomial in x2 = xc^2, xc = x clamped to [-4, 4].
__device__ __forceinline__ float gelu_fast_poly(float x2) {
  float p = 2.95654090e-08f;
  p = p * x2 + -1.95562042e-06f;
  p = p * x2 + 5.52706534e-05f;
  p = p * x2 + -8.87377753e-04f;
  p = p * x2 + 9.14217304e-03f;
  p = p * x2 + -6.54241398e-02f;
  p = p * x2 + 3.98530402e-01f;
  return p;
}

__device__ __forceinline__ float gelu_fast(float x) {
  const float xc = fminf(fmaxf(x, -4.0f), 4.0f);
  const float x2 = xc * xc;
  const float y = 0.5f * xc + x2 * gelu_fast_poly(x2);
  return x > 4.0f ? x : y;
}

// gelu_fast(x), and in *grad its derivative
// (diffwave_sashimi_tpu/ops/chmix.py::_gelu_fast_grad): 0.5 + 2 x (p + x^2
// p') on [-4, 4], p' the derivative of the polynomial in x^2
// (coefficients i c_i, formed in double as JAX forms them); 1 above 4, 0
// below -4.
__device__ __forceinline__ float gelu_fast_and_grad(float x, float* grad) {
  const float xc = fminf(fmaxf(x, -4.0f), 4.0f);
  const float x2 = xc * xc;
  const float p = gelu_fast_poly(x2);
  float pp = (float)(6.0 * 2.95654090e-08);
  pp = pp * x2 + (float)(5.0 * -1.95562042e-06);
  pp = pp * x2 + (float)(4.0 * 5.52706534e-05);
  pp = pp * x2 + (float)(3.0 * -8.87377753e-04);
  pp = pp * x2 + (float)(2.0 * 9.14217304e-03);
  pp = pp * x2 + -6.54241398e-02f;
  const float inner = 0.5f + 2.0f * xc * (p + x2 * pp);
  *grad = x > 4.0f ? 1.0f : (x < -4.0f ? 0.0f : inner);
  const float y = 0.5f * xc + x2 * p;
  return x > 4.0f ? x : y;
}

// Activation I/O as float or bf16 (round to nearest even on store).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the nearest bf16, as a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace dwst_act
