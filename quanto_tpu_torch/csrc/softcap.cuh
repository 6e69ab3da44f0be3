// The logit softcap c tanh(x / c) (Gemma-2's attention logits), shared by flash_prefill.cu and the
// flash_decode arms.

#pragma once

// c tanh(x / c) as c - 2 c / (1 + 2^(k x)), k = 2 log2(e) / c: one ex2 and a fast reciprocal
// (tanhf's own way for |x / c| >= 0.6, here for all x), within about 1e-7 c of tanh. Not
// tanh.approx.f32: at c = 50 its error would move a logit by about 0.02.
static __device__ __forceinline__ float softcap(float x, float k, float c) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * k));
  return c - __fdividef(2.0f * c, 1.0f + e);
}
