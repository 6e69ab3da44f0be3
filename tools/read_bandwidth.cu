// Read bandwidth of the row patterns a decode-attention kernel meets on one card: rows of RB bytes
// every SB bytes (a KV cache [B, S, Hkv, row] read one head at a time has RB = row, SB = Hkv * row),
// 36 MB of them (the visible bytes of a qint4 cache at B = 4, S = 8192, Hkv = 8), read once with
// 16-byte loads past L1 by 8 blocks of 256 threads per SM, 8 loads in flight a thread. Each pattern
// is timed 5 times with CUDA events, a 256 MB memset before each run leaving L2 cold and dirty as
// chip_smoke.py's time_ms leaves it; the best run is printed: a plain streaming read of those bytes,
// to set beside a kernel's time under the same measurement.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o read_bandwidth tools/read_bandwidth.cu
//   ./read_bandwidth
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdint>
__global__ void rd(const uint8_t* base, long long nrows, int rb, int sb, unsigned* sink) {
  const int cpr = rb / 16;
  const long long total = nrows * cpr, step = (long long)gridDim.x * blockDim.x;
  unsigned acc = 0;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x; c < total; c += step * 8) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long cc = c + u * step;
      v[u] = make_uint4(0, 0, 0, 0);
      if (cc < total) v[u] = __ldcg(reinterpret_cast<const uint4*>(base + (cc / cpr) * sb + (cc % cpr) * 16));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x12345678u) sink[0] = acc;
}
int main() {
  uint8_t* buf; unsigned* sink; uint8_t* fl;
  cudaMalloc(&buf, 600ull << 20); cudaMalloc(&sink, 4); cudaMalloc(&fl, 256ull << 20);
  cudaMemset(buf, 1, 600ull << 20);
  const long long useful = 36ll << 20;
  int pats[][2] = {{64, 512}, {128, 1024}, {256, 512}, {256, 2048}, {512, 512}, {1024, 2048}, {2048, 2048}};
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  for (auto& p : pats) {
    const long long nrows = useful / p[0];
    float best = 1e9;
    for (int rep = 0; rep < 5; ++rep) {
      cudaMemset(fl, rep, 256ull << 20);
      cudaEventRecord(a);
      rd<<<sms * 8, 256>>>(buf, nrows, p[0], p[1], sink);
      cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b); if (ms < best) best = ms;
    }
    printf("rows %4d B every %4d B: %.1f us for %lld MB useful -> %.2f TB/s\n", p[0], p[1], best * 1e3, useful >> 20, useful / (best * 1e-3) / 1e12);
  }
  return 0;
}
