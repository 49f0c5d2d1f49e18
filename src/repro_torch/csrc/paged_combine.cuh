// The combine of the split paged decode kernels, shared by the GQA
// (paged_decode.cu) and absorbed-MLA (paged_mla_decode.cu) decodes: each
// split block wrote its unnormalised f32 accumulator acc (n_split, rows,
// DH), its running max m and sum l (n_split, rows), in log2 units; a row's
// output is
//   out[row, d] = sum_z acc[z, row, d] 2^(m_z - M) / sum_z l_z 2^(m_z - M)
// over the splits with l_z > 0 (M their largest m); no such split: 0.
// An empty split's accumulator is never read.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kCombineThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ pacc,
                     const float* __restrict__ pm,
                     const float* __restrict__ pl, T* __restrict__ out,
                     int n_split, int rows, int DH) {
  const size_t i = (size_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= (size_t)rows * DH) return;
  const size_t row = i / DH;
  float mx = -INFINITY;
  for (int z = 0; z < n_split; ++z)
    if (pl[z * (size_t)rows + row] > 0.f)
      mx = fmaxf(mx, pm[z * (size_t)rows + row]);
  float l = 0.f, a = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const size_t zr = z * (size_t)rows + row;
    const float lz = pl[zr];
    if (lz > 0.f) {
      const float f = exp2f(pm[zr] - mx);
      l += lz * f;
      a += pacc[zr * DH + (i % DH)] * f;
    }
  }
  const float v = l > 0.f ? a / l : 0.f;
  if constexpr (sizeof(T) == 4)
    out[i] = v;
  else
    out[i] = __float2bfloat16(v);
}

template <typename T>
cudaError_t launch_combine(const float* pacc, const float* pm,
                           const float* pl, void* out, int n_split, int rows,
                           int DH, cudaStream_t stream) {
  const size_t n = (size_t)rows * DH;
  paged_combine_kernel<T><<<(unsigned)((n + kCombineThreads - 1) /
                                       kCombineThreads),
                            kCombineThreads, 0, stream>>>(
      pacc, pm, pl, static_cast<T*>(out), n_split, rows, DH);
  return cudaGetLastError();
}

}  // namespace
