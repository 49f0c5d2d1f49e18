// Device helpers shared by the SSD chunk scan (ssd_chunk.cu) and its
// backward (ssd_chunk_bwd.cu): the (B, S, H) strides, the chunk's cumsum of
// dt * a, and the building blocks of their bf16 products on the tensor
// cores -- mma.sync m16n8k16 (bf16 in, f32 accumulate), ldmatrix (plain and
// .trans) and cp.async.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 256;

struct Strides {
  long long b, s, h;       // element strides of the (B, S, H) axes
};

__device__ __forceinline__ long long off(const Strides& st, int b, long long s,
                                         int h) {
  return b * st.b + s * st.s + h * st.h;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n");
}
// every committed group but the newest `kPending` has landed
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
}

// dt of chunk positions [0, L) into dt_s and the inclusive cumsum of dt * a
// into cum_s (kMaxChunk each; past L dt is 0 and cum stays cum[L - 1]).
// Warp 0 scans, 8 consecutive positions a lane.  Ends synchronised.
__device__ void chunk_cumsum(const float* dtp, long long dts, float A, int L,
                             float* dt_s, float* cum_s) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kMaxChunk; i += blockDim.x)
    dt_s[i] = i < L ? dtp[i * dts] : 0.f;
  __syncthreads();
  if (tid < 32) {
    float v[8];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      run += dt_s[tid * 8 + k] * A;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += u;
    }
    const float base = incl - run;
#pragma unroll
    for (int k = 0; k < 8; ++k) cum_s[tid * 8 + k] = base + v[k];
  }
  __syncthreads();
}

}  // namespace
