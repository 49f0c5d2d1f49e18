// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::_decode_kernel
// (launched by paged_decode_attention_pools, wrapped by
//  ops.py::paged_decode_attention).
//
// What it computes: one decode query per slot attends over that slot's
// K/V pages *in place* through the block table.  For slot b and kv head
// h, the `group = H / Hkv` query rows of flat heads h*group .. h*group +
// group - 1 (kv-head-major, the order _expand_kv broadcasts in) score
// logical positions t with t <= pos[b] (and t > pos[b] - window when a
// window is set).  Position t lives at physical page table[b, t / ps],
// row t % ps, of the pools (P, ps, Hkv, Dh).  The softmax is online, in
// f32; a row with no valid position writes zeros.  Output (B, 1, H, Dh)
// in q's type.
//
// What bounds it: bytes.  Each (slot, kv head) reads its live K and V
// rows once: sum_b (pos_b + 1) * Hkv * Dh * 2 * sizeof(T) per call, a
// few FLOPs per byte — far below the H100's ~295 FLOP/byte ridge.
//
// Design (the simple first version):
//   * one block per (kv head, slot), 128 threads; the block reads its
//     own table row (no scalar prefetch on this card);
//   * positions are walked in tiles of 32 (one warp lane per position),
//     so every page size works the same way; only valid positions are
//     loaded — pages above pos, or wholly below the window, are never
//     touched, and a garbage page behind a masked position is never read;
//   * K and V tiles land in shared memory as f32 (16-byte vector loads,
//     rows padded by one float against bank conflicts), warp w scores
//     query rows w, w+4, ... and keeps their running max / sum; every
//     thread owns one head-dim column of the f32 accumulator for its rows;
//   * the group (1..16 rows) is held padded to 16 and masked.
// Splitting a slot's positions over several blocks (needed when B * Hkv
// blocks cannot fill 132 SMs) and cp.async / TMA rings are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // positions per tile == warp width
constexpr int kMaxGroup = 16;  // query rows per kv head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ out, int H,
                    int Hkv, int G, int pps, int ps, int window, float scale) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kVecPerRow = DH / kVec;
  constexpr int kRowGroups = kThreads / DH;     // threads sharing a column
  constexpr int kAcc = (kMaxGroup + kRowGroups - 1) / kRowGroups;

  __shared__ float q_s[kMaxGroup][DH];
  __shared__ float k_s[kTile][DH + 1];
  __shared__ float v_s[kTile][DH + 1];
  __shared__ float p_s[kMaxGroup][kTile];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int p_b = pos[b];
  const int t_hi = p_b;                                   // inclusive
  const int t_lo = window > 0 ? max(0, p_b - window + 1) : 0;
  const int* trow = table + (size_t)b * pps;

  // query rows of this kv head: flat heads h*G .. h*G+G-1
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * DH;
  for (int i = tid; i < G * DH; i += kThreads)
    q_s[i / DH][i % DH] = to_f32(qb[i]);
  if (tid < kMaxGroup) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int col = tid % DH;
  const int row0 = tid / DH;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const size_t row_stride = (size_t)Hkv * DH;   // elements per pool row
  for (int t0 = t_lo; t0 <= t_hi; t0 += kTile) {
    const int n_valid = min(kTile, t_hi - t0 + 1);
    __syncthreads();  // previous tile fully consumed (and q_s/m_s ready)
    // ---- load the tile's valid K/V rows through the block table
    for (int i = tid; i < n_valid * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int tok = t0 + t;
      const int page = trow[tok / ps];
      const size_t off = ((size_t)page * ps + (tok % ps)) * row_stride +
                         (size_t)h * DH + c;
      const uint4 kv4 = *reinterpret_cast<const uint4*>(kpool + off);
      const uint4 vv4 = *reinterpret_cast<const uint4*>(vpool + off);
      const T* kv = reinterpret_cast<const T*>(&kv4);
      const T* vv = reinterpret_cast<const T*>(&vv4);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        k_s[t][c + j] = to_f32(kv[j]);
        v_s[t][c + j] = to_f32(vv[j]);
      }
    }
    __syncthreads();
    // ---- scores + online-softmax statistics: warp per query row
    for (int g = warp; g < G; g += kWarps) {
      const bool valid = lane < n_valid;
      float s = -INFINITY;
      if (valid) {
        float d = 0.f;
#pragma unroll 8
        for (int k = 0; k < DH; ++k) d += q_s[g][k] * k_s[lane][k];
        s = d * scale;
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[g][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first tile
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // ---- rescale and accumulate P.V: thread owns column `col`
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = row0 + i * kRowGroups;
      if (g < G) {
        float a = acc[i] * alpha_s[g];
        for (int t = 0; t < n_valid; ++t) a += p_s[g][t] * v_s[t][col];
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)h * G) * DH;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = row0 + i * kRowGroups;
    if (g < G) {
      const float l = l_s[g];
      from_f32(ob + (size_t)g * DH + col, l == 0.f ? 0.f : acc[i] / l);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* table, const int* pos, void* out, int B,
                         int H, int Hkv, int Dh, int pps, int ps, int window,
                         float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const int G = H / Hkv;
#define REPRO_LAUNCH(D)                                                      \
  paged_decode_kernel<T, D><<<grid, kThreads, 0, stream>>>(                  \
      static_cast<const T*>(q), static_cast<const T*>(k),                    \
      static_cast<const T*>(v), table, pos, static_cast<T*>(out), H, Hkv, G, \
      pps, ps, window, scale)
  switch (Dh) {
    case 16: REPRO_LAUNCH(16); break;
    case 32: REPRO_LAUNCH(32); break;
    case 64: REPRO_LAUNCH(64); break;
    case 128: REPRO_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_paged_decode(int dtype, const void* q, const void* k,
                                  const void* v, const void* table,
                                  const void* pos, void* out, int B, int H,
                                  int Hkv, int Dh, int pps, int ps,
                                  int window, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || B <= 0 || ps <= 0)
    return (int)cudaErrorInvalidValue;
  const auto* tb = static_cast<const int*>(table);
  const auto* ps_ = static_cast<const int*>(pos);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(q, k, v, tb, ps_, out, B, H, Hkv, Dh,
                                    pps, ps, window, scale, st);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(q, k, v, tb, ps_, out, B, H, Hkv,
                                            Dh, pps, ps, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
