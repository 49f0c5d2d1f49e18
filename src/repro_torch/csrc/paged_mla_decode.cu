// Paged absorbed-MLA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::_mla_kernel
// (launched by paged_mla_decode_attention_pools, wrapped by
//  ops.py::paged_mla_decode_attention).
//
// What it computes: one absorbed decode query per slot and head attends
// over that slot's latent pages *in place* through the block table.  Head
// h of slot b scores logical positions t <= pos[b] as
//   s = scale * (q_lat[b,h] . ckv[t] + q_rope[b,h] . krope[t]),
// where position t lives at physical page table[b, t / ps], row t % ps, of
// the pools ckv (P, ps, Rkv) and krope (P, ps, Dr).  The softmax is online,
// in f32, and the value is the latent row itself: the output is
// sum_t softmax(s)_t ckv[t], (B, 1, H, Rkv) in q's type; wv_b is applied
// by the caller.  A row with no valid position writes zeros.
//
// What bounds it: bytes.  Every head of a slot reads the same latent rows,
// so the work is sum_b (pos_b + 1) * (Rkv + Dr) * sizeof(T) bytes against
// H * (2 Rkv + Dr) MACs per position: about 75 FLOP per byte in bf16 at
// minicpm3-4b's H 40, Rkv 256, Dr 32 -- under the H100's ~295 FLOP/byte
// ridge on the tensor cores, but above the ~20 FLOP/byte of the f32 CUDA
// cores this first version computes on, so in this version the f32 FMAs,
// not the bytes, set its floor.
//
// Design (the simple first version):
//   * the TPU kernel runs one program per slot over a sequential page grid
//     with an (H, Rkv) f32 accumulator -- 40 KB at minicpm3's shapes.  One
//     block per slot would give 16 blocks for 132 SMs, so the block split
//     here is (head tile of 4 heads, slot): 10 x 16 = 160 blocks.  Each
//     head tile of a slot re-reads that slot's latent rows; all live
//     latent rows of a decode tick (about 9.6 MB in bf16 at 16 slots x
//     ~1000 positions) fit in the 50 MB L2, so the re-reads come mostly
//     from L2, not from device memory;
//   * 128 threads: warp w scores head w of the tile, one lane per
//     position, over tiles of 32 positions; only valid positions are
//     loaded, so the garbage page behind a masked position (and a page
//     allocated past pos) is never read; any head count works (the last
//     tile is masked);
//   * latent and rope rows land in shared memory as f32 (16-byte vector
//     loads, rows padded by one float against bank conflicts); each thread
//     owns (head, latent column) pairs of the f32 accumulator.
// Splitting a slot's positions over blocks, tensor-core scoring and
// cp.async / TMA rings are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHeads = kThreads / 32;  // heads per block: one warp each
constexpr int kTile = 32;              // positions per tile == warp width
constexpr int kMaxRope = 64;

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

template <typename T, int RKV>
__global__ void __launch_bounds__(kThreads)
paged_mla_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                 const T* __restrict__ ckv, const T* __restrict__ krope,
                 const int* __restrict__ table, const int* __restrict__ pos,
                 T* __restrict__ out, int H, int DR, int pps, int ps,
                 float scale) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kCVec = RKV / kVec;             // vectors per latent row
  constexpr int kAcc = (kHeads * RKV + kThreads - 1) / kThreads;

  __shared__ float ql_s[kHeads][RKV];
  __shared__ float qr_s[kHeads][kMaxRope];
  __shared__ float c_s[kTile][RKV + 1];
  __shared__ float r_s[kTile][kMaxRope + 1];
  __shared__ float p_s[kHeads][kTile];
  __shared__ float alpha_s[kHeads];
  __shared__ float m_s[kHeads];
  __shared__ float l_s[kHeads];

  const int h0 = blockIdx.x * kHeads;
  const int b = blockIdx.y;
  const int nh = min(kHeads, H - h0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rvec = DR / kVec;                   // vectors per rope row
  const int row_vecs = kCVec + rvec;

  // positions past the table's extent do not exist (as in the gather)
  const int t_hi = min(pos[b], pps * ps - 1);   // inclusive
  const int* trow = table + (size_t)b * pps;

  for (int i = tid; i < kHeads * RKV; i += kThreads) {
    const int g = i / RKV, c = i % RKV;
    ql_s[g][c] = g < nh ? to_f32(q_lat[((size_t)b * H + h0 + g) * RKV + c])
                        : 0.f;
  }
  for (int i = tid; i < kHeads * DR; i += kThreads) {
    const int g = i / DR, c = i % DR;
    qr_s[g][c] = g < nh ? to_f32(q_rope[((size_t)b * H + h0 + g) * DR + c])
                        : 0.f;
  }
  if (tid < kHeads) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;

  for (int t0 = 0; t0 <= t_hi; t0 += kTile) {
    const int n_valid = min(kTile, t_hi - t0 + 1);
    __syncthreads();  // previous tile fully consumed (and q/m/l ready)
    // ---- load the tile's valid latent + rope rows through the table
    for (int i = tid; i < n_valid * row_vecs; i += kThreads) {
      const int t = i / row_vecs;
      const int v = i % row_vecs;
      const int tok = t0 + t;
      const size_t row = (size_t)trow[tok / ps] * ps + (tok % ps);
      if (v < kCVec) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            ckv + row * RKV + (size_t)v * kVec);
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int j = 0; j < kVec; ++j) c_s[t][v * kVec + j] = to_f32(e[j]);
      } else {
        const int u = v - kCVec;
        const uint4 w = *reinterpret_cast<const uint4*>(
            krope + row * DR + (size_t)u * kVec);
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int j = 0; j < kVec; ++j) r_s[t][u * kVec + j] = to_f32(e[j]);
      }
    }
    __syncthreads();
    // ---- scores + online-softmax statistics: warp per head
    if (warp < nh) {
      const int g = warp;
      const bool valid = lane < n_valid;
      float s = -INFINITY;
      if (valid) {
        float d = 0.f;
#pragma unroll 8
        for (int k = 0; k < RKV; ++k) d += ql_s[g][k] * c_s[lane][k];
        for (int k = 0; k < DR; ++k) d += qr_s[g][k] * r_s[lane][k];
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
    // ---- rescale and accumulate P.V (V = the latent rows)
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int i = tid + k * kThreads;
      const int g = i / RKV, c = i % RKV;
      if (i < kHeads * RKV && g < nh) {
        float a = acc[k] * alpha_s[g];
        for (int t = 0; t < n_valid; ++t) a += p_s[g][t] * c_s[t][c];
        acc[k] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int i = tid + k * kThreads;
    const int g = i / RKV, c = i % RKV;
    if (i < kHeads * RKV && g < nh) {
      const float l = l_s[g];
      from_f32(out + ((size_t)b * H + h0 + g) * RKV + c,
               l == 0.f ? 0.f : acc[k] / l);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* ql, const void* qr, const void* ckv,
                         const void* krope, const int* table, const int* pos,
                         void* out, int B, int H, int Rkv, int Dr, int pps,
                         int ps, float scale, cudaStream_t stream) {
  const dim3 grid((H + kHeads - 1) / kHeads, B);
#define REPRO_LAUNCH(R)                                                       \
  paged_mla_kernel<T, R><<<grid, kThreads, 0, stream>>>(                      \
      static_cast<const T*>(ql), static_cast<const T*>(qr),                   \
      static_cast<const T*>(ckv), static_cast<const T*>(krope), table, pos,   \
      static_cast<T*>(out), H, Dr, pps, ps, scale)
  switch (Rkv) {
    case 16: REPRO_LAUNCH(16); break;
    case 32: REPRO_LAUNCH(32); break;
    case 64: REPRO_LAUNCH(64); break;
    case 128: REPRO_LAUNCH(128); break;
    case 256: REPRO_LAUNCH(256); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Dr: a multiple of 8, at most 64.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_paged_mla_decode(int dtype, const void* q_lat,
                                      const void* q_rope, const void* ckv,
                                      const void* krope, const void* table,
                                      const void* pos, void* out, int B,
                                      int H, int Rkv, int Dr, int pps, int ps,
                                      float scale, void* stream) {
  if (B <= 0 || H <= 0 || ps <= 0 || pps <= 0 || Dr <= 0 || Dr % 8 != 0 ||
      Dr > kMaxRope)
    return (int)cudaErrorInvalidValue;
  const auto* tb = static_cast<const int*>(table);
  const auto* ps_ = static_cast<const int*>(pos);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(q_lat, q_rope, ckv, krope, tb, ps_, out, B,
                                    H, Rkv, Dr, pps, ps, scale, st);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(q_lat, q_rope, ckv, krope, tb,
                                            ps_, out, B, H, Rkv, Dr, pps, ps,
                                            scale, st);
  return (int)cudaErrorInvalidValue;
}
