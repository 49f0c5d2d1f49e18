// Paged absorbed-MLA decode attention for Hopper (sm_90a): split over
// positions, tensor-core scoring, then combine.
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
// the pools ckv (P, ps, Rkv) and krope (P, ps, Dr).  The softmax is in f32,
// and the value is the latent row itself: the output is sum_t softmax(s)_t
// ckv[t], (B, 1, H, Rkv) in q's type; wv_b is applied by the caller.  A
// row with no valid position writes zeros.
//
// What bounds it: bytes.  Every head of a slot reads the same latent rows,
// so the work is sum_b (pos_b + 1) * (Rkv + Dr) * sizeof(T) bytes against
// H * (2 Rkv + Dr) MACs per position: at minicpm3-4b's decode shape (16
// slots, H 40, Rkv 256, Dr 32, about 17,000 live positions) 10.3 MB,
// 0.0031 ms at the H100 SXM's published 3.35 TB/s, and 0.0007 ms of
// tensor-core work.  The first version (one block per (4-head tile, slot)
// walking its slot's positions in series, scalar f32 FMAs) took 0.6756
// ms on an NVIDIA H100 80GB HBM3 at 700.00 W: the longest slot's chain of
// 65 tiles, on the CUDA cores.
//
// Design (flash-decoding over the block table, as the GQA decode):
//   * split kernel, grid (head tile of 16, B, n_split).  Block z takes
//     `split_len` consecutive logical positions of its slot (whole pages,
//     about 256; the wrapper picks it from shapes alone, never from pos).
//     A block whose range lies above pos[b] writes an empty partial (m =
//     -inf, l = 0) and exits.  minicpm3's 40 heads are 3 tiles, the last
//     with 8 rows of zeros.
//   * bf16: the rows [ckv | krope] (Rkv + Dr, the rope part zero-padded to
//     16) arrive in 64-position tiles through a 2-stage ring of 16-byte
//     cp.async copies, a warp per row; each row's address comes through
//     table[b, t / ps], looked up a tile ahead by a thread per row; positions
//     outside the range are zero-filled (0 source bytes) and never read, so
//     the garbage page behind them cannot leak.  The head tile's [q_lat |
//     q_rope] rows sit in shared memory and enter mma.sync m16n8k16 as A
//     fragments (ldmatrix); each of the 4 warps scores 16 positions of a
//     tile against ldmatrix fragments of the rows, keeps its own running
//     max / sum in log2 units (exp2f), and accumulates P.V into a 16 x Rkv
//     f32 tile against the same rows through ldmatrix.trans.  The four
//     warps merge through shared memory at the end.
//   * f32: the first version's CUDA-core kernel, one block per (4 heads,
//     slot), unsplit; the reference grid's f32 cases only.
//   * each split block writes its unnormalised accumulator (f32), max and
//     sum to scratch the wrapper allocates; the combine kernel
//     (paged_combine.cuh, shared with the GQA decode) merges a row's
//     splits.  With one split the split kernel writes the output itself.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): about 0.034
// ms of device time for split + combine at minicpm3's decode shape (the
// split kernel about 0.027, the combine 0.007), against 0.61 ms for the
// plain version and 3.95 ms for SDPA; CUDA-event times of the call also
// carry the host's enqueue time.  Looking the rows up a tile ahead, by a
// thread per row, instead of at every copy took about a quarter off the
// split kernel.  It still waits on its tiles' loads rather than on its
// products.  Next for it: one block per (slot, split) for all the heads,
// so the rows cross from L2 once instead of once per head tile, with
// more loads in flight, and the combine folded into the split kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "paged_combine.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadTile = 16;        // query rows of a split block (m16)
constexpr int kTile = 64;            // positions per bf16 tile
constexpr int kStages = 2;           // bf16 ring depth
constexpr int kMaxRope = 64;
constexpr float kNeg = -1e30f;       // masked score (finite: no inf - inf)
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
}

// ============================================================ bf16 split
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// shared memory of the split kernel: the head tile's query rows and the
// ring, rows of Rkv + round16(Dr) + 8 elements (an odd multiple of 16
// bytes, so ldmatrix rows fall in distinct banks)
size_t split_smem(int rkv, int dr) {
  return (size_t)(kHeadTile + kStages * kTile) * (rkv + round16(dr) + 8) *
         sizeof(bf16);
}

template <int RKV>
__global__ void __launch_bounds__(kThreads)
mla_split_mma_kernel(const bf16* __restrict__ q_lat,
                     const bf16* __restrict__ q_rope,
                     const bf16* __restrict__ ckv,
                     const bf16* __restrict__ krope,
                     const int* __restrict__ table,
                     const int* __restrict__ pos, bf16* __restrict__ out,
                     float* __restrict__ pacc, float* __restrict__ pm,
                     float* __restrict__ pl, int B, int H, int DR, int pps,
                     int ps, float scale_log2, int L, int direct) {
  constexpr int DN = RKV / 8;          // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DRP = round16(DR);
  const int LD = RKV + DRP + 8;        // shared row stride (elements)
  const int KS = (RKV + DRP) / 16;     // k-steps of the scores
  const int vecs = (RKV + DRP) / 8;    // 16-byte chunks per row
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);          // (16, LD)
  bf16* ring = q_s + kHeadTile * LD;                      // (2, 64, LD)

  const int h0 = blockIdx.x * kHeadTile, b = blockIdx.y, z = blockIdx.z;
  const int nh = min(kHeadTile, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const size_t row0 = (size_t)b * H + h0;                 // flat row
  const size_t part = (size_t)z * B * H + row0;
  const int hi = min(pos[b], pps * ps - 1);
  const int lo_r = z * L, hi_r = min(hi, z * L + L - 1);  // inclusive
  if (lo_r > hi_r) {
    if (direct) {
      for (int i = tid; i < nh * RKV; i += kThreads)
        out[row0 * RKV + i] = __float2bfloat16(0.f);
    } else if (tid < nh) {
      pm[part + tid] = -INFINITY;
      pl[part + tid] = 0.f;
    }
    return;
  }
  const int n_tiles = (hi_r - lo_r + kTile) / kTile;
  const int* trow = table + (size_t)b * pps;

  // the physical row of each position of a tile (-1: outside the range),
  // found a tile ahead of its copies by a thread per row
  __shared__ int row_s[kStages][kTile];
  auto find_rows = [&](int stage, int t0) {
    if (tid < kTile) {
      const int tok = t0 + tid;
      row_s[stage][tid] = tok <= hi_r ? trow[tok / ps] * ps + tok % ps : -1;
    }
  };
  // a warp copies whole rows: lane k the 16-byte chunks k, k + 32, ...
  auto load_tile = [&](int stage) {
    bf16* rs = ring + (size_t)stage * kTile * LD;
    for (int rr = warp; rr < kTile; rr += kWarps) {
      const int row = row_s[stage][rr];
      for (int c = lane * 8; c < RKV + DRP; c += 32 * 8) {
        const bool ok = row >= 0 && (c < RKV || c - RKV < DR);
        const bf16* src = ckv;
        if (ok)
          src = c < RKV ? ckv + (size_t)row * RKV + c
                        : krope + (size_t)row * DR + (c - RKV);
        cp_async16(smem_addr(rs + rr * LD + c), src, ok ? 16 : 0);
      }
    }
  };

  find_rows(0, lo_r);
  __syncthreads();
  load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) find_rows(1, lo_r + kTile);

  // the head tile's [q_lat | q_rope] rows (rows >= nh and the rope pad: 0)
  for (int i = tid; i < kHeadTile * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nh) {
      if (c < RKV)
        v = *reinterpret_cast<const uint4*>(q_lat + (row0 + r) * RKV + c);
      else if (c - RKV < DR)
        v = *reinterpret_cast<const uint4*>(q_rope + (row0 + r) * DR +
                                            (c - RKV));
    }
    *reinterpret_cast<uint4*>(q_s + r * LD + c) = v;
  }
  __syncthreads();   // the second tile's rows are found

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // rows g and g + 8

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = lo_r + it * kTile;
    if (it + 1 < n_tiles) load_tile((it + 1) % kStages);
    cp_async_commit();
    if (it + 2 < n_tiles) find_rows(it % kStages, t0 + 2 * kTile);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* rs = ring + (size_t)(it % kStages) * kTile * LD;
    const int key0 = t0 + warp * 16;            // this warp's 16 positions
    if (key0 <= hi_r) {
      // ---- scores: 16 heads x 16 positions (two n-tiles of 8)
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4], kb[4];
        ldsm_x4(smem_addr(q_s + ((mi & 1) * 8 + (lane & 7)) * LD + ks * 16 +
                          (mi >> 1) * 8),
                qa);
        ldsm_x4(smem_addr(rs + (warp * 16 + (mi >> 1) * 8 + (lane & 7)) * LD +
                          ks * 16 + (mi & 1) * 8),
                kb);
        mma_bf16(s[0], qa, kb[0], kb[1]);
        mma_bf16(s[1], qa, kb[2], kb[3]);
      }
      // ---- mask past the range's end, online softmax in log2 units
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + nt * 8 + 2 * t + (i & 1);
          s[nt][i] = key <= hi_r ? s[nt][i] * scale_log2 : kNeg;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + nt * 8 + 2 * t + (i & 1);
          const float p =
              key <= hi_r ? exp2f(s[nt][i] - (i < 2 ? n0 : n1)) : 0.f;
          s[nt][i] = p;
          if (i < 2) sum0 += p; else sum1 += p;
        }
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      // ---- P.V against the latent part of the same rows
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        o[dn][0] *= a0;
        o[dn][1] *= a0;
        o[dn][2] *= a1;
        o[dn][3] *= a1;
        o[dn + 1][0] *= a0;
        o[dn + 1][1] *= a0;
        o[dn + 1][2] *= a1;
        o[dn + 1][3] *= a1;
        uint32_t vb[4];
        ldsm_x4_t(smem_addr(rs + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                            (dn + (mi >> 1)) * 8),
                  vb);
        mma_bf16(o[dn], pa, vb[0], vb[1]);
        mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  // ---- merge the four warps' (m, l, o) through shared memory (the ring)
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  float* sm_o = reinterpret_cast<float*>(ring);           // (4, 16, RKV)
  float* sm_m = sm_o + kWarps * 16 * RKV;                 // (4, 16)
  float* sm_l = sm_m + kWarps * 16;                       // (4, 16)
  if (t == 0) {
    sm_m[warp * 16 + g] = m0;
    sm_m[warp * 16 + g + 8] = m1;
    sm_l[warp * 16 + g] = l0;
    sm_l[warp * 16 + g + 8] = l1;
  }
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    float* p0 = sm_o + (warp * 16 + g) * RKV + dn * 8 + 2 * t;
    float* p1 = p0 + 8 * RKV;
    p0[0] = o[dn][0];
    p0[1] = o[dn][1];
    p1[0] = o[dn][2];
    p1[1] = o[dn][3];
  }
  __syncthreads();
  for (int i = tid; i < nh * RKV; i += kThreads) {
    const int row = i / RKV, d = i % RKV;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * 16 + row]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w * 16 + row] - mx);
      l += sm_l[w * 16 + row] * f;
      a += sm_o[(w * 16 + row) * RKV + d] * f;
    }
    if (direct) {
      out[(row0 + row) * RKV + d] = __float2bfloat16(l > 0.f ? a / l : 0.f);
    } else {
      pacc[(part + row) * RKV + d] = a;
      if (d == 0) {
        pm[part + row] = mx;
        pl[part + row] = l;
      }
    }
  }
}

// ============================================================= f32 simt
// The first version's kernel, for f32 only: block per (4-head
// tile, slot), warp per head, one lane per position over 32-position
// tiles of f32 rows in shared memory, unsplit.
constexpr int kSimtHeads = kThreads / 32;
constexpr int kSimtTile = 32;

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

template <int RKV>
__global__ void __launch_bounds__(kThreads)
mla_simt_kernel(const float* __restrict__ q_lat,
                const float* __restrict__ q_rope,
                const float* __restrict__ ckv, const float* __restrict__ krope,
                const int* __restrict__ table, const int* __restrict__ pos,
                float* __restrict__ out, int H, int DR, int pps, int ps,
                float scale) {
  constexpr int kVec = 4;                       // floats per 16-byte load
  constexpr int kCVec = RKV / kVec;             // vectors per latent row
  constexpr int kAcc = (kSimtHeads * RKV + kThreads - 1) / kThreads;

  __shared__ float ql_s[kSimtHeads][RKV];
  __shared__ float qr_s[kSimtHeads][kMaxRope];
  __shared__ float c_s[kSimtTile][RKV + 1];
  __shared__ float r_s[kSimtTile][kMaxRope + 1];
  __shared__ float p_s[kSimtHeads][kSimtTile];
  __shared__ float alpha_s[kSimtHeads];
  __shared__ float m_s[kSimtHeads];
  __shared__ float l_s[kSimtHeads];

  const int h0 = blockIdx.x * kSimtHeads;
  const int b = blockIdx.y;
  const int nh = min(kSimtHeads, H - h0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rvec = DR / kVec;                   // vectors per rope row
  const int row_vecs = kCVec + rvec;

  // positions past the table's extent do not exist (as in the gather)
  const int t_hi = min(pos[b], pps * ps - 1);   // inclusive
  const int* trow = table + (size_t)b * pps;

  for (int i = tid; i < kSimtHeads * RKV; i += kThreads) {
    const int g = i / RKV, c = i % RKV;
    ql_s[g][c] = g < nh ? q_lat[((size_t)b * H + h0 + g) * RKV + c] : 0.f;
  }
  for (int i = tid; i < kSimtHeads * DR; i += kThreads) {
    const int g = i / DR, c = i % DR;
    qr_s[g][c] = g < nh ? q_rope[((size_t)b * H + h0 + g) * DR + c] : 0.f;
  }
  if (tid < kSimtHeads) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;

  for (int t0 = 0; t0 <= t_hi; t0 += kSimtTile) {
    const int n_valid = min(kSimtTile, t_hi - t0 + 1);
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
        const float* e = reinterpret_cast<const float*>(&w);
#pragma unroll
        for (int j = 0; j < kVec; ++j) c_s[t][v * kVec + j] = e[j];
      } else {
        const int u = v - kCVec;
        const uint4 w = *reinterpret_cast<const uint4*>(
            krope + row * DR + (size_t)u * kVec);
        const float* e = reinterpret_cast<const float*>(&w);
#pragma unroll
        for (int j = 0; j < kVec; ++j) r_s[t][u * kVec + j] = e[j];
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
      if (i < kSimtHeads * RKV && g < nh) {
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
    if (i < kSimtHeads * RKV && g < nh) {
      const float l = l_s[g];
      out[((size_t)b * H + h0 + g) * RKV + c] = l == 0.f ? 0.f : acc[k] / l;
    }
  }
}


template <int RKV>
cudaError_t launch_mma(const void* ql, const void* qr, const void* ckv,
                       const void* krope, const int* table, const int* pos,
                       void* out, float* pacc, float* pm, float* pl, int B,
                       int H, int Dr, int pps, int ps, float scale_log2,
                       int n_split, int L, int direct, cudaStream_t stream) {
  const size_t smem = split_smem(RKV, Dr);
  static_assert(kStages * kTile * (RKV + 24) * 2 >=
                    kWarps * 16 * (RKV + 2) * 4,
                "the warps' merge reuses the ring");
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_split_mma_kernel<RKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((H + kHeadTile - 1) / kHeadTile, B, n_split);
  mla_split_mma_kernel<RKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(ql), static_cast<const bf16*>(qr),
      static_cast<const bf16*>(ckv), static_cast<const bf16*>(krope), table,
      pos, static_cast<bf16*>(out), pacc, pm, pl, B, H, Dr, pps, ps,
      scale_log2, L, direct);
  return cudaGetLastError();
}

template <int RKV>
cudaError_t launch_simt(const void* ql, const void* qr, const void* ckv,
                        const void* krope, const int* table, const int* pos,
                        void* out, int B, int H, int Dr, int pps, int ps,
                        float scale, cudaStream_t stream) {
  const dim3 grid((H + kSimtHeads - 1) / kSimtHeads, B);
  mla_simt_kernel<RKV><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(ql), static_cast<const float*>(qr),
      static_cast<const float*>(ckv), static_cast<const float*>(krope),
      table, pos, static_cast<float*>(out), H, Dr, pps, ps, scale);
  return cudaGetLastError();
}

cudaError_t launch_split(const void* ql, const void* qr, const void* ckv,
                         const void* krope, const int* table, const int* pos,
                         void* out, float* pacc, float* pm, float* pl, int B,
                         int H, int Rkv, int Dr, int pps, int ps, float scale,
                         int n_split, int L, int direct, cudaStream_t st) {
  const float sl = scale * kLog2e;
#define REPRO_SPLIT(R)                                                       \
  return launch_mma<R>(ql, qr, ckv, krope, table, pos, out, pacc, pm, pl, B, \
                       H, Dr, pps, ps, sl, n_split, L, direct, st)
  switch (Rkv) {
    case 16: REPRO_SPLIT(16);
    case 32: REPRO_SPLIT(32);
    case 64: REPRO_SPLIT(64);
    case 128: REPRO_SPLIT(128);
    case 256: REPRO_SPLIT(256);
  }
#undef REPRO_SPLIT
  return cudaErrorInvalidValue;
}

bool bad_args(int B, int H, int Dr, int pps, int ps, int n_split, int L) {
  return B <= 0 || B > 65535 || H <= 0 || ps <= 0 || pps <= 0 || Dr <= 0 ||
         Dr % 8 != 0 || Dr > kMaxRope || n_split <= 0 || n_split > 65535 ||
         L <= 0 || (long long)n_split * L < (long long)pps * ps;
}

}  // namespace

// dtype: 0 = float32 (one unsplit launch; acc, m, l, n_split and
// split_len unused), 1 = bfloat16.  Dr: a multiple of 8, at most 64.  In
// bf16, n_split blocks of split_len positions cover the table's pps * ps
// positions; with n_split 1 the split kernel writes `out`, otherwise it
// writes the partials acc (n_split, B * H, Rkv), m and l (n_split, B * H),
// f32, and the combine kernel writes `out`.  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int repro_paged_mla_decode(int dtype, const void* q_lat,
                                      const void* q_rope, const void* ckv,
                                      const void* krope, const void* table,
                                      const void* pos, void* out, void* acc,
                                      void* m, void* l, int B, int H, int Rkv,
                                      int Dr, int pps, int ps, float scale,
                                      int n_split, int split_len,
                                      void* stream) {
  if (bad_args(B, H, Dr, pps, ps, n_split, split_len))
    return (int)cudaErrorInvalidValue;
  const auto* tb = static_cast<const int*>(table);
  const auto* pp = static_cast<const int*>(pos);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
#define REPRO_SIMT(R)                                                        \
  return (int)launch_simt<R>(q_lat, q_rope, ckv, krope, tb, pp, out, B, H,  \
                             Dr, pps, ps, scale, st)
    switch (Rkv) {
      case 16: REPRO_SIMT(16);
      case 32: REPRO_SIMT(32);
      case 64: REPRO_SIMT(64);
      case 128: REPRO_SIMT(128);
      case 256: REPRO_SIMT(256);
    }
#undef REPRO_SIMT
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto* pacc = static_cast<float*>(acc);
  auto* pm = static_cast<float*>(m);
  auto* pl = static_cast<float*>(l);
  const bool direct = n_split == 1;
  const cudaError_t err =
      launch_split(q_lat, q_rope, ckv, krope, tb, pp, out, pacc, pm, pl, B, H,
                   Rkv, Dr, pps, ps, scale, n_split, split_len, direct, st);
  if (err != cudaSuccess || direct) return (int)err;
  return (int)launch_combine<bf16>(pacc, pm, pl, out, n_split, B * H, Rkv,
                                   st);
}

// The bf16 split kernel alone, always writing the partials (any n_split),
// so that the combine can be held against its plain version on them.
extern "C" int repro_paged_mla_decode_split(
    const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
    const void* table, const void* pos, void* acc, void* m, void* l, int B,
    int H, int Rkv, int Dr, int pps, int ps, float scale, int n_split,
    int split_len, void* stream) {
  if (bad_args(B, H, Dr, pps, ps, n_split, split_len))
    return (int)cudaErrorInvalidValue;
  return (int)launch_split(
      q_lat, q_rope, ckv, krope, static_cast<const int*>(table),
      static_cast<const int*>(pos), nullptr, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), B, H, Rkv, Dr, pps, ps,
      scale, n_split, split_len, 0, static_cast<cudaStream_t>(stream));
}
