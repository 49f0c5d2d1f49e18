// Paged GQA decode attention for Hopper (sm_90a): split over positions,
// then combine.
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
// row t % ps, of the pools (P, ps, Hkv, Dh).  The softmax is in f32; a
// row with no valid position writes zeros.  Output (B, 1, H, Dh) in q's
// type.
//
// What bounds it: bytes.  Each (slot, kv head) reads its live K and V
// rows once: sum_b (pos_b + 1) * Hkv * Dh * 2 * sizeof(T) per call, a
// few FLOPs per byte, far below the H100's ~295 FLOP/byte ridge.  At the
// serve shape (16 slots, 8 kv heads, Dh 128, up to 2080 positions) that
// is 68.6 MB, 0.0205 ms at 3.35 TB/s.  The first version (one block per
// (kv head, slot), positions walked serially in 32-row tiles, loads and
// math never overlapping) took 0.38 ms: the chain of the longest slot's
// tiles, on 128 blocks, with most SMs idle once the short slots ended.
//
// Design (flash-decoding over the block table):
//   * split kernel, grid (Hkv, B, n_split).  Block z takes `split_len`
//     consecutive logical positions of its slot (a multiple of the page
//     size, about 256; the wrapper picks it from shapes alone).  A block
//     whose range lies above pos[b] or below the window writes an empty
//     partial (m = -inf, l = 0) and exits, so the live blocks, not the
//     longest slot, set the time, and every SM has bytes in flight.
//   * bf16: K/V arrive in 64-position tiles, bf16 in shared memory,
//     through a 2-stage ring of 16-byte cp.async copies; each row is
//     addressed through table[b, t / ps].  Positions outside the range are
//     zero-filled (a cp.async of 0 source bytes) and never read, so the
//     garbage page behind them cannot leak.  The group's rows (padded to
//     16) are the A operand of mma.sync m16n8k16 (bf16 in, f32
//     accumulate); K's B fragments come through ldmatrix, V's through
//     ldmatrix.trans.  Each of the 4 warps takes 16 positions of every
//     tile with its own running max / sum (log2 units, exp2f), and the
//     block merges the four at the end.
//   * f32: the CUDA cores, 32-position tiles widened to f32 in shared
//     memory, one warp per query row; the reference grid's f32 cases
//     only.
//   * each block writes its unnormalised accumulator (f32), max and sum to
//     scratch the wrapper allocates; the combine kernel (paged_combine.cuh,
//     shared with the MLA decode) merges a row's splits by log-sum-exp (a
//     row whose splits are all empty writes zeros).  With one split the split kernel writes the output itself.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md): at the
// serve shape the split kernel takes about 0.038 ms and the combine 0.0066
// ms of device time, against 0.38 ms for the first version and 0.0205 ms
// for the bound.  Next for it: the combine's own launch (a last-block
// merge inside the split kernel), and a first tile whose copies still
// wait on their table loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "paged_combine.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;        // query rows per kv head
constexpr int kTile = 64;            // positions per bf16 tile
constexpr int kStages = 2;           // bf16 ring depth
constexpr int kSimtTile = 32;        // positions per f32 tile
constexpr float kNeg = -1e30f;       // masked score (finite: no inf - inf)
constexpr float kLog2e = 1.4426950408889634f;

struct Range {
  int lo, hi;                        // inclusive; empty when lo > hi
};

// the positions of slot b that split z of length L scores
__device__ __forceinline__ Range split_range(int p_b, int cap, int window,
                                             int z, int L) {
  const int hi = min(p_b, cap - 1);
  const int lo = window > 0 ? max(0, p_b - window + 1) : 0;
  return {max(lo, z * L), min(hi, z * L + L - 1)};
}

// Row r = (b * H + flat head) of the partials / output.  An empty range:
// the output rows are zeros (one split) or the partial is empty.
__device__ __forceinline__ void write_empty(float* pm, float* pl,
                                            void* out, int elt, size_t part,
                                            size_t row0, int G, int DH,
                                            bool direct) {
  if (direct) {
    for (int i = threadIdx.x; i < G * DH; i += blockDim.x) {
      if (elt == 4)
        static_cast<float*>(out)[row0 * DH + i] = 0.f;
      else
        static_cast<bf16*>(out)[row0 * DH + i] = __float2bfloat16(0.f);
    }
  } else if (threadIdx.x < G) {
    pm[part + threadIdx.x] = -INFINITY;
    pl[part + threadIdx.x] = 0.f;
  }
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

template <int DH>
constexpr int mma_smem_bytes() {
  return kStages * 2 * kTile * (DH + 8) * (int)sizeof(bf16);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
paged_split_mma_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ kpool,
                       const bf16* __restrict__ vpool,
                       const int* __restrict__ table,
                       const int* __restrict__ pos, bf16* __restrict__ out,
                       float* __restrict__ pacc, float* __restrict__ pm,
                       float* __restrict__ pl, int B, int H, int Hkv, int G,
                       int pps, int ps, int window, float scale_log2, int L,
                       int direct) {
  constexpr int LD = DH + 8;           // shared row stride (elements)
  constexpr int KS = DH / 16;          // k-steps of Q.K^T
  constexpr int DN = DH / 8;           // d n-tiles of the output
  constexpr int kChunks = DH / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * H + (size_t)h * G;        // flat row
  const size_t part = (size_t)z * B * H + row0;
  const Range r = split_range(pos[b], pps * ps, window, z, L);
  if (r.lo > r.hi) {
    write_empty(pm, pl, out, 2, part, row0, G, DH, direct);
    return;
  }
  const int n_tiles = (r.hi - r.lo + kTile) / kTile;
  const int* trow = table + (size_t)b * pps;
  const size_t row_stride = (size_t)Hkv * DH;

  auto load_tile = [&](int stage, int t0) {
    bf16* ks = ring + (size_t)stage * 2 * kTile * LD;
    bf16* vs = ks + kTile * LD;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int rr = i / kChunks, c = (i % kChunks) * 8;
      const int tok = t0 + rr;
      const bool ok = tok <= r.hi;
      size_t off = 0;
      if (ok)
        off = ((size_t)trow[tok / ps] * ps + tok % ps) * row_stride +
              (size_t)h * DH + c;
      cp_async16(smem_addr(ks + rr * LD + c), kpool + off, ok ? 16 : 0);
      cp_async16(smem_addr(vs + rr * LD + c), vpool + off, ok ? 16 : 0);
    }
  };

  load_tile(0, r.lo);
  cp_async_commit();

  // the group's rows g and g + 8 as m16n8k16 A fragments (rows >= G: 0)
  uint32_t qa[KS][4];
  {
    const bf16* q0p = q + (row0 + g) * DH;
    const bf16* q1p = q + (row0 + g + 8) * DH;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + 2 * t;
      qa[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(q0p + c) : 0u;
      qa[ks][1] = g + 8 < G ? *reinterpret_cast<const uint32_t*>(q1p + c)
                            : 0u;
      qa[ks][2] = g < G ? *reinterpret_cast<const uint32_t*>(q0p + c + 8)
                        : 0u;
      qa[ks][3] = g + 8 < G
                      ? *reinterpret_cast<const uint32_t*>(q1p + c + 8)
                      : 0u;
    }
  }
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // rows g and g + 8

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = r.lo + it * kTile;
    if (it + 1 < n_tiles) load_tile((it + 1) % kStages, t0 + kTile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks_ = ring + (size_t)(it % kStages) * 2 * kTile * LD;
    const bf16* vs_ = ks_ + kTile * LD;
    const int key0 = t0 + warp * 16;            // this warp's 16 positions
    if (key0 <= r.hi) {
      // ---- scores: 16 rows x 16 positions (two n-tiles of 8)
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const int mi = lane >> 3;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        ldsm_x4(smem_addr(ks_ + (warp * 16 + (mi >> 1) * 8 + (lane & 7)) * LD +
                          ks * 16 + (mi & 1) * 8),
                kb);
        mma_bf16(s[0], qa[ks], kb[0], kb[1]);
        mma_bf16(s[1], qa[ks], kb[2], kb[3]);
      }
      // ---- mask past the range's end, online softmax in log2 units
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + nt * 8 + 2 * t + (i & 1);
          s[nt][i] = key <= r.hi ? s[nt][i] * scale_log2 : kNeg;
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
              key <= r.hi ? exp2f(s[nt][i] - (i < 2 ? n0 : n1)) : 0.f;
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
        ldsm_x4_t(smem_addr(vs_ + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                            (dn + (mi >> 1)) * 8),
                  vb);
        mma_bf16(o[dn], pa, vb[0], vb[1]);
        mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  // ---- merge the four warps' (m, l, o) through shared memory
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  float* sm_o = reinterpret_cast<float*>(smem_raw);       // (4, 16, DH)
  float* sm_m = sm_o + kWarps * 16 * DH;                  // (4, 16)
  float* sm_l = sm_m + kWarps * 16;                       // (4, 16)
  if (t == 0) {
    sm_m[warp * 16 + g] = m0;
    sm_m[warp * 16 + g + 8] = m1;
    sm_l[warp * 16 + g] = l0;
    sm_l[warp * 16 + g + 8] = l1;
  }
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    float* p0 = sm_o + (warp * 16 + g) * DH + dn * 8 + 2 * t;
    float* p1 = p0 + 8 * DH;
    p0[0] = o[dn][0];
    p0[1] = o[dn][1];
    p1[0] = o[dn][2];
    p1[1] = o[dn][3];
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kThreads) {
    const int row = i / DH, d = i % DH;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * 16 + row]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w * 16 + row] - mx);
      l += sm_l[w * 16 + row] * f;
      a += sm_o[(w * 16 + row) * DH + d] * f;
    }
    if (direct) {
      out[(row0 + row) * DH + d] = __float2bfloat16(l > 0.f ? a / l : 0.f);
    } else {
      pacc[(part + row) * DH + d] = a;
      if (d == 0) {
        pm[part + row] = mx;
        pl[part + row] = l;
      }
    }
  }
}

// ============================================================= f32 split
// An int the compiler cannot see through.  The f32 loop below, bounded by
// the split range's min / max chain, made the optimiser's loop analysis
// run for minutes; behind this the bounds are plain runtime values.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
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

template <int DH>
__global__ void __launch_bounds__(kThreads)
paged_split_simt_kernel(const float* __restrict__ q,
                        const float* __restrict__ kpool,
                        const float* __restrict__ vpool,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, float* __restrict__ out,
                        float* __restrict__ pacc, float* __restrict__ pm,
                        float* __restrict__ pl, int B, int H, int Hkv, int G,
                        int pps, int ps, int window, float scale_log2, int L,
                        int direct) {
  constexpr int kVecPerRow = DH / 4;
  constexpr int kRowGroups = kThreads / DH;     // threads sharing a column
  constexpr int kAcc = (kMaxGroup + kRowGroups - 1) / kRowGroups;

  __shared__ float q_s[kMaxGroup][DH];
  __shared__ float k_s[kSimtTile][DH + 1];
  __shared__ float v_s[kSimtTile][DH + 1];
  __shared__ float p_s[kMaxGroup][kSimtTile];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)b * H + (size_t)h * G;
  const size_t part = (size_t)z * B * H + row0;
  const Range r = split_range(pos[b], pps * ps, window, z, L);
  if (r.lo > r.hi) {
    write_empty(pm, pl, out, 4, part, row0, G, DH, direct);
    return;
  }
  const int* trow = table + (size_t)b * pps;
  const int lo = opaque(r.lo), hi = opaque(r.hi);
  const int n_tiles = (hi - lo + kSimtTile) / kSimtTile;

  for (int i = tid; i < G * DH; i += kThreads)
    q_s[i / DH][i % DH] = q[row0 * DH + i];
  if (tid < kMaxGroup) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int col = tid % DH;
  const int rg = tid / DH;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const size_t row_stride = (size_t)Hkv * DH;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = lo + it * kSimtTile;
    const int n_valid = min(kSimtTile, hi - t0 + 1);
    __syncthreads();  // previous tile consumed (and q_s / m_s ready)
    for (int i = tid; i < n_valid * kVecPerRow; i += kThreads) {
      const int tt = i / kVecPerRow, c = (i % kVecPerRow) * 4;
      const int tok = t0 + tt;
      const size_t off = ((size_t)trow[tok / ps] * ps + tok % ps) *
                             row_stride + (size_t)h * DH + c;
      const float4 kv = *reinterpret_cast<const float4*>(kpool + off);
      const float4 vv = *reinterpret_cast<const float4*>(vpool + off);
      k_s[tt][c] = kv.x; k_s[tt][c + 1] = kv.y;
      k_s[tt][c + 2] = kv.z; k_s[tt][c + 3] = kv.w;
      v_s[tt][c] = vv.x; v_s[tt][c + 1] = vv.y;
      v_s[tt][c + 2] = vv.z; v_s[tt][c + 3] = vv.w;
    }
    __syncthreads();
    for (int gg = warp; gg < G; gg += kWarps) {
      const bool valid = lane < n_valid;
      float s = -INFINITY;
      if (valid) {
        float d = 0.f;
#pragma unroll 8
        for (int k = 0; k < DH; ++k) d += q_s[gg][k] * k_s[lane][k];
        s = d * scale_log2;
      }
      const float m_old = m_s[gg];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? exp2f(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[gg][lane] = p;
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);   // 0 on the first tile
        alpha_s[gg] = alpha;
        l_s[gg] = l_s[gg] * alpha + sum;
        m_s[gg] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int gg = rg + i * kRowGroups;
      if (gg < G) {
        float a = acc[i] * alpha_s[gg];
        for (int tt = 0; tt < n_valid; ++tt) a += p_s[gg][tt] * v_s[tt][col];
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int gg = rg + i * kRowGroups;
    if (gg >= G) continue;
    const float l = l_s[gg];
    if (direct) {
      out[(row0 + gg) * DH + col] = l > 0.f ? acc[i] / l : 0.f;
    } else {
      pacc[(part + gg) * DH + col] = acc[i];
      if (col == 0) {
        pm[part + gg] = m_s[gg];
        pl[part + gg] = l;
      }
    }
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* table, const int* pos, void* out,
                       float* pacc, float* pm, float* pl, int B, int H,
                       int Hkv, int pps, int ps, int window,
                       float scale_log2, int n_split, int L, int direct,
                       cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<DH>();
  static_assert(smem >= (kWarps * 16 * (DH + 2)) * (int)sizeof(float),
                "the warps' merge reuses the ring");
  if (smem > 48 * 1024) {
    static bool attr_set = false;     // idempotent, so a race is harmless
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          paged_split_mma_kernel<DH>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      attr_set = true;
    }
  }
  paged_split_mma_kernel<DH><<<dim3(Hkv, B, n_split), kThreads, smem,
                               stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), table, pos, static_cast<bf16*>(out),
      pacc, pm, pl, B, H, Hkv, H / Hkv, pps, ps, window, scale_log2, L,
      direct);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const int* table, const int* pos, void* out,
                        float* pacc, float* pm, float* pl, int B, int H,
                        int Hkv, int pps, int ps, int window,
                        float scale_log2, int n_split, int L, int direct,
                        cudaStream_t stream) {
  paged_split_simt_kernel<DH><<<dim3(Hkv, B, n_split), kThreads, 0,
                                stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), table, pos, static_cast<float*>(out),
      pacc, pm, pl, B, H, Hkv, H / Hkv, pps, ps, window, scale_log2, L,
      direct);
  return cudaGetLastError();
}

cudaError_t launch_split(int dtype, const void* q, const void* k,
                         const void* v, const int* table, const int* pos,
                         void* out, float* pacc, float* pm, float* pl, int B,
                         int H, int Hkv, int Dh, int pps, int ps, int window,
                         float scale, int n_split, int L, int direct,
                         cudaStream_t st) {
  const float sl = scale * kLog2e;
#define REPRO_SPLIT(FN, D)                                                   \
  return FN<D>(q, k, v, table, pos, out, pacc, pm, pl, B, H, Hkv, pps, ps,   \
               window, sl, n_split, L, direct, st)
  if (dtype == 0) {
    switch (Dh) {
      case 16: REPRO_SPLIT(launch_simt, 16);
      case 32: REPRO_SPLIT(launch_simt, 32);
      case 64: REPRO_SPLIT(launch_simt, 64);
      case 128: REPRO_SPLIT(launch_simt, 128);
    }
  } else if (dtype == 1) {
    switch (Dh) {
      case 16: REPRO_SPLIT(launch_mma, 16);
      case 32: REPRO_SPLIT(launch_mma, 32);
      case 64: REPRO_SPLIT(launch_mma, 64);
      case 128: REPRO_SPLIT(launch_mma, 128);
    }
  }
#undef REPRO_SPLIT
  return cudaErrorInvalidValue;
}

bool bad_args(int B, int H, int Hkv, int pps, int ps, int n_split, int L) {
  return Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || B <= 0 ||
         B > 65535 || ps <= 0 || pps <= 0 || n_split <= 0 ||
         n_split > 65535 || L <= 0 || (long long)n_split * L < (long long)pps * ps;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.  n_split
// blocks of split_len positions cover the table's pps * ps positions.
// With n_split 1 the split kernel writes `out`; otherwise it writes the
// partials acc (n_split, B * H, Dh), m and l (n_split, B * H), f32, and
// the combine kernel writes `out`.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int repro_paged_decode(int dtype, const void* q, const void* k,
                                  const void* v, const void* table,
                                  const void* pos, void* out, void* acc,
                                  void* m, void* l, int B, int H, int Hkv,
                                  int Dh, int pps, int ps, int window,
                                  float scale, int n_split, int split_len,
                                  void* stream) {
  if (bad_args(B, H, Hkv, pps, ps, n_split, split_len))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* pacc = static_cast<float*>(acc);
  auto* pm = static_cast<float*>(m);
  auto* pl = static_cast<float*>(l);
  const bool direct = n_split == 1;
  cudaError_t err = launch_split(
      dtype, q, k, v, static_cast<const int*>(table),
      static_cast<const int*>(pos), out, pacc, pm, pl, B, H, Hkv, Dh, pps,
      ps, window, scale, n_split, split_len, direct, st);
  if (err != cudaSuccess || direct) return (int)err;
  return dtype == 0
             ? (int)launch_combine<float>(pacc, pm, pl, out, n_split, B * H,
                                          Dh, st)
             : (int)launch_combine<bf16>(pacc, pm, pl, out, n_split, B * H,
                                         Dh, st);
}

// The split kernel alone, always writing the partials (any n_split), so
// that the combine can be held against its plain version on them.
extern "C" int repro_paged_decode_split(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* table, const void* pos,
                                        void* acc, void* m, void* l, int B,
                                        int H, int Hkv, int Dh, int pps,
                                        int ps, int window, float scale,
                                        int n_split, int split_len,
                                        void* stream) {
  if (bad_args(B, H, Hkv, pps, ps, n_split, split_len))
    return (int)cudaErrorInvalidValue;
  return (int)launch_split(
      dtype, q, k, v, static_cast<const int*>(table),
      static_cast<const int*>(pos), nullptr, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), B, H, Hkv, Dh, pps, ps,
      window, scale, n_split, split_len, 0, static_cast<cudaStream_t>(stream));
}

// The combine kernel alone: partials as above -> out (rows, Dh) in dtype.
extern "C" int repro_paged_decode_combine(int dtype, const void* acc,
                                          const void* m, const void* l,
                                          void* out, int n_split, int rows,
                                          int Dh, void* stream) {
  if (n_split <= 0 || rows <= 0 || Dh <= 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* pacc = static_cast<const float*>(acc);
  const auto* pm = static_cast<const float*>(m);
  const auto* pl = static_cast<const float*>(l);
  if (dtype == 0)
    return (int)launch_combine<float>(pacc, pm, pl, out, n_split, rows, Dh,
                                      st);
  if (dtype == 1)
    return (int)launch_combine<bf16>(pacc, pm, pl, out, n_split, rows, Dh,
                                     st);
  return (int)cudaErrorInvalidValue;
}
