// Flash attention (tiled, online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_kernel
// (launched by flash_attention_bhsd, wrapped by ops.py::flash_attention).
//
// What it computes: for batch b and query head h, row i (0 <= i < Sq)
// attends over keys j (0 <= j < Sk) of kv head h / (H / Hkv) with
//   causal:  j <= i               (top-left alignment: both count from 0,
//                                  as the TPU kernel has it)
//   window:  j > i - window       (when window > 0; with or without causal)
// scores s_ij = scale * q_i . k_j in f32, softmax over the valid j in f32,
// out_i = sum_j p_ij v_j rounded once to the input type.  A row with no
// valid key writes zeros.  Layouts are the wrapper's (B, S, H, D) and
// (B, Sk, Hkv, D), contiguous, so no transpose is ever materialised.
//
// What bounds it: operations.  A (128-query, 64-key) tile pair does
// 4 * 128 * 64 * D FLOPs on 2 * 64 * D K/V values: 128 FLOP per byte at
// D 128, from L2 after the first query tile of a head reads them.  The
// H100's bf16 tensor cores (989 TFLOP/s dense) are the floor: 0.0434 ms at
// qwen2.5-14b's 1 x 2048 causal prefill, 0.4169 ms at mixtral-8x7b's
// 1 x 8192 with window 4096.  Off them, in f32 on the CUDA cores (67
// TFLOP/s), the same work takes 15x longer.
//
// Design:
//   * bf16, D 128 (the serve path): flash_wgmma_kernel, below.  A block
//     of two consumer warpgroups (128 query rows) and one producer warp.
//     The producer keeps a 3-stage ring of 64-key K/V tiles full by TMA
//     (128-byte swizzle, mbarriers; the tensor maps come from
//     cuTensorMapEncodeTiled, looked up at run time).  The products run on wgmma (bf16
//     in, f32 accumulate): S = Q.K^T from shared memory, O += P.V with P
//     from registers and V's transpose taken by the descriptor.
//   * bf16, D 32 and 64 (the reference grid): flash_mma_kernel.  8 warps
//     of 16 rows each (128 rows a block), Q fragments in registers, a
//     3-stage cp.async ring of 64-key tiles, mma.sync m16n8k16 with K's B
//     fragments through ldmatrix and V's through ldmatrix.trans.  It was
//     also the first, pipelined stage of the D 128 kernel.
//   * f32 (the reference grid's f32 cases): flash_simt_kernel, the same
//     tiling on the CUDA cores at 32 x 32 tiles: lane j scores key j of the
//     tile for the warp's 8 rows, then owns D / 32 output columns.
//   * All three loop over exactly the key tiles that the causal and window
//     bounds leave for the query tile, so a fully masked tile is never
//     loaded and a windowed prefill costs O(S * W), not O(S^2); query
//     tiles run heaviest first (the last causal tile first).  The bf16
//     kernels take the softmax in log2 units (exp2f, log2(e) folded into
//     the scale) and mask only the tiles that the diagonal or the window
//     edge cuts; interior tiles run unmasked.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md): the
// first version here (4 warps, 64 rows, loads and products never
// overlapping, mma.sync) took 0.4453 / 4.0101 ms at qwen's / mixtral's
// prefill, about 100 TFLOP/s.  The cp.async + mma.sync stage took about
// 0.20 / 1.68 ms; this wgmma kernel about 0.18 / 1.34 ms (some 300
// TFLOP/s), against SDPA's 0.10 / 3.4 ms.  Where its time goes next: each
// warpgroup waits for its S and P.V before its softmax (running the
// softmax under P.V made ptxas serialise the products), and a block's
// set-up (Q staged, the ring's first loads) is not overlapped with the
// previous block's tail.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>


namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ bool key_ok(int key, int row, int Sk, int causal,
                                       int window) {
  return key < Sk && (!causal || key <= row) &&
         (window <= 0 || key > row - window);
}

// first key that any row of the tile [q0, q0 + rows) may see, and one past
// the last
__device__ __forceinline__ void key_range(int q0, int rows, int Sk,
                                          int causal, int window, int* lo,
                                          int* hi) {
  *hi = causal ? min(Sk, q0 + rows) : Sk;
  *lo = window > 0 ? max(0, q0 - window + 1) : 0;
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

// ===================================================== f32: CUDA cores
constexpr int kSimtRows = 32;      // query rows per block (8 per warp)
constexpr int kSimtKeys = 32;      // keys per tile (one per lane)
constexpr int kSimtRowsPerWarp = kSimtRows / (kThreads / 32);

template <int D>
size_t simt_smem_bytes() {
  return sizeof(float) * ((size_t)kSimtRows * D + kSimtKeys * (D + 1) +
                          kSimtKeys * D + kSimtRows * kSimtKeys);
}

// rows [r0, r0 + n) of a (S, heads, D) array at head hh -> dst (n, ld);
// rows at or past S are zeros
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src, int r0, int n,
                                              int S, int heads, int hh) {
  constexpr int kPerRow = D / 4;     // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      x = *reinterpret_cast<const float4*>(
          src + ((size_t)(r0 + r) * heads + hh) * D + c);
    float* d = dst + r * ld + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Sk, int H, int Hkv, int causal, int window,
                  float scale) {
  constexpr int R = kSimtRowsPerWarp;
  constexpr int C = D / 32;
  extern __shared__ float sm[];
  float* q_s = sm;                              // (32, D)
  float* k_s = q_s + kSimtRows * D;             // (32, D + 1)
  float* v_s = k_s + kSimtKeys * (D + 1);       // (32, D)
  float* p_s = v_s + kSimtKeys * D;             // (32 rows, 32 keys)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kSimtRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qb = q + (size_t)b * Sq * H * D;
  const float* kb = k + (size_t)b * Sk * Hkv * D;
  const float* vb = v + (size_t)b * Sk * Hkv * D;

  load_tile_f32<D>(q_s, D, qb, q0, kSimtRows, Sq, H, h);
  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  int lo, hi;
  key_range(q0, kSimtRows, Sk, causal, window, &lo, &hi);
  for (int k0 = lo / kSimtKeys * kSimtKeys; k0 < hi; k0 += kSimtKeys) {
    __syncthreads();  // the previous tile is consumed (and q_s is loaded)
    load_tile_f32<D>(k_s, D + 1, kb, k0, kSimtKeys, Sk, Hkv, hk);
    load_tile_f32<D>(v_s, D, vb, k0, kSimtKeys, Sk, Hkv, hk);
    __syncthreads();
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = k_s[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += q_s[(warp * R + r) * D + d] * kv;
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q0 + warp * R + r;
      const bool ok = key_ok(key, row, Sk, causal, window);
      const float x = ok ? s[r] * scale : kNeg;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
      p_s[(warp * R + r) * kSimtKeys + lane] = p;
    }
    __syncwarp();
    for (int t = 0; t < kSimtKeys; ++t) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = v_s[t * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = p_s[(warp * R + r) * kSimtKeys + t];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] += p * vv[c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + warp * R + r;
    if (row >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* ob = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) ob[lane + 32 * c] = acc[r][c] * inv;
  }
}

// ==================================== bf16: tensor cores (mma.sync, ring)
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows per block
constexpr int kMmaKeys = 64;               // keys per tile
constexpr int kMmaStages = 3;              // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
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

template <int D>
constexpr int mma_smem_bytes() {
  return kMmaStages * 2 * kMmaKeys * (D + 8) * (int)sizeof(__nv_bfloat16);
}

// One block of 8 warps per (b * H + h, 128-row query tile); warp w owns
// rows q0 + 16 w .. + 15 and keeps their Q fragments in registers.  K/V
// tiles of 64 keys stream through a 3-stage cp.async ring; K's B
// fragments come through ldmatrix, V's through ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int Hkv, int causal, int window, float scale_log2) {
  using bf = __nv_bfloat16;
  constexpr int KS = D / 16;           // k-steps of Q.K^T
  constexpr int NT = kMmaKeys / 8;     // key n-tiles of a score tile
  constexpr int DN = D / 8;            // d n-tiles of the output
  constexpr int LD = D + 8;            // shared row stride (elements)
  constexpr int kChunks = D / 8;       // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* ring = reinterpret_cast<bf*>(smem_raw);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int rw0 = q0 + warp * 16;               // this warp's first row
  const int r0 = rw0 + g, r1 = r0 + 8;

  const bf* kb = k + (size_t)b * Sk * Hkv * D + (size_t)hk * D;
  const bf* vb = v + (size_t)b * Sk * Hkv * D + (size_t)hk * D;
  int lo, hi;
  key_range(q0, kMmaRows, Sk, causal, window, &lo, &hi);
  const int kt0 = lo / kMmaKeys * kMmaKeys;
  const int n_tiles = hi > kt0 ? (hi - kt0 + kMmaKeys - 1) / kMmaKeys : 0;

  auto load_tile = [&](int it) {
    const int k0 = kt0 + it * kMmaKeys;
    bf* ks = ring + (size_t)(it % kMmaStages) * 2 * kMmaKeys * LD;
    bf* vs = ks + kMmaKeys * LD;
    for (int i = tid; i < kMmaKeys * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = k0 + r < Sk;
      const size_t off = ok ? (size_t)(k0 + r) * Hkv * D + c : 0;
      cp_async16(smem_u32(ks + r * LD + c), kb + off, ok ? 16 : 0);
      cp_async16(smem_u32(vs + r * LD + c), vb + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // this warp's Q rows as m16n8k16 A fragments, for the whole key loop
  uint32_t qa[KS][4];
  {
    const bf* q0p = q + (((size_t)b * Sq + r0) * H + h) * D;
    const bf* q1p = q + (((size_t)b * Sq + r1) * H + h) * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + 2 * t;
      qa[ks][0] = r0 < Sq ? ld32(q0p + c) : 0u;
      qa[ks][1] = r1 < Sq ? ld32(q1p + c) : 0u;
      qa[ks][2] = r0 < Sq ? ld32(q0p + c + 8) : 0u;
      qa[ks][3] = r1 < Sq ? ld32(q1p + c + 8) : 0u;
    }
  }
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // rows r0 and r1

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kMmaStages - 2>();   // tile `it` has landed
    __syncthreads();                   // ... for every thread; tile it - 1
                                       // is consumed, so its stage refills
    if (it + kMmaStages - 1 < n_tiles) load_tile(it + kMmaStages - 1);
    cp_async_commit();

    const int k0 = kt0 + it * kMmaKeys;
    // what the mask leaves of this tile for the warp's 16 rows
    const bool none = rw0 >= Sq || (causal && k0 > rw0 + 15) ||
                      (window > 0 && k0 + kMmaKeys - 1 <= rw0 - window);
    if (none) continue;
    const bool all = k0 + kMmaKeys <= Sk &&
                     (!causal || k0 + kMmaKeys - 1 <= rw0) &&
                     (window <= 0 || k0 > rw0 + 15 - window);
    const bf* ks_ = ring + (size_t)(it % kMmaStages) * 2 * kMmaKeys * LD;
    const bf* vs_ = ks_ + kMmaKeys * LD;

    // ---- scores: (16 rows, 64 keys) per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(ks_ + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LD +
                         ks * 16 + (mi & 1) * 8),
                kf);
        mma_bf16(s[2 * np], qa[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[ks], kf[2], kf[3]);
      }
    }
    // ---- scale (log2 units), mask on edge tiles only, running max:
    // s[nt][0..1] are row r0, s[nt][2..3] row r1
    float mx0 = kNeg, mx1 = kNeg;
    if (all) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] *= scale_log2;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          s[nt][i] = key_ok(key, i < 2 ? r0 : r1, Sk, causal, window)
                         ? s[nt][i] * scale_log2
                         : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    // the 4 lanes of a quad hold one row pair
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // masked scores are -inf and the running max stays finite (kNeg), so
    // a masked p is exp2f(-inf) = 0 exactly
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - n0);
      s[nt][1] = exp2f(s[nt][1] - n0);
      s[nt][2] = exp2f(s[nt][2] - n1);
      s[nt][3] = exp2f(s[nt][3] - n1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    // per-lane partial sums: the quad's lanes share the scale factor, so
    // the partial sums are added across the quad once, at the end
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }
    // ---- O += P . V, 16 keys per k-step
#pragma unroll
    for (int kc = 0; kc < kMmaKeys / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        // four 8x8 matrices, transposed: keys 0-7 / 8-15 of this k-step at
        // columns dn*8.. and (dn+1)*8..; lane l addresses row l % 8 of
        // matrix l / 8
        uint32_t vf[4];
        ldsm_x4_t(smem_u32(vs_ + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                           (dn + (mi >> 1)) * 8),
                  vf);
        mma_bf16(o[dn], pa, vf[0], vf[1]);
        mma_bf16(o[dn + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  bf* o0p = out + (((size_t)b * Sq + r0) * H + h) * D + 2 * t;
  bf* o1p = out + (((size_t)b * Sq + r1) * H + h) * D + 2 * t;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o0p + dn * 8) =
          pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(o1p + dn * 8) =
          pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

// ================================ bf16, D 128: tensor cores (wgmma, TMA)
// One block of 2 consumer warpgroups (64 query rows each, 128 a block)
// and 1 producer warp.  The producer's one thread fills a 3-stage ring of
// 64-key K/V tiles by TMA (cp.async.bulk.tensor, 128-byte swizzle, keys
// past Sk zero-filled by the hardware), each stage guarded by a "full"
// mbarrier (the bytes landed) and an "empty" one (both warpgroups are done
// with it).  The warpgroups run on their own, with no block barrier
// between them, so one's softmax overlaps the other's products.  Each
// warpgroup runs S = Q.K^T on wgmma from shared memory (Q staged once,
// K K-major), and O += P.V with P (the softmax of S, bf16) in registers
// as the A operand and V MN-major (its transpose taken by the
// descriptor); S of the next tile goes out with P.V of this one.
constexpr int kWgConsumers = 256;          // 2 warpgroups
constexpr int kWgThreads = kWgConsumers + 32;   // + the producer warp
constexpr int kWgRows = 128;               // query rows per block
constexpr int kWgKeys = 64;                // keys per tile
constexpr int kWgStages = 3;
constexpr int kWgD = 128;
constexpr int kAtom = 64 * 128;            // 64 rows x 128 B: one swizzle
                                           // atom column (64 of D)
constexpr int kWgTile = 2 * kAtom;         // a K or V tile, or a
                                           // warpgroup's Q rows, bytes
constexpr int kWgBarOff = (kWgStages * 2 + 2) * kWgTile;
constexpr int kWgSmem = kWgBarOff + 2 * kWgStages * 8 + 1024;  // + align

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint64_t& x) {
  asm volatile("" : "+l"(x)::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}


// the accumulator operand lists of the two batches
#define ACC32 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31" \
  "}"
#define ACC64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63" \
  "}"

// S (64 x 64, f32) = Q . K^T over D = 128: 8 x m64n64k16, A and B bf16
// in shared memory through descriptors (both K-major).  One asm
// statement, so that nothing (not even the scale predicate) is defined
// between two products of the batch: ptxas would serialise them.
__device__ __forceinline__ void wgmma_scores(float* d, const uint64_t* da,
                                             const uint64_t* db) {
  asm volatile(
      "{\n.reg .pred p0, p1;\n"
      "setp.ne.b32 p0, %48, %48;\n"
      "setp.eq.b32 p1, %48, %48;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %32, %40, p0, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %33, %41, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %34, %42, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %35, %43, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %36, %44, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %37, %45, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %38, %46, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %39, %47, p1, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(da[4]),
        "l"(da[5]), "l"(da[6]), "l"(da[7]), "l"(db[0]), "l"(db[1]),
        "l"(db[2]), "l"(db[3]), "l"(db[4]), "l"(db[5]), "l"(db[6]),
        "l"(db[7]), "r"(0));
}

// O (64 x 128, f32) += P . V over 64 keys: 4 x m64n128k16, P bf16 in
// registers (a[kc][0..3] for keys 16 kc ..), V bf16 in shared memory
// through descriptors, MN-major.  One asm statement, as above.
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t (*a)[4],
                                         const uint64_t* db) {
  asm volatile(
      "{\n.reg .pred p1;\n"
      "setp.eq.b32 p1, %84, %84;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64
      ", {%64, %65, %66, %67}, %80, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64
      ", {%68, %69, %70, %71}, %81, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64
      ", {%72, %73, %74, %75}, %82, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64
      ", {%76, %77, %78, %79}, %83, p1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
        "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
        "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
        "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3]), "r"(0));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// box (64 of D, 1 head, 64 keys, 1 batch) at (d0, hk, k0, b) -> dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* m,
                                         int d0, int hk, int k0, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(m)), "r"(d0), "r"(hk),
         "r"(k0), "r"(b), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __nv_bfloat16* __restrict__ q,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                   int Hkv, int causal, int window, float scale_log2) {
  using bf = __nv_bfloat16;
  constexpr int D = kWgD;
  constexpr int KS = D / 16;           // k-steps of Q.K^T
  constexpr int NT = kWgKeys / 8;      // key n-tiles of a score tile
  constexpr int DN = D / 8;            // d n-tiles of the output
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of address bits 4-9: atoms 1024-aligned
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + kWgBarOff;       // kWgStages mbarriers
  const uint32_t empty = full + 8 * kWgStages;  // kWgStages mbarriers

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lo, hi;
  key_range(q0, kWgRows, Sk, causal, window, &lo, &hi);
  const int kt0 = lo / kWgKeys * kWgKeys;
  const int n_tiles = hi > kt0 ? (hi - kt0 + kWgKeys - 1) / kWgKeys : 0;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWgConsumers / 32);   // per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {
    // ---- producer: one thread keeps the ring full
    if (lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kWgStages, use = it / kWgStages;
        if (use > 0) mbar_wait(empty + 8 * st, (use - 1) & 1);
        const uint32_t dst = ring + st * 2 * kWgTile;
        const uint32_t bar = full + 8 * st;
        const int k0 = kt0 + it * kWgKeys;
        mbar_arrive_tx(bar, 2 * kWgTile);
        tma_load(dst, &tm_k, 0, hk, k0, b, bar);
        tma_load(dst + kAtom, &tm_k, 64, hk, k0, b, bar);
        tma_load(dst + kWgTile, &tm_v, 0, hk, k0, b, bar);
        tma_load(dst + kWgTile + kAtom, &tm_v, 64, hk, k0, b, bar);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows rwg .. rwg + 63
  const int wg = warp >> 2, tw = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int rwg = q0 + wg * 64;
  const int rw0 = rwg + (warp & 3) * 16;        // this warp's first row
  const int r0 = rw0 + g, r1 = r0 + 8;

  // Q rows of the warpgroup, staged once in the swizzled layout
  const uint32_t qs = ring + (kWgStages * 2 + wg) * kWgTile;
  for (int i = tw; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (rwg + r < Sq)
      x = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + rwg + r) * H + h) * D + c * 8);
    const uint32_t dst = qs + (c >> 3) * kAtom + r * 128 +
                         (((c & 7) ^ (r & 7)) << 4);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(dst), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
                 : "memory");
  }
  // generic-proxy stores, read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

  // accumulator layout (per warp, as mma.sync's per n-tile): element
  // 4 j + i is row g + 8 (i / 2), column 8 j + 2 t + i % 2
  float o[4 * DN], sn[4 * NT];
#pragma unroll
  for (int i = 0; i < 4 * DN; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) sn[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // rows r0 and r1
  float a0 = 1.f, a1 = 1.f;          // o's rescale for the newest softmax
  uint32_t pa[kWgKeys / 16][4];      // P as P.V's A fragments

  // Every input of a batch of products (descriptors, the scale flags) is
  // computed before the batch's first wgmma and pinned there: an input
  // defined between two wgmma of a batch makes ptxas serialise them.
  // Q's descriptors are the same for every tile: 16 of D a k-step, 32 B
  // into an atom.
  uint64_t dq[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    dq[k] = sw128_desc(qs + (k >> 2) * kAtom + (k & 3) * 32, 16, 1024);
    pin(dq[k]);
  }
  // S = Q . K^T of tile `it` into sn (K-major A and B)
  auto issue_scores = [&](int it) {
    const uint32_t ks = ring + (it % kWgStages) * 2 * kWgTile;
    uint64_t dk[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      dk[k] = sw128_desc(ks + (k >> 2) * kAtom + (k & 3) * 32, 16, 1024);
      pin(dk[k]);
    }
    fence_regs<4 * NT>(sn);
    wgmma_fence();
    wgmma_scores(sn, dq, dk);
    wgmma_commit();
  };
  // the online softmax of tile `it`'s scores (sn, retired) into pa, the
  // running max / sum, and o's rescale factors a0, a1
  auto softmax = [&](int it) {
    const int k0 = kt0 + it * kWgKeys;
    const bool all = k0 + kWgKeys <= Sk &&
                     (!causal || k0 + kWgKeys - 1 <= rw0) &&
                     (window <= 0 || k0 > rw0 + 15 - window);
    float x[4 * NT];
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + j * 8 + 2 * t + (i & 1);
        x[4 * j + i] =
            all || key_ok(key, i < 2 ? r0 : r1, Sk, causal, window)
                ? sn[4 * j + i] * scale_log2
                : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(x[4 * j], x[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(x[4 * j + 2], x[4 * j + 3]));
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    // masked scores are -inf and the running max stays finite (kNeg), so
    // a masked p is exp2f(-inf) = 0 exactly
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    a0 = exp2f(m0 - n0);
    a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(x[4 * j] - n0), p1 = exp2f(x[4 * j + 1] - n0);
      const float p2 = exp2f(x[4 * j + 2] - n1);
      const float p3 = exp2f(x[4 * j + 3] - n1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      // n-tile j is half of k-step j / 2 of P . V: keys 0-7 of the k-step
      // -> a0, a1; keys 8-15 -> a2, a3
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
  };
  // o takes the newest softmax's rescale (no P.V in flight)
  auto rescale = [&]() {
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
  };

  // O += P . V of tile `it`: V MN-major (D contiguous), 16 keys (2 KB) a
  // k-step; LBO steps over the two atoms of D, SBO over 8 keys.  Its
  // inputs are made first (pv_inputs), before S of the next tile is
  // issued, so that none is defined while a product is in flight.
  auto pv_inputs = [&](int it, uint64_t* dv) {
    const uint32_t vs = ring + (it % kWgStages) * 2 * kWgTile + kWgTile;
#pragma unroll
    for (int kc = 0; kc < kWgKeys / 16; ++kc) {
      dv[kc] = sw128_desc(vs + kc * 2048, kAtom, 1024);
      pin(dv[kc]);
    }
    fence_regs<4 * DN>(o);
  };
  auto issue_pv = [&](const uint64_t* dv) {
    wgmma_fence();
    wgmma_pv(o, pa, dv);
    wgmma_commit();
  };

  // Per tile a warpgroup issues S of the next tile and P.V of this one
  // together, waits for both, then runs the next tile's softmax; the two
  // warpgroups drift apart, so one's softmax runs while the other's
  // products do.  Every tile of the block's range runs the same products
  // (a tile the mask empties for a warpgroup gives p = 0): with no branch
  // around them, every input made before a batch is issued, and the wait
  // retiring all of them before the softmax reads or writes their
  // registers, ptxas keeps each batch asynchronous.  (Waiting for S alone
  // and running the softmax under P.V made ptxas serialise the products.)
  if (n_tiles > 0) {
    mbar_wait(full, 0);
    issue_scores(0);
    wgmma_wait<0>();
    fence_regs<4 * NT>(sn);
    softmax(0);
    rescale();
    uint64_t dv[kWgKeys / 16];
    for (int it = 0; it + 1 < n_tiles; ++it) {
      pv_inputs(it, dv);
      mbar_wait(full + 8 * ((it + 1) % kWgStages),
                ((it + 1) / kWgStages) & 1);
      issue_scores(it + 1);
      issue_pv(dv);
      wgmma_wait<0>();               // S of it + 1 and P.V of it
      fence_regs<4 * NT>(sn);
      fence_regs<4 * DN>(o);
      fence_regs<kWgKeys / 4>(&pa[0][0]);
      if (lane == 0)                 // this warp is done with tile it
        mbar_arrive(empty + 8 * (it % kWgStages));
      softmax(it + 1);
      rescale();
    }
    pv_inputs(n_tiles - 1, dv);
    issue_pv(dv);
    wgmma_wait<0>();
    fence_regs<4 * DN>(o);
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  bf* o0p = out + (((size_t)b * Sq + r0) * H + h) * D + 2 * t;
  bf* o1p = out + (((size_t)b * Sq + r1) * H + h) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o0p + j * 8) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(o1p + j * 8) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int Hkv,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  const size_t smem = simt_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kSimtRows - 1) / kSimtRows);
  flash_simt_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Sk, int H, int Hkv,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int smem = mma_smem_bytes<D>();
  static bool attr_set = false;       // idempotent, so a race is harmless
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(B * H, (Sq + kMmaRows - 1) / kMmaRows);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<bf*>(out), Sq, Sk, H, Hkv,
      causal, window, scale * kLog2e);
  return cudaGetLastError();
}

// The 4-D tensor map of a (B, Sk, Hkv, 128) bf16 array for 64-key,
// 64-column boxes of one head in the 128-byte swizzle.
// cuTensorMapEncodeTiled is looked up at run time through the runtime's
// entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t kv_tensor_map(CUtensorMap* m, const void* base, int B, int Sk,
                          int Hkv) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {kWgD, (cuuint64_t)Hkv, (cuuint64_t)Sk,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {kWgD * 2, (cuuint64_t)Hkv * kWgD * 2,
                                 (cuuint64_t)Sk * Hkv * kWgD * 2};
  const cuuint32_t box[4] = {64, 1, kWgKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int Hkv,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  using bf = __nv_bfloat16;
  static bool attr_set = false;       // idempotent, so a race is harmless
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap tk{}, tv{};
  if (Sk > 0) {                       // no key: no tile is ever loaded
    cudaError_t err = kv_tensor_map(&tk, k, B, Sk, Hkv);
    if (err == cudaSuccess) err = kv_tensor_map(&tv, v, B, Sk, Hkv);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, (Sq + kWgRows - 1) / kWgRows);
  flash_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      tk, tv, static_cast<const bf*>(q), static_cast<bf*>(out), Sq, Sk, H,
      Hkv, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// q, out (B, Sq, H, D); k, v (B, Sk, Hkv, D); contiguous, 16-byte aligned.
// D in {32, 64, 128}; H % Hkv == 0; window <= 0: no window; causal 0/1.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int Hkv, int D,
                                     int causal, int window, float scale,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || Hkv <= 0 || H % Hkv != 0 ||
      (Sq + kSimtRows - 1) / kSimtRows > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 32: return (int)launch_simt<32>(q, k, v, out, B, Sq, Sk, H, Hkv,
                                          causal, window, scale, st);
      case 64: return (int)launch_simt<64>(q, k, v, out, B, Sq, Sk, H, Hkv,
                                          causal, window, scale, st);
      case 128: return (int)launch_simt<128>(q, k, v, out, B, Sq, Sk, H,
                                            Hkv, causal, window, scale, st);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return (int)launch_mma<32>(q, k, v, out, B, Sq, Sk, H, Hkv,
                                         causal, window, scale, st);
      case 64: return (int)launch_mma<64>(q, k, v, out, B, Sq, Sk, H, Hkv,
                                         causal, window, scale, st);
      case 128: return (int)launch_wgmma(
          q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
