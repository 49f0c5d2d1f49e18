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
// What bounds it: operations.  At the serve shapes (D 128, S 2048-8192)
// a (query tile, key tile) pair does 4 * 64 * 64 * D FLOPs on 2 * 64 * D
// values loaded: 64 FLOP per byte in bf16 from shared memory, and each K/V
// tile is read from device memory by every query tile of the head (from
// L2 after the first).
// The H100's bf16 tensor cores (989 TFLOP/s) are the floor; off them, in
// f32 on the CUDA cores (67 TFLOP/s), the same work takes 15x longer.
//
// Design (the simple first version):
//   * bf16 (the serve path): flash_mma_kernel.  One block of 4 warps per
//     (b * H + h, 64-row query tile); each warp owns 16 query rows, holds
//     its Q fragments in registers for the whole key loop, and scores a
//     64-key tile with mma.sync m16n8k16 (bf16 in, f32 accumulate).  The
//     online softmax (running max and sum, f32) runs on the accumulator
//     fragments; P is rounded to bf16 in registers and re-used as the A
//     operand of the P.V product, V's B fragments come from shared memory
//     through ldmatrix.trans.  K and V tiles are staged in shared memory
//     with 16-byte loads, rows padded by 16 bytes against bank conflicts.
//   * f32 (the reference grid's f32 cases): flash_simt_kernel, the same
//     tiling on the CUDA cores at 32 x 32 tiles: lane j scores key j of the
//     tile for the warp's 8 rows, then owns D / 32 output columns.
//   * Both loop over exactly the key tiles that the causal and window
//     bounds leave for the query tile, so a fully masked tile is never
//     loaded and a windowed prefill costs O(S * W), not O(S^2).  Query
//     tiles are scheduled heaviest first (the last causal tile first).
// A cp.async / TMA ring over the key tiles, wgmma, and splitting long
// rows over several blocks are later work.

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

// ============================================ bf16: tensor cores (mma.sync)
constexpr int kMmaRows = 64;       // query rows per block (16 per warp)
constexpr int kMmaKeys = 64;       // keys per tile

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int Hkv, int causal, int window, float scale) {
  constexpr int KS = D / 16;           // k-steps of Q.K^T
  constexpr int NT = kMmaKeys / 8;     // key n-tiles of a score tile
  constexpr int DN = D / 8;            // d n-tiles of the output
  constexpr int LD = D + 8;            // shared row stride (elements)
  __shared__ __align__(16) __nv_bfloat16 k_s[kMmaKeys * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[kMmaKeys * LD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  // this warp's Q rows as m16n8k16 A fragments, for the whole key loop
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* q0p = q + (((size_t)b * Sq + r0) * H + h) * D;
    const __nv_bfloat16* q1p = q + (((size_t)b * Sq + r1) * H + h) * D;
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

  const __nv_bfloat16* kb = k + (size_t)b * Sk * Hkv * D;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * Hkv * D;
  int lo, hi;
  key_range(q0, kMmaRows, Sk, causal, window, &lo, &hi);
  for (int k0 = lo / kMmaKeys * kMmaKeys; k0 < hi; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile is consumed
    constexpr int kPerRow = D / 8;     // 16-byte chunks per row
    for (int i = threadIdx.x; i < kMmaKeys * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * 8;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (k0 + r < Sk) {
        const size_t off = ((size_t)(k0 + r) * Hkv + hk) * D + c;
        kr = *reinterpret_cast<const uint4*>(kb + off);
        vr = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&k_s[r * LD + c]) = kr;
      *reinterpret_cast<uint4*>(&v_s[r * LD + c]) = vr;
    }
    __syncthreads();

    // ---- scores: (16 rows, 64 keys) per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kp = &k_s[(nt * 8 + g) * LD + ks * 16 + 2 * t];
        mma_bf16(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }
    // ---- mask, running max: s[nt][0..1] are row r0, s[nt][2..3] row r1
    uint32_t ok = 0u;
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        const bool valid = key_ok(key, i < 2 ? r0 : r1, Sk, causal, window);
        ok |= (uint32_t)valid << (nt * 4 + i);
        s[nt][i] = valid ? s[nt][i] * scale : kNeg;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the 4 lanes of a quad hold one row pair
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool valid = (ok >> (nt * 4 + i)) & 1u;
        const float p = valid ? expf(s[nt][i] - (i < 2 ? n0 : n1)) : 0.f;
        s[nt][i] = p;
        if (i < 2) sum0 += p; else sum1 += p;
      }
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
        const int mi = lane >> 3, ri = lane & 7;
        const __nv_bfloat16* vp =
            &v_s[(kc * 16 + (mi & 1) * 8 + ri) * LD + (dn + (mi >> 1)) * 8];
        const uint32_t addr =
            static_cast<uint32_t>(__cvta_generic_to_shared(vp));
        uint32_t b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(addr));
        mma_bf16(o[dn], pa, b0, b1);
        mma_bf16(o[dn + 1], pa, b2, b3);
      }
    }
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* o0p = out + (((size_t)b * Sq + r0) * H + h) * D + 2 * t;
  __nv_bfloat16* o1p = out + (((size_t)b * Sq + r1) * H + h) * D + 2 * t;
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
  const dim3 grid(B * H, (Sq + kMmaRows - 1) / kMmaRows);
  using bf = __nv_bfloat16;
  flash_mma_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<bf*>(out), Sq, Sk, H, Hkv,
      causal, window, scale);
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
      case 128: return (int)launch_mma<128>(q, k, v, out, B, Sq, Sk, H, Hkv,
                                           causal, window, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
