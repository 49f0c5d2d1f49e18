// Mamba2 SSD chunk scan for Hopper (sm_90a): chunk-parallel, bf16 products
// on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk/kernel.py::_kernel
// (launched by ssd_scan_bh, wrapped by ops.py::ssd_scan).
//
// What it computes, per (batch b, head h), from a zero state, chunk by
// chunk over the sequence (positions c0 .. c0 + L - 1 of a chunk, the last
// chunk possibly shorter):
//   cum_i  = sum_{k <= i} dt_k * a                    (inclusive, f32)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (diag)
//          + exp(cum_i) C_i . h^T                                  (off-diag)
//   h     <- exp(cum_L-1) h + sum_j exp(cum_L-1 - cum_j) dt_j x_j B_j^T
// with x (S, P), B and C (S, N), y (S, P) in the activation type and the
// state h (P, N) carried in f32; h_final is written in f32.  Positions past
// S do not exist: a short last chunk is a chunk of length L, so they add
// nothing to y or to the state.  The math does not depend on the chunk
// length, which is why the port's kernel takes cfg.ssm_chunk where
// models/ssm.py::ssd_chunked picks S // max(1, S // chunk).
//
// Layout: x, B, C and y in (B, S, H, .) read and written through their
// element strides (the last axis unit-stride), so the model's views go in
// as they are: a head stride of 0 for B and C (mamba2's ngroups = 1 view,
// models/ssm.py) is read in place, once per group from device memory.
//
// What bounds it: at mamba2-780m's batch-1 prefill (S 2048, H 48, P 64,
// N 128, chunk 256) the work is 8.1 GFLOP (0.0082 ms at the H100 SXM's
// published 989 TFLOP/s bf16) against about 28 MB read and written once
// with B and C counted once per group (0.0084 ms at 3.35 TB/s): both
// bounds about equal.  The first version (one block per (b, h) walking
// its chunks in series with f32 FMAs) took 5.23 ms on an NVIDIA H100 80GB
// HBM3 at 700.00 W: 48 blocks for 132 SMs and the CUDA cores' ~20 FLOP
// per byte.
//
// Design (the standard Mamba2 chunk-parallel scan, three launches from one
// host entry):
//   1. chunk states, grid (B*H, n_chunks), 4 warps: the f32 cumsum of
//      dt * a over the chunk (warp 0: 8 positions a lane, shuffle scan),
//      then S_c = (x * w)^T B with w_j = dt_j exp(cum_last - cum_j), a
//      (P x L) (L x N) product on mma.sync m16n8k16 (bf16 in, f32
//      accumulate; warp w owns 16 state rows) over 64-position tiles, x
//      scaled in registers on its way to shared memory, B by cp.async.
//      S_c and cum_last go to f32 scratch the wrapper allocates.
//   2. state pass, grid (P*N / 256, B*H): a thread per state element walks
//      the chunks, h_c = exp(cum_last_c) h_{c-1} + S_c, overwriting S_c
//      with the state entering chunk c and writing h_final; it loads 8
//      chunks' values at once, so the walk waits on memory once per 8.
//   3. chunk output, grid (B*H, n_chunks, chunk / 64): a block per
//      64-row tile I of a chunk, warp w owns 16 rows.  C_I stays in
//      registers as A fragments; y = exp(cum_i) C_I h_prev^T (h_prev
//      rounded to bf16 in shared memory), then for each column tile J <= I
//      G = C_I B_J^T on the tensor cores, masked and weighted in f32 by
//      exp(cum_i - cum_j) dt_j (j <= i), packed to bf16 A fragments in
//      registers and multiplied into the raw x_J (ldmatrix.trans), so x is
//      never rounded after it is read.  The diagonal tile skips the blocks
//      above the diagonal.  y is written once, in x's type.
//   At batch 1 phases 1 and 3 run 384 and 1536 blocks, phase 2 1536.
//   f32: the first version's serial kernel (one block per (b, h), f32 FMAs,
//   now through the same strides) -- the reference grid's f32 cases only.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): 0.1266 ms by
// CUDA events at mamba2's batch-1 prefill with B and C in the model's
// layout, 0.1182 ms of device time for the three launches, against 1.57
// ms for the plain version; 1.675 ms at batch 16.  The chunk output is
// about three quarters of it.  Next for it: compute C B^T once per
// (group, chunk) for all the group's heads, and hand the chunk output its
// cumsum and a bf16 h_prev instead of recomputing and converting them in
// every row tile (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

struct Args {
  const void* x;
  const float* dt;
  const float* a;          // (H,)
  const void* bm;
  const void* cm;
  void* y;                 // (B, S, H, P), contiguous
  float* hf;               // (B, H, P, N)
  float* states;           // (B, H, nc, P, N): S_c, then the state entering c
  float* decay;            // (B, H, nc): cum_last of each chunk
  int H, S, P, N, chunk, nc;
  Strides xs, ds, bs, cs;
};

// ============================================================ bf16 phases
constexpr int kThreads = 128;            // 4 warps
constexpr int kRows = 64;                // position / row tile

// rows [r0, r0 + kRows) of a (rows, W) strided bf16 array into dst (kRows,
// ld) by cp.async, W16 = round16(W) columns; rows >= nr and columns >= W
// zero-filled (nothing read behind them)
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long row_stride, int nr,
                                          int W, int W16) {
  const int vecs = W16 / 8;
  for (int i = threadIdx.x; i < kRows * vecs; i += kThreads) {
    const int r = i / vecs, k = (i % vecs) * 8;
    const bool ok = r < nr && k < W;
    cp_async16(smem_addr(dst + r * ld + k),
               ok ? src + r * row_stride + k : src, ok ? 16 : 0);
  }
}

// ---- phase 1: S_c = (x w)^T B, cum_last
__global__ void __launch_bounds__(kThreads)
ssd_states_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int P = g.P, N = g.N, P16 = round16(P), N16 = round16(N);
  const int LDP = P16 + 8, LDN = N16 + 8;     // odd multiples of 16 bytes
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cum_s = dt_s + kMaxChunk;
  bf16* x_s = reinterpret_cast<bf16*>(cum_s + kMaxChunk);  // (kRows, LDP)
  bf16* b_s = x_s + kRows * LDP;                           // (kRows, LDN)

  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  const float cum_last = cum_s[L - 1];
  for (int i = tid; i < kMaxChunk; i += kThreads)   // w_j, in place of dt
    dt_s[i] = i < L ? dt_s[i] * expf(cum_last - cum_s[i]) : 0.f;
  __syncthreads();

  const bf16* xb = static_cast<const bf16*>(g.x) + off(g.xs, b, c0, h);
  const bf16* bb = static_cast<const bf16*>(g.bm) + off(g.bs, b, c0, h);
  float acc[kMaxN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const bool active = warp * 16 < P16;           // warp w: state rows 16w..

  for (int t0 = 0; t0 < L; t0 += kRows) {
    const int nr = min(kRows, L - t0);
    load_tile(b_s, LDN, bb + t0 * g.bs.s, g.bs.s, nr, N, N16);
    cp_async_commit();
    // x rows times w_j, through registers (8 values a thread at a time)
    const int vecs = P16 / 8;
    for (int i = tid; i < kRows * vecs; i += kThreads) {
      const int r = i / vecs, k = (i % vecs) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nr && k < P) {
        v = *reinterpret_cast<const uint4*>(xb + (t0 + r) * g.xs.s + k);
        const float w = dt_s[t0 + r];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(e[q]);
          e[q] = __floats2bfloat162_rn(f.x * w, f.y * w);
        }
      }
      *reinterpret_cast<uint4*>(x_s + r * LDP + k) = v;
    }
    cp_async_wait_all();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        if (ks * 16 >= nr) break;
        uint32_t af[4];     // A = (x w)^T: rows p, k = positions (x_s^T)
        ldsm_x4_t(smem_addr(x_s + (ks * 16 + (mi >> 1) * 8 + (lane & 7)) *
                                      LDP + warp * 16 + (mi & 1) * 8),
                  af);
#pragma unroll
        for (int nt = 0; nt < kMaxN / 8; nt += 2) {
          if (nt * 8 >= N16) break;
          uint32_t vb[4];   // B = (positions, n), n contiguous
          ldsm_x4_t(smem_addr(b_s + (ks * 16 + (mi & 1) * 8 + (lane & 7)) *
                                        LDN + (nt + (mi >> 1)) * 8),
                    vb);
          mma_bf16(acc[nt], af, vb[0], vb[1]);
          mma_bf16(acc[nt + 1], af, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // x_s, b_s consumed before the next tile
  }

  float* st = g.states + ((size_t)bh * g.nc + c) * P * N;
  if (active) {
    const int p0 = warp * 16 + gq, p1 = p0 + 8;
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = nt * 8 + 2 * tq;
      if (n >= N) break;
      if (p0 < P)
        *reinterpret_cast<float2*>(st + p0 * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (p1 < P)
        *reinterpret_cast<float2*>(st + p1 * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  if (tid == 0) g.decay[(size_t)bh * g.nc + c] = cum_last;
}

// ---- phase 2: the state entering each chunk, and h_final.  The loads of
// kPass chunks are issued together, so a thread waits once per kPass
// chunks rather than once per chunk.
constexpr int kPass = 8;

__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                float* __restrict__ hf, int nc, int PN) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= PN) return;
  float* s = states + (size_t)bh * nc * PN + e;
  const float* d = decay + (size_t)bh * nc;
  float hc = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPass) {
    float sc[kPass], dc[kPass];
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      sc[k] = c0 + k < nc ? s[(size_t)(c0 + k) * PN] : 0.f;
      dc[k] = c0 + k < nc ? expf(d[c0 + k]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      if (c0 + k < nc) {
        s[(size_t)(c0 + k) * PN] = hc;
        hc = dc[k] * hc + sc[k];
      }
    }
  }
  hf[(size_t)bh * PN + e] = hc;
}

// ---- phase 3: y of one 64-row tile of a chunk
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, c = blockIdx.y, I = blockIdx.z;
  const int b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int i0 = I * kRows;
  if (i0 >= L) return;                       // rows past S do not exist
  const int P = g.P, N = g.N, P16 = round16(P), N16 = round16(N);
  const int LDP = P16 + 8, LDN = N16 + 8;
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cum_s = dt_s + kMaxChunk;
  bf16* c_s = reinterpret_cast<bf16*>(cum_s + kMaxChunk);  // (kRows, LDN)
  bf16* b_s = c_s + kRows * LDN;          // (kRows, LDN); first h_prev (P16)
  bf16* x_s = b_s + kRows * LDN;          // (kRows, LDP)

  const bf16* xb = static_cast<const bf16*>(g.x) + off(g.xs, b, c0, h);
  const bf16* bb = static_cast<const bf16*>(g.bm) + off(g.bs, b, c0, h);
  const bf16* cb = static_cast<const bf16*>(g.cm) + off(g.cs, b, c0, h);
  load_tile(c_s, LDN, cb + i0 * g.cs.s, g.cs.s, min(kRows, L - i0), N, N16);
  cp_async_commit();
  {   // h_prev (P, N) f32 -> bf16 (P16, LDN), zero-padded
    const float* hp = g.states + ((size_t)bh * g.nc + c) * P * N;
    const int vecs = N16 / 8;
    for (int i = tid; i < P16 * vecs; i += kThreads) {
      const int p = i / vecs, n = (i % vecs) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p < P && n < N) {
        const float4 lo = *reinterpret_cast<const float4*>(hp + p * N + n);
        const float4 hi = *reinterpret_cast<const float4*>(hp + p * N + n + 4);
        v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                       pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
      }
      *reinterpret_cast<uint4*>(b_s + p * LDN + n) = v;
    }
  }
  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 rows of C as A fragments, kept for every product
  const int r0 = warp * 16;                   // row within the tile
  uint32_t ca[kMaxN / 16][4];
#pragma unroll
  for (int ks = 0; ks < kMaxN / 16; ++ks) {
    if (ks * 16 < N16)
      ldsm_x4(smem_addr(c_s + (r0 + (mi & 1) * 8 + (lane & 7)) * LDN +
                        ks * 16 + (mi >> 1) * 8),
              ca[ks]);
    else
      ca[ks][0] = ca[ks][1] = ca[ks][2] = ca[ks][3] = 0u;
  }

  // off-diagonal: y = exp(cum_i) C_i . h_prev^T
  float yacc[kMaxP / 8][4];
#pragma unroll
  for (int pt = 0; pt < kMaxP / 8; ++pt)
    yacc[pt][0] = yacc[pt][1] = yacc[pt][2] = yacc[pt][3] = 0.f;
#pragma unroll
  for (int pt = 0; pt < kMaxP / 8; pt += 2) {
    if (pt * 8 >= P16) break;
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (ks * 16 >= N16) break;
      uint32_t hb[4];
      ldsm_x4(smem_addr(b_s + (pt * 8 + (mi >> 1) * 8 + (lane & 7)) * LDN +
                        ks * 16 + (mi & 1) * 8),
              hb);
      mma_bf16(yacc[pt], ca[ks], hb[0], hb[1]);
      mma_bf16(yacc[pt + 1], ca[ks], hb[2], hb[3]);
    }
  }
  const int ia = i0 + r0 + gq, ib = ia + 8;   // this thread's two rows
  {
    const float ea = expf(cum_s[ia]), eb = expf(cum_s[ib]);
#pragma unroll
    for (int pt = 0; pt < kMaxP / 8; ++pt) {
      yacc[pt][0] *= ea;
      yacc[pt][1] *= ea;
      yacc[pt][2] *= eb;
      yacc[pt][3] *= eb;
    }
  }

  // diagonal: column tiles J <= I
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kRows;
    __syncthreads();          // b_s (h_prev first) and x_s consumed
    load_tile(b_s, LDN, bb + j0 * g.bs.s, g.bs.s, min(kRows, L - j0), N, N16);
    load_tile(x_s, LDP, xb + j0 * g.xs.s, g.xs.s, min(kRows, L - j0), P, P16);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // column blocks of 16 above this warp's rows are all masked (J == I)
    const int kk_end = J < I ? kRows / 16 : warp + 1;
    float gacc[kRows / 8][4];
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt)
      gacc[nt][0] = gacc[nt][1] = gacc[nt][2] = gacc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      if (kk >= kk_end) break;
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
        if (ks * 16 >= N16) break;
        uint32_t kb[4];
        ldsm_x4(smem_addr(b_s + (kk * 16 + (mi >> 1) * 8 + (lane & 7)) * LDN +
                          ks * 16 + (mi & 1) * 8),
                kb);
        mma_bf16(gacc[2 * kk], ca[ks], kb[0], kb[1]);
        mma_bf16(gacc[2 * kk + 1], ca[ks], kb[2], kb[3]);
      }
    }
    // G * exp(cum_i - cum_j) * dt_j for j <= i, in f32
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = j0 + nt * 8 + 2 * tq + (e & 1);   // chunk position
        const int il = e < 2 ? ia : ib;
        gacc[nt][e] = jl <= il ? gacc[nt][e] *
                                     expf(cum_s[il] - cum_s[jl]) * dt_s[jl]
                               : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      if (kk >= kk_end) break;
      const uint32_t pa[4] = {pack_bf16(gacc[2 * kk][0], gacc[2 * kk][1]),
                              pack_bf16(gacc[2 * kk][2], gacc[2 * kk][3]),
                              pack_bf16(gacc[2 * kk + 1][0],
                                        gacc[2 * kk + 1][1]),
                              pack_bf16(gacc[2 * kk + 1][2],
                                        gacc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kMaxP / 8; dn += 2) {
        if (dn * 8 >= P16) break;
        uint32_t vb[4];
        ldsm_x4_t(smem_addr(x_s + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                      LDP + (dn + (mi >> 1)) * 8),
                  vb);
        mma_bf16(yacc[dn], pa, vb[0], vb[1]);
        mma_bf16(yacc[dn + 1], pa, vb[2], vb[3]);
      }
    }
  }

  bf16* yb = static_cast<bf16*>(g.y) +
             ((size_t)b * g.S + c0) * g.H * P + (size_t)h * P;
  const size_t ys = (size_t)g.H * P;
#pragma unroll
  for (int pt = 0; pt < kMaxP / 8; ++pt) {
    const int p = pt * 8 + 2 * tq;
    if (p >= P) break;
    if (ia < L)
      *reinterpret_cast<uint32_t*>(yb + ia * ys + p) =
          pack_bf16(yacc[pt][0], yacc[pt][1]);
    if (ib < L)
      *reinterpret_cast<uint32_t*>(yb + ib * ys + p) =
          pack_bf16(yacc[pt][2], yacc[pt][3]);
  }
}

// ============================================================ f32 serial
// The first version's kernel, for f32 only: one block of 256
// threads per (b, h) walks the chunks with the (P, N) f32 state in shared
// memory and tiles a chunk's rows by 32; all products are f32 FMAs.
constexpr int kSThreads = 256;
constexpr int kSRows = 32;
constexpr int kYAcc = kSRows * kMaxP / kSThreads;     // (row, p) per thread
constexpr int kHAcc = kMaxP * kMaxN / kSThreads;      // (p, n) per thread
constexpr int kGAcc = kSRows * kSRows / kSThreads;    // (i, j) per thread
static_assert(kSThreads == kMaxChunk, "the scan maps a thread per position");

size_t serial_smem(int P, int N) {
  const int NP = N + 1, PP = P + 1;
  return sizeof(float) * ((size_t)P * NP + 2 * kSRows * NP + kSRows * PP +
                          kSRows * (kSRows + 1) + 2 * kMaxChunk);
}

// rows [r0, r0 + nr) of a strided (S, W) array -> dst (kSRows, W + 1),
// times scale_s[r] when scale_s is given; rows past nr are zeros
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int r0, int nr, int W,
                                          const float* scale_s) {
  for (int e = threadIdx.x; e < kSRows * W; e += kSThreads) {
    const int r = e / W, c = e % W;
    float v = 0.f;
    if (r < nr) {
      v = src[(r0 + r) * rs + c];
      if (scale_s != nullptr) v *= scale_s[r];
    }
    dst[r * (W + 1) + c] = v;
  }
}

__global__ void __launch_bounds__(kSThreads)
ssd_serial_kernel(Args g) {
  extern __shared__ float sm[];
  const int S = g.S, P = g.P, N = g.N, chunk = g.chunk;
  const int NP = N + 1, PP = P + 1, GP = kSRows + 1;
  float* h_s = sm;                          // (P, N + 1) state
  float* c_s = h_s + P * NP;                // (kSRows, N + 1) C row tile
  float* b_s = c_s + kSRows * NP;           // (kSRows, N + 1) B column tile
  float* x_s = b_s + kSRows * NP;           // (kSRows, P + 1) scaled x tile
  float* g_s = x_s + kSRows * PP;           // (kSRows, kSRows + 1) C B^T * L
  float* cum_s = g_s + kSRows * GP;         // (kMaxChunk) cumsum of dt * a
  float* w_s = cum_s + kMaxChunk;           // (kMaxChunk) row scales

  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x;
  const float A = g.a[h];
  const float* xb = static_cast<const float*>(g.x) + off(g.xs, b, 0, h);
  const float* dtb = g.dt + off(g.ds, b, 0, h);
  const float* bb = static_cast<const float*>(g.bm) + off(g.bs, b, 0, h);
  const float* cb = static_cast<const float*>(g.cm) + off(g.cs, b, 0, h);
  float* yb = static_cast<float*>(g.y) + ((size_t)b * S * g.H + h) * P;
  const size_t ys = (size_t)g.H * P;

  for (int e = tid; e < P * NP; e += kSThreads) h_s[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int L = min(chunk, S - c0);
    __syncthreads();  // the previous chunk's state is written
    // ---- dt and the inclusive cumsum of dt * a over the chunk
    const float d = tid < L ? dtb[(c0 + tid) * g.ds.s] : 0.f;
    cum_s[tid] = d * A;
    __syncthreads();
    for (int o = 1; o < L; o <<= 1) {
      const float v = (tid >= o && tid < L) ? cum_s[tid - o] : 0.f;
      __syncthreads();
      cum_s[tid] += v;
      __syncthreads();
    }
    const float cum_last = cum_s[L - 1];
    const int n_tiles = (L + kSRows - 1) / kSRows;

    // ---- y, one row tile at a time
    for (int I = 0; I < n_tiles; ++I) {
      const int i0 = I * kSRows;
      const int ni = min(kSRows, L - i0);
      __syncthreads();  // c_s, w_s free
      w_s[tid] = d;     // dt by chunk position, to scale x tiles
      load_rows(c_s, cb, g.cs.s, c0 + i0, ni, N, nullptr);
      __syncthreads();
      float yacc[kYAcc];
      // off-diagonal: exp(cum_i) * C_i . h[p]
#pragma unroll
      for (int k = 0; k < kYAcc; ++k) {
        const int e = tid + k * kSThreads;
        yacc[k] = 0.f;
        if (e < kSRows * P) {
          const int r = e / P, p = e % P;
          if (r < ni) {
            float s = 0.f;
            for (int n = 0; n < N; ++n) s += c_s[r * NP + n] * h_s[p * NP + n];
            yacc[k] = s * expf(cum_s[i0 + r]);
          }
        }
      }
      // diagonal: column tiles J <= I
      for (int J = 0; J <= I; ++J) {
        const int j0 = J * kSRows;
        const int nj = min(kSRows, L - j0);
        __syncthreads();  // b_s, x_s, g_s consumed
        load_rows(b_s, bb, g.bs.s, c0 + j0, nj, N, nullptr);
        load_rows(x_s, xb, g.xs.s, c0 + j0, nj, P, w_s + j0);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kGAcc; ++k) {
          const int e = tid + k * kSThreads;
          const int r = e / kSRows, j = e % kSRows;
          float gv = 0.f;
          if (r < ni && j < nj && j0 + j <= i0 + r) {
            for (int n = 0; n < N; ++n) gv += c_s[r * NP + n] * b_s[j * NP + n];
            gv *= expf(cum_s[i0 + r] - cum_s[j0 + j]);
          }
          g_s[r * GP + j] = gv;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kYAcc; ++k) {
          const int e = tid + k * kSThreads;
          if (e < kSRows * P) {
            const int r = e / P, p = e % P;
            float s = 0.f;
#pragma unroll 8
            for (int j = 0; j < kSRows; ++j) s += g_s[r * GP + j] * x_s[j * PP + p];
            yacc[k] += s;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kYAcc; ++k) {
        const int e = tid + k * kSThreads;
        if (e < kSRows * P) {
          const int r = e / P, p = e % P;
          if (r < ni) yb[(c0 + i0 + r) * ys + p] = yacc[k];
        }
      }
    }

    // ---- state: h = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
    __syncthreads();  // every row tile has read h_s; w_s free
    w_s[tid] = tid < L ? d * expf(cum_last - cum_s[tid]) : 0.f;
    float hacc[kHAcc];
    const float decay = expf(cum_last);
#pragma unroll
    for (int k = 0; k < kHAcc; ++k) {
      const int e = tid + k * kSThreads;
      hacc[k] = e < P * N ? h_s[(e / N) * NP + e % N] * decay : 0.f;
    }
    for (int J = 0; J < n_tiles; ++J) {
      const int j0 = J * kSRows;
      const int nj = min(kSRows, L - j0);
      __syncthreads();  // b_s, x_s consumed (and w_s written)
      load_rows(b_s, bb, g.bs.s, c0 + j0, nj, N, nullptr);
      load_rows(x_s, xb, g.xs.s, c0 + j0, nj, P, w_s + j0);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kHAcc; ++k) {
        const int e = tid + k * kSThreads;
        if (e < P * N) {
          const int p = e / N, n = e % N;
          float s = 0.f;
#pragma unroll 8
          for (int j = 0; j < kSRows; ++j) s += x_s[j * PP + p] * b_s[j * NP + n];
          hacc[k] += s;
        }
      }
    }
    __syncthreads();  // nobody reads h_s any more in this chunk
#pragma unroll
    for (int k = 0; k < kHAcc; ++k) {
      const int e = tid + k * kSThreads;
      if (e < P * N) h_s[(e / N) * NP + e % N] = hacc[k];
    }
  }
  __syncthreads();
  float* hb = g.hf + (size_t)bh * P * N;
  for (int e = tid; e < P * N; e += kSThreads) hb[e] = h_s[(e / N) * NP + e % N];
}

// ================================================================ host
size_t states_smem(int P, int N) {
  return 2 * kMaxChunk * sizeof(float) +
         (size_t)kRows * ((round16(P) + 8) + (round16(N) + 8)) *
             sizeof(bf16);
}

size_t output_smem(int P, int N) {
  return 2 * kMaxChunk * sizeof(float) +
         (size_t)kRows * (2 * (round16(N) + 8) + round16(P) + 8) *
             sizeof(bf16);
}

cudaError_t launch_phases(const Args& g, int B, int phases,
                          cudaStream_t st) {
  const int BH = B * g.H;
  if (phases & 1) {
    ssd_states_kernel<<<dim3(BH, g.nc), kThreads, states_smem(g.P, g.N),
                        st>>>(g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 2) {
    const int PN = g.P * g.N;
    ssd_pass_kernel<<<dim3((PN + 255) / 256, BH), 256, 0, st>>>(
        g.states, g.decay, g.hf, g.nc, PN);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 4) {
    const int tiles = (g.chunk + kRows - 1) / kRows;
    ssd_output_kernel<<<dim3(BH, g.nc, tiles), kThreads,
                        output_smem(g.P, g.N), st>>>(g);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

cudaError_t launch_serial(const Args& g, int B, cudaStream_t st) {
  const size_t smem = serial_smem(g.P, g.N);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_serial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_serial_kernel<<<B * g.H, kSThreads, smem, st>>>(g);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, y); dt, a, h_final and the
// scratch f32.  x, B and C are (B, S, H, P or N) and dt (B, S, H), each
// through its (B, S, H) element strides (the last axis unit-stride; a
// stride may be 0); a is (H,); y (B, S, H, P) and h_final (B, H, P, N) are
// contiguous.  P <= 64, N <= 128, chunk <= 256; in bf16 P and N are
// multiples of 8 and x, B, C and their strides 16-byte aligned.
// bf16 runs the phases named in the bit mask `phases` (1 chunk states, 2
// state pass, 3 chunk output; 7 = the scan) on the scratch `states` (B, H,
// n_chunks, P, N) and `decay` (B, H, n_chunks); f32 takes phases = 7 and
// no scratch.  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int repro_ssd_chunk_scan(
    int dtype, int phases, const void* x, const void* dt, const void* a,
    const void* b, const void* c, void* y, void* h_final, void* states,
    void* decay, int B, int S, int H, int P, int N, int chunk,
    long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long bsb, long long bss,
    long long bsh, long long csb, long long css, long long csh,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || chunk <= 0 || chunk > kMaxChunk || phases <= 0 ||
      phases > 7)
    return (int)cudaErrorInvalidValue;
  Args g;
  g.x = x;
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.bm = b;
  g.cm = c;
  g.y = y;
  g.hf = static_cast<float*>(h_final);
  g.states = static_cast<float*>(states);
  g.decay = static_cast<float*>(decay);
  g.H = H;
  g.S = S;
  g.P = P;
  g.N = N;
  g.chunk = chunk;
  g.nc = (S + chunk - 1) / chunk;
  g.xs = {xsb, xss, xsh};
  g.ds = {dsb, dss, dsh};
  g.bs = {bsb, bss, bsh};
  g.cs = {csb, css, csh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return phases == 7 ? (int)launch_serial(g, B, st)
                       : (int)cudaErrorInvalidValue;
  if (dtype != 1 || P % 8 || N % 8 || g.nc > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_phases(g, B, phases, st);
}
