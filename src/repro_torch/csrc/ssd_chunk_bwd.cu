// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a): chunk-parallel,
// bf16 products on the tensor cores, C B^T once per (batch, chunk, group).
//
// Differentiates the forward of csrc/ssd_chunk.cu (its note, lines 8-16),
// which replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk/kernel.py
// (ssd_scan_bh).  The reference has no Pallas backward: it differentiates
// src/repro/models/ssm.py::ssd_chunked with jax.grad, and the port's plain
// version is autograd through kernels/ssd_chunk/ref.py::ssd_scan_ref.
//
// What it computes, per (batch b, head h), for the output gradient dy
// (S, P) and, if given, dh_final (P, N).  Within a chunk of L positions,
// with cum_i the inclusive cumsum of dt * a, L_ij = exp(cum_i - cum_j) for
// j <= i (0 above), w_j = exp(cum_last - cum_j), h_prev the state entering
// the chunk and D the gradient of the state leaving it:
//   M = (C B^T) o L,   Z = (dY X^T) o L o dt_j  (dt_j scales column j)
//   dC = Z B + exp(cum_i) dY h_prev
//   dB = Z^T C + w_j dt_j X D
//   W  = M^T dY + w_j B D^T,   dx = dt_j W_j,   ddt_j = x_j . W_j + a r_j
//   dcum_i = dy_i . y_i - dt_i (x_i . W_i)   (+ <D, state leaving the
//            chunk> at i = L - 1, the state's own exp(cum_last))
//   r_j = sum_{i >= j in the chunk} dcum_i,   da = sum_j dt_j r_j
// where dy_i . y_i = sum_j (C B^T)_ij Z_ij + C_i . (dC's second term).  D
// comes from a reverse pass over the chunks: D_last = dh_final (or 0),
// D_{c-1} = exp(cum_last_c) D_c + E_c with E_c = sum_i exp(cum_i) dy_i C_i^T.
// dB and dC are written per head: where B and C are one group's view of
// stride 0 over the heads (mamba2, jamba), autograd's expand backward sums
// the heads, once.  Positions past S do not exist (a short last chunk is a
// chunk of L positions), so they get and give nothing.
//
// What bounds it: at mamba2-780m's train microbatch (4 x 1024, H 48, P 64,
// N 128, chunk 256) the function reads x, dy (bf16), dt and B, C once per
// group and writes dx, ddt and dB, dC once per group, about 81 MB (0.024 ms
// at 3.35 TB/s; writing dB and dC per head, as this version does, adds
// 97 MB).  Its products, on the lower triangle where masked (dY X^T, Z B,
// Z^T C, M^T dY per head, C B^T once per group) and whole (dY h_prev, X D,
// B D^T, and the chunk states S_c and E_c), are about 36 GFLOP (0.036 ms
// at 989 TFLOP/s bf16): operations bound it (chip_smoke.py reckons both
// from the run's shapes).
//
// The first version ran every product as an f32 FMA on the CUDA
// cores, each 4 x 4 or 4 x 8 register tile fed by 8-12 shared-memory loads
// per 16-32 FMAs (about 12 TFLOP/s), from bf16 inputs widened to f32 in
// shared memory (118 KB a block of rows, 168 KB of columns: one block per
// SM, nothing to hide a load behind), and computed C B^T once per head and
// twice (rows and columns), 16 of its 60 GFLOP: 4.98 ms at mamba2's
// microbatch, 1 % of the bound, 40 % of the train step (PERF.md).
//
// Design (bf16): six launches on f32 scratch the wrapper allocates, blocks
// of 4 warps, every product mma.sync m16n8k16 (bf16 in, f32 accumulate)
// from bf16 tiles of 64 positions that cp.async stages in shared memory and
// ldmatrix feeds (.trans where a product reads the transpose).  Raw bf16
// inputs (x, dy, B, C) go into the products as read; quantities made in f32
// are rounded to bf16 once, on their way into a product (E_c's weighted dy,
// h_prev, D, the masked and weighted Z and M tiles, the last two packed to
// A fragments in registers), as the forward rounds its weighted G and
// h_prev -- except where dcum's reverse cumsum cancels two computations of
// one sum: S_c's weighted x and the D of X D go in as two bf16 terms (the
// rounding and what it lost: two products, about 16 bits), and x . W is
// summed in f32 apart from W (launches 1 and 5 say why).  Masks, exp
// weights and every sum stay in f32.
//   1. chunk states, grid (B*H, nc, 2), the forward's phase 1 twice: z = 0
//      S_c = (w dt x)^T B and cum_last, z = 1 E_c = (exp(cum) dY)^T C.
//   2. the forward's state pass over S_c (h_prev in place, h_final) and the
//      reverse pass over E_c (D_c in place), f32, grid (P*N / 256, B*H).
//   3. C B^T once per (batch, chunk, group), grid (B*G, nc, tile pairs):
//      the 64 x 64 tiles J <= I of the lower triangle in f32, zero above
//      the diagonal and past S, into scratch (B, nc, G, T, T), T the chunk
//      rounded up to 64.  G = 1 when B and C both have head stride 0
//      (models/ssm.py's one-group view), else G = H, one per head.
//   4. rows, grid (B*H, nc, T / 64): a 64-row tile I, dY_I in registers as
//      A fragments; dC = exp(cum_i) dY_I h_prev, then for J <= I (B_J, X_J
//      double-buffered) S = dY_I X_J^T, Z = S o L o dt_j, dy . y += sum_j
//      (C B^T)_ij Z_ij with C B^T read from the scratch, dC += Z B_J.
//   5. columns, grid (B*H, nc, T / 64): a 64-column tile J, X_J in
//      registers; W = w_j B_J D^T, dB = w_j dt_j X_J D, then for I >= J
//      (C_I, dY_I double-buffered) S' = X_J dY_I^T, Z^T = S' o L^T o dt_j,
//      M^T = (C B^T)^T o L^T from the scratch, dB += Z^T C_I, W += M^T dY_I;
//      writes dx, dB, ddt's direct term and its share of dcum.
//   6. dcum to ddt and da, grid (H), f32: each block walks its head's (b,
//      chunk) pairs in order, a reverse scan of 256 positions each, and
//      reduces da in a fixed order (no atomics: two runs give the same
//      bits, as a resumed training run must).
// The diagonal tile skips the 16-column blocks its warp's rows mask out.
// dY X^T is computed twice, in the rows (as Z) and the columns (as Z^T):
// on the tensor cores the second is about 4 GFLOP at mamba2's microbatch,
// while handing Z from rows to columns would write and read about 100 MB
// of f32 (0.06 ms at 3.35 TB/s) and order the two launches' blocks.  Each
// output tile stays in one block, so every sum keeps a fixed order.
// Shared memory per block at P 64, N 128: states 37,888 B, C B^T 34,816 B,
// rows 99,328 B, columns 99,456 B: two blocks of rows or of columns per SM
// (chip_smoke.py logs what cudaOccupancyMaxActiveBlocksPerMultiprocessor
// reports, beside each launch's blocks).  At mamba2's microbatch the
// states, rows and columns launch 768, 3072 and 3072 blocks, C B^T 160.
// f32 (the reference grid's f32 cases only; no model path runs the scan in
// f32 on the card): the first version's kernels, f32 FMAs on the CUDA
// cores over tiles widened in shared memory, C B^T and dY X^T in both the
// rows and the columns; the chunk states are two launches, no C B^T launch.
//
// Next: sum dB and dC over a group's heads in the kernel (97 MB of writes
// and a read by autograd's expand backward, about 0.06 ms), the products
// on wgmma (warpgroups, TMA) instead of mma.sync, and C B^T once per
// (group, chunk) in the forward's chunk output too (PERF.md, ROADMAP).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kTile = 64;                 // positions per tile

struct Args {
  const void* x;
  const void* bm;
  const void* cm;
  const void* dy;
  const float* dt;
  const float* a;                         // (H,)
  const float* dhf;                       // (B, H, P, N) or null
  void* dx;                               // (B, S, H, P), contiguous
  void* db;                               // (B, S, H, N), contiguous
  void* dc;                               // (B, S, H, N), contiguous
  float* ddt;                             // (B, S, H), contiguous
  float* da;                              // (H,)
  float* hprev;                           // (B, H, nc, P, N): S_c, then h_prev
  float* hf;                              // (B, H, P, N)
  float* dstate;                          // (B, H, nc, P, N): E_c, then D_c
  float* decay;                           // (B, H, nc): cum_last
  float* dcum;                            // (B, H, S)
  float* cb;                              // (B, nc, G, T, T): C B^T (bf16)
  int B, H, S, P, N, chunk, nc, G, T;
  Strides xs, ds, bs, cs, ys;
};

// sum of v over the block, in a fixed order; every thread gets it
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// ==================================================================== bf16
constexpr int kTcThreads = 128;           // 4 warps, 16 rows of a tile each
constexpr int kStages = 2;                // streamed tile pairs in flight

// rows [r0, r0 + kTile) of a (rows, W) strided bf16 array whose row 0 is
// `src` (which exists) into dst (kTile, ld) by cp.async, W16 = round16(W)
// columns; rows past nr and columns past W zero-filled, nothing read behind
// them
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long rs, int r0, int nr,
                                          int W, int W16) {
  const int vecs = W16 / 8;
  for (int i = threadIdx.x; i < kTile * vecs; i += kTcThreads) {
    const int r = i / vecs, k = (i % vecs) * 8;
    const bool ok = r < nr && k < W;
    cp_async16(smem_addr(dst + r * ld + k), ok ? src + (r0 + r) * rs + k : src,
               ok ? 16 : 0);
  }
}

// what bf16 loses of (lo, hi): the two-term split's second term
__device__ __forceinline__ uint32_t pack_rest(float lo, float hi,
                                              uint32_t packed) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&packed));
  return pack_bf16(lo - f.x, hi - f.y);
}

// a contiguous (P, N) f32 matrix into dst (round16(P), ld) in bf16,
// zero-padded; and, where `rest` is given, what the rounding lost into it
// (dst + rest is the matrix to about 16 bits)
__device__ __forceinline__ void state_to_bf16(bf16* dst, bf16* rest, int ld,
                                              const float* src, int P,
                                              int N) {
  const int vecs = round16(N) / 8;
  for (int i = threadIdx.x; i < round16(P) * vecs; i += kTcThreads) {
    const int p = i / vecs, n = (i % vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u), r = v;
    if (p < P && n < N) {
      const float4 lo = *reinterpret_cast<const float4*>(src + p * N + n);
      const float4 hi = *reinterpret_cast<const float4*>(src + p * N + n + 4);
      v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                     pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
      r = make_uint4(pack_rest(lo.x, lo.y, v.x), pack_rest(lo.z, lo.w, v.y),
                     pack_rest(hi.x, hi.y, v.z), pack_rest(hi.z, hi.w, v.w));
    }
    *reinterpret_cast<uint4*>(dst + p * ld + n) = v;
    if (rest != nullptr) *reinterpret_cast<uint4*>(rest + p * ld + n) = r;
  }
}

// this warp's 16 rows [r0, r0 + 16) of a row-major bf16 tile as A
// fragments, k in 16-column steps below K16 (zero beyond)
template <int kSteps>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const bf16* t, int ld,
                                       int r0, int K16, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    if (ks * 16 < K16)
      ldsm_x4(smem_addr(t + (r0 + (mi & 1) * 8 + (lane & 7)) * ld + ks * 16 +
                        (mi >> 1) * 8),
              a[ks]);
    else
      a[ks][0] = a[ks][1] = a[ks][2] = a[ks][3] = 0u;
  }
}

// acc[nt] (16 x 8 each, nt in [nt0, nt1)) += a times the k rows [k0, k0 +
// 16) of a [k][n] tile (n contiguous): ldmatrix.trans
template <int kNt>
__device__ __forceinline__ void mma_kn(float (*acc)[4], const uint32_t* a,
                                       const bf16* t, int ld, int k0, int nt0,
                                       int nt1, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int nt = 0; nt < kNt; nt += 2) {
    if (nt >= nt1) break;
    if (nt < nt0) continue;
    uint32_t v[4];
    ldsm_x4_t(smem_addr(t + (k0 + (mi & 1) * 8 + (lane & 7)) * ld +
                        (nt + (mi >> 1)) * 8),
              v);
    mma_bf16(acc[nt], a, v[0], v[1]);
    mma_bf16(acc[nt + 1], a, v[2], v[3]);
  }
}

// acc[nt] (nt in [nt0, nt1)) += a times the k columns [k0, k0 + 16) of an
// [n][k] tile (k contiguous), i.e. its transpose: plain ldmatrix
template <int kNt>
__device__ __forceinline__ void mma_nk(float (*acc)[4], const uint32_t* a,
                                       const bf16* t, int ld, int k0, int nt0,
                                       int nt1, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int nt = 0; nt < kNt; nt += 2) {
    if (nt >= nt1) break;
    if (nt < nt0) continue;
    uint32_t v[4];
    ldsm_x4(smem_addr(t + (nt * 8 + (mi >> 1) * 8 + (lane & 7)) * ld + k0 +
                      (mi & 1) * 8),
            v);
    mma_bf16(acc[nt], a, v[0], v[1]);
    mma_bf16(acc[nt + 1], a, v[2], v[3]);
  }
}

// accumulator tiles 2 kk and 2 kk + 1 (16 x 16, f32) as one bf16 A fragment
__device__ __forceinline__ void pack_a(uint32_t* pa, float (*acc)[4],
                                       int kk) {
  pa[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  pa[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  pa[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  pa[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the sum over the four lanes of a quad (one accumulator row), fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- launch 1: chunk states.  z = 0: S_c = sum_j dt_j exp(cum_last -
// cum_j) x_j B_j^T and cum_last; z = 1: E_c = sum_i exp(cum_i) dy_i C_i^T.
// The (P x L) (L x N) product of csrc/ssd_chunk.cu's phase 1: warp w owns
// state rows 16 w.., the weighted rows go through registers to bf16.  S_c
// takes its weighted x as two bf16 terms (the rounding and what it lost),
// two products: dcum cancels <D, S_c> (at the chunk's last position)
// against the columns' sum_j dt_j w_j x_j . (D B_j) from the raw x, which a
// once-rounded S_c leaves off by 2^-9 of it -- da's rows outside
// SSD_ROW_TOL at mamba2's microbatch.  E_c's rounding cancels nowhere.
__global__ void __launch_bounds__(kTcThreads) states_tc_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool fwd = blockIdx.z == 0;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int P = g.P, N = g.N, P16 = round16(P), N16 = round16(N);
  const int LDP = P16 + 8, LDN = N16 + 8;     // odd multiples of 16 bytes
  float* w_s = reinterpret_cast<float*>(smem_raw);  // dt, then the weights
  float* cum_s = w_s + kMaxChunk;
  bf16* u_s = reinterpret_cast<bf16*>(cum_s + kMaxChunk);  // (kTile, LDP)
  bf16* v_s = u_s + kTile * LDP;                           // (kTile, LDN)
  bf16* ul_s = v_s + kTile * LDN;         // (kTile, LDP): z = 0, u's rest

  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, w_s, cum_s);
  const float cum_last = cum_s[L - 1];
  for (int i = tid; i < kMaxChunk; i += kTcThreads)
    w_s[i] = i >= L ? 0.f
                    : fwd ? w_s[i] * expf(cum_last - cum_s[i])
                          : expf(cum_s[i]);
  __syncthreads();
  const bf16* u = static_cast<const bf16*>(fwd ? g.x : g.dy) +
                  (fwd ? off(g.xs, b, c0, h) : off(g.ys, b, c0, h));
  const long long us = fwd ? g.xs.s : g.ys.s;
  const bf16* v = static_cast<const bf16*>(fwd ? g.bm : g.cm) +
                  (fwd ? off(g.bs, b, c0, h) : off(g.cs, b, c0, h));
  const long long vs = fwd ? g.bs.s : g.cs.s;

  float acc[kMaxN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const bool active = warp * 16 < P16;
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nr = min(kTile, L - t0);
    load_tile(v_s, LDN, v, vs, t0, nr, N, N16);
    cp_async_commit();
    const int vecs = P16 / 8;
    for (int i = tid; i < kTile * vecs; i += kTcThreads) {
      const int r = i / vecs, k = (i % vecs) * 8;
      uint4 q = make_uint4(0u, 0u, 0u, 0u), ql = q;
      if (r < nr && k < P) {
        q = *reinterpret_cast<const uint4*>(u + (t0 + r) * us + k);
        const float w = w_s[t0 + r];
        uint32_t* e = reinterpret_cast<uint32_t*>(&q);
        uint32_t* el = reinterpret_cast<uint32_t*>(&ql);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<__nv_bfloat162*>(&e[j]));
          e[j] = pack_bf16(f.x * w, f.y * w);
          el[j] = pack_rest(f.x * w, f.y * w, e[j]);
        }
      }
      *reinterpret_cast<uint4*>(u_s + r * LDP + k) = q;
      if (fwd) *reinterpret_cast<uint4*>(ul_s + r * LDP + k) = ql;
    }
    cp_async_wait_all();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        if (ks * 16 >= nr) break;
        uint32_t af[4];     // A = (u w)^T: rows p, k = positions (u_s^T)
        const int at = (ks * 16 + (mi >> 1) * 8 + (lane & 7)) * LDP +
                       warp * 16 + (mi & 1) * 8;
        ldsm_x4_t(smem_addr(u_s + at), af);
        mma_kn<kMaxN / 8>(acc, af, v_s, LDN, ks * 16, 0, N16 / 8, lane);
        if (fwd) {
          ldsm_x4_t(smem_addr(ul_s + at), af);
          mma_kn<kMaxN / 8>(acc, af, v_s, LDN, ks * 16, 0, N16 / 8, lane);
        }
      }
    }
    __syncthreads();   // u_s, v_s consumed before the next tile
  }

  float* st = (fwd ? g.hprev : g.dstate) + ((size_t)bh * g.nc + c) * P * N;
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
  if (fwd && tid == 0) g.decay[(size_t)bh * g.nc + c] = cum_last;
}

// ---- launch 3: C B^T of one tile pair (I, J), J <= I, of one (b, chunk,
// group), in f32: warp w owns rows 16 w.. of the 64 x 64 tile, C_I as A
// fragments, B_J^T by plain ldmatrix; zero above the diagonal and past S.
__global__ void __launch_bounds__(kTcThreads) cb_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / g.G, grp = blockIdx.x % g.G, c = blockIdx.y;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= (int)blockIdx.z) ++I;
  const int J = blockIdx.z - I * (I + 1) / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int i0 = I * kTile, j0 = J * kTile;
  const int N = g.N, N16 = round16(N), LDN = N16 + 8;
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);       // (kTile, LDN) C_I
  bf16* b_s = c_s + kTile * LDN;                       // (kTile, LDN) B_J

  load_tile(c_s, LDN, static_cast<const bf16*>(g.cm) + off(g.cs, b, c0, grp),
            g.cs.s, i0, L - i0, N, N16);
  load_tile(b_s, LDN, static_cast<const bf16*>(g.bm) + off(g.bs, b, c0, grp),
            g.bs.s, j0, L - j0, N, N16);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t ca[kMaxN / 16][4];
  load_a<kMaxN / 16>(ca, c_s, LDN, r0, N16, lane);
  const int nt_end = J < I ? kTile / 8 : 2 * (warp + 1);
  float acc[kTile / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kMaxN / 16; ++ks) {
    if (ks * 16 >= N16) break;
    mma_nk<kTile / 8>(acc, ca[ks], b_s, LDN, ks * 16, 0, nt_end, lane);
  }
  float* out = g.cb + (((size_t)b * g.nc + c) * g.G + grp) * g.T * g.T;
  const int ia = i0 + r0 + gq, ib = ia + 8;   // chunk positions
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int jl = j0 + nt * 8 + 2 * tq;
    *reinterpret_cast<float2*>(out + (size_t)ia * g.T + jl) =
        make_float2(jl <= ia ? acc[nt][0] : 0.f,
                    jl + 1 <= ia ? acc[nt][1] : 0.f);
    *reinterpret_cast<float2*>(out + (size_t)ib * g.T + jl) =
        make_float2(jl <= ib ? acc[nt][2] : 0.f,
                    jl + 1 <= ib ? acc[nt][3] : 0.f);
  }
}

// the C B^T tile of (b, chunk) for head h in the scratch
__device__ __forceinline__ const float* cb_of(const Args& g, int b, int c,
                                              int h) {
  return g.cb + (((size_t)b * g.nc + c) * g.G + (g.G == 1 ? 0 : h)) * g.T *
                    g.T;
}

size_t rows_smem(int P, int N) {
  const int LDP = round16(P) + 8, LDN = round16(N) + 8;
  return 2 * kMaxChunk * sizeof(float) +
         (size_t)(kTile * LDN + kTile * LDP + round16(P) * LDN +
                  kStages * kTile * (LDN + LDP)) *
             sizeof(bf16);
}

// ---- launch 4: rows.  Tile I of chunk c: dC_I and dcum's dy . y part.
// Warp w owns rows 16 w.. of the tile; thread (gq, tq) of a warp rows gq
// and gq + 8 of them, as the mma accumulators lay them out.  Tile I walks
// I + 1 column tiles, so the grid hands out the last tiles first.
__global__ void __launch_bounds__(kTcThreads) rows_tc_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, c = blockIdx.y;
  const int I = (int)gridDim.z - 1 - (int)blockIdx.z;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int i0 = I * kTile;
  if (i0 >= L) return;                    // rows past S do not exist
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int P = g.P, N = g.N, P16 = round16(P), N16 = round16(N);
  const int LDP = P16 + 8, LDN = N16 + 8;
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cum_s = dt_s + kMaxChunk;
  bf16* c_s = reinterpret_cast<bf16*>(cum_s + kMaxChunk);  // (kTile, LDN) C_I
  bf16* y_s = c_s + kTile * LDN;          // (kTile, LDP) dY_I
  bf16* h_s = y_s + kTile * LDP;          // (P16, LDN) h_prev
  bf16* st_s = h_s + P16 * LDN;           // kStages x [B_J, X_J]
  const int stage = kTile * (LDN + LDP);

  const bf16* xb = static_cast<const bf16*>(g.x) + off(g.xs, b, c0, h);
  const bf16* bb = static_cast<const bf16*>(g.bm) + off(g.bs, b, c0, h);
  const bf16* cb = static_cast<const bf16*>(g.cm) + off(g.cs, b, c0, h);
  const bf16* yb = static_cast<const bf16*>(g.dy) + off(g.ys, b, c0, h);
  load_tile(c_s, LDN, cb, g.cs.s, i0, L - i0, N, N16);
  load_tile(y_s, LDP, yb, g.ys.s, i0, L - i0, P, P16);
  cp_async_commit();
  load_tile(st_s, LDN, bb, g.bs.s, 0, L, N, N16);
  load_tile(st_s + kTile * LDN, LDP, xb, g.xs.s, 0, L, P, P16);
  cp_async_commit();
  state_to_bf16(h_s, nullptr, LDN,
                g.hprev + ((size_t)bh * g.nc + c) * P * N, P, N);
  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  cp_async_wait<1>();                     // C_I and dY_I
  __syncthreads();

  const int r0 = warp * 16;
  const int ia = i0 + r0 + gq, ib = ia + 8;   // this thread's chunk rows
  uint32_t ya[kMaxP / 16][4];
  load_a<kMaxP / 16>(ya, y_s, LDP, r0, P16, lane);

  // off-diagonal: dC = exp(cum_i) dY h_prev, and its share of dy . y,
  // C_i . that
  float acc[kMaxN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kMaxP / 16; ++ks) {
    if (ks * 16 >= P16) break;
    mma_kn<kMaxN / 8>(acc, ya[ks], h_s, LDN, ks * 16, 0, N16 / 8, lane);
  }
  float dya = 0.f, dyb = 0.f;
  {
    const float ea = expf(cum_s[ia]), eb = expf(cum_s[ib]);
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = nt * 8 + 2 * tq;
      if (n >= N16) break;
      acc[nt][0] *= ea;
      acc[nt][1] *= ea;
      acc[nt][2] *= eb;
      acc[nt][3] *= eb;
      const float2 ca = ld_bf16x2(c_s + (r0 + gq) * LDN + n);
      const float2 cc = ld_bf16x2(c_s + (r0 + gq + 8) * LDN + n);
      dya += ca.x * acc[nt][0] + ca.y * acc[nt][1];
      dyb += cc.x * acc[nt][2] + cc.y * acc[nt][3];
    }
  }

  // diagonal: column tiles J <= I
  const float* gcb = cb_of(g, b, c, h);
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kTile;
    const bf16* bs = st_s + (J & 1) * stage;
    const bf16* xs = bs + kTile * LDN;
    if (J < I) {                          // the next pair streams meanwhile
      bf16* nb = st_s + ((J + 1) & 1) * stage;
      load_tile(nb, LDN, bb, g.bs.s, j0 + kTile, L - j0 - kTile, N, N16);
      load_tile(nb + kTile * LDN, LDP, xb, g.xs.s, j0 + kTile,
                L - j0 - kTile, P, P16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // 8-column tiles up to the diagonal: those above this warp's rows are
    // all masked (J == I)
    const int nt_end = J < I ? kTile / 8 : 2 * (warp + 1);
    float gv[kTile / 8][4];               // C B^T at this thread's entries
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int jl = j0 + nt * 8 + 2 * tq;
      float2 va = make_float2(0.f, 0.f), vb = va;
      if (nt < nt_end) {
        if (ia < L) va = *reinterpret_cast<const float2*>(
                        gcb + (size_t)ia * g.T + jl);
        if (ib < L) vb = *reinterpret_cast<const float2*>(
                        gcb + (size_t)ib * g.T + jl);
      }
      gv[nt][0] = va.x;
      gv[nt][1] = va.y;
      gv[nt][2] = vb.x;
      gv[nt][3] = vb.y;
    }
    float sacc[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMaxP / 16; ++ks) {
      if (ks * 16 >= P16) break;
      mma_nk<kTile / 8>(sacc, ya[ks], xs, LDP, ks * 16, 0, nt_end, lane);
    }
    // Z = S o L o dt_j for j <= i, in f32, and dy . y's diagonal part
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = j0 + nt * 8 + 2 * tq + (e & 1);
        const int il = e < 2 ? ia : ib;
        const float z = jl <= il ? sacc[nt][e] *
                                       expf(cum_s[il] - cum_s[jl]) * dt_s[jl]
                                 : 0.f;
        if (e < 2)
          dya += gv[nt][e] * z;
        else
          dyb += gv[nt][e] * z;
        sacc[nt][e] = z;
      }
    }
    // dC += Z B_J, Z rounded to bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (2 * kk >= nt_end) break;
      uint32_t pa[4];
      pack_a(pa, sacc, kk);
      mma_kn<kMaxN / 8>(acc, pa, bs, LDN, kk * 16, 0, N16 / 8, lane);
    }
    __syncthreads();                      // this stage consumed
  }

  dya = quad_sum(dya);
  dyb = quad_sum(dyb);
  bf16* dcb = static_cast<bf16*>(g.dc) + ((size_t)b * g.S + c0) * g.H * N +
              (size_t)h * N;
  const size_t rs = (size_t)g.H * N;
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt) {
    const int n = nt * 8 + 2 * tq;
    if (n >= N) break;
    if (ia < L)
      *reinterpret_cast<uint32_t*>(dcb + ia * rs + n) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (ib < L)
      *reinterpret_cast<uint32_t*>(dcb + ib * rs + n) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
  if (tq == 0) {
    float* dc = g.dcum + (size_t)bh * g.S + c0;
    if (ia < L) dc[ia] = dya;
    if (ib < L) dc[ib] = dyb;
  }
}

size_t cols_smem(int P, int N) {
  return rows_smem(P, N) + 32 * sizeof(float);
}

// ---- launch 5: columns.  Tile J of chunk c: dB_J, W_J (dx, x . W) over
// row tiles I >= J after the state terms.  Warp w owns rows j = 16 w.. of
// the tile (the A side of every product), thread (gq, tq) rows gq, gq + 8.
// x_j . W_j, which dcum's reverse cumsum cancels against the rows' dy . y
// and <D, S_c>, is summed in f32 apart from W: sum_i M_ij (x_j . dy_i) from
// the f32 M and S' entries in registers, and w_j B_j . (x_j D) from X_J D
// with D as two bf16 terms (two products).  Through W's bf16 M and D it
// left ddt's rows outside SSD_ROW_TOL (RMS 1.3e-2, worst 0.12).
__global__ void __launch_bounds__(kTcThreads) cols_tc_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, c = blockIdx.y, J = blockIdx.z;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int j0 = J * kTile;
  if (j0 >= L) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int P = g.P, N = g.N, P16 = round16(P), N16 = round16(N);
  const int LDP = P16 + 8, LDN = N16 + 8;
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cum_s = dt_s + kMaxChunk;
  bf16* b_s = reinterpret_cast<bf16*>(cum_s + kMaxChunk);  // (kTile, LDN) B_J
  bf16* x_s = b_s + kTile * LDN;          // (kTile, LDP) X_J
  bf16* d_s = x_s + kTile * LDP;          // (P16, LDN) D_c
  bf16* st_s = d_s + P16 * LDN;           // kStages x [C_I, dY_I]
  float* red = reinterpret_cast<float*>(st_s + kStages * kTile * (LDN + LDP));
  const int stage = kTile * (LDN + LDP);
  bf16* dl_s = st_s + stage;              // (P16, LDN) D's rest, in stage 1

  const bf16* xb = static_cast<const bf16*>(g.x) + off(g.xs, b, c0, h);
  const bf16* bb = static_cast<const bf16*>(g.bm) + off(g.bs, b, c0, h);
  const bf16* cb = static_cast<const bf16*>(g.cm) + off(g.cs, b, c0, h);
  const bf16* yb = static_cast<const bf16*>(g.dy) + off(g.ys, b, c0, h);
  load_tile(b_s, LDN, bb, g.bs.s, j0, L - j0, N, N16);
  load_tile(x_s, LDP, xb, g.xs.s, j0, L - j0, P, P16);
  cp_async_commit();
  load_tile(st_s, LDN, cb, g.cs.s, j0, L - j0, N, N16);
  load_tile(st_s + kTile * LDN, LDP, yb, g.ys.s, j0, L - j0, P, P16);
  cp_async_commit();
  const float* dsrc = g.dstate + ((size_t)bh * g.nc + c) * P * N;
  state_to_bf16(d_s, dl_s, LDN, dsrc, P, N);
  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  const float cum_last = cum_s[L - 1];

  // <D, state leaving the chunk>, for dcum at L - 1 (in this tile only)
  float leave = 0.f;
  if (j0 + kTile >= L) {
    const float* ho = c + 1 < g.nc
                          ? g.hprev + ((size_t)bh * g.nc + c + 1) * P * N
                          : g.hf + (size_t)bh * P * N;
    float v = 0.f;
    for (int e = tid; e < P * N; e += kTcThreads) v += dsrc[e] * ho[e];
    leave = block_sum(v, red);
  }
  cp_async_wait<1>();                     // B_J and X_J
  __syncthreads();

  const int r0 = warp * 16;
  const int ja = j0 + r0 + gq, jb = ja + 8;   // this thread's chunk rows
  uint32_t xa[kMaxP / 16][4];
  load_a<kMaxP / 16>(xa, x_s, LDP, r0, P16, lane);

  // state terms: W = w_j B D^T, dB = w_j dt_j X D
  float accw[kMaxP / 8][4], accb[kMaxN / 8][4];
#pragma unroll
  for (int pt = 0; pt < kMaxP / 8; ++pt)
    accw[pt][0] = accw[pt][1] = accw[pt][2] = accw[pt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt)
    accb[nt][0] = accb[nt][1] = accb[nt][2] = accb[nt][3] = 0.f;
  {
    uint32_t ba[kMaxN / 16][4];
    load_a<kMaxN / 16>(ba, b_s, LDN, r0, N16, lane);
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (ks * 16 >= N16) break;
      mma_nk<kMaxP / 8>(accw, ba[ks], d_s, LDN, ks * 16, 0, P16 / 8, lane);
    }
  }
#pragma unroll
  for (int ks = 0; ks < kMaxP / 16; ++ks) {
    if (ks * 16 >= P16) break;
    mma_kn<kMaxN / 8>(accb, xa[ks], d_s, LDN, ks * 16, 0, N16 / 8, lane);
    mma_kn<kMaxN / 8>(accb, xa[ks], dl_s, LDN, ks * 16, 0, N16 / 8, lane);
  }
  float xwa = 0.f, xwb = 0.f;             // x . W, this thread's part
  {
    const float wa = ja < L ? expf(cum_last - cum_s[ja]) : 0.f;
    const float wb = jb < L ? expf(cum_last - cum_s[jb]) : 0.f;
    const float va = wa * dt_s[ja], vb = wb * dt_s[jb];
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {   // w_j B_j . (x_j D)
      const int n = nt * 8 + 2 * tq;
      if (n >= N16) break;
      const float2 ba2 = ld_bf16x2(b_s + (r0 + gq) * LDN + n);
      const float2 bb2 = ld_bf16x2(b_s + (r0 + gq + 8) * LDN + n);
      xwa += ba2.x * accb[nt][0] + ba2.y * accb[nt][1];
      xwb += bb2.x * accb[nt][2] + bb2.y * accb[nt][3];
    }
    xwa *= wa;
    xwb *= wb;
#pragma unroll
    for (int pt = 0; pt < kMaxP / 8; ++pt) {
      accw[pt][0] *= wa;
      accw[pt][1] *= wa;
      accw[pt][2] *= wb;
      accw[pt][3] *= wb;
    }
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      accb[nt][0] *= va;
      accb[nt][1] *= va;
      accb[nt][2] *= vb;
      accb[nt][3] *= vb;
    }
  }
  __syncthreads();                        // D's rest read: stage 1 is free

  // row tiles I >= J
  const float* gcb = cb_of(g, b, c, h);
  int t = 0;
  for (int i0 = j0; i0 < L; i0 += kTile, ++t) {
    const bf16* cs = st_s + (t & 1) * stage;
    const bf16* ys = cs + kTile * LDN;
    if (i0 + kTile < L) {                 // the next pair streams meanwhile
      bf16* nb = st_s + ((t + 1) & 1) * stage;
      load_tile(nb, LDN, cb, g.cs.s, i0 + kTile, L - i0 - kTile, N, N16);
      load_tile(nb + kTile * LDN, LDP, yb, g.ys.s, i0 + kTile,
                L - i0 - kTile, P, P16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // 8-column (i) tiles below this warp's rows j are all masked (I == J)
    const int nt0 = i0 == j0 ? 2 * warp : 0;
    float gv[kTile / 8][4];               // (C B^T)^T at this thread's (j, i)
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = i0 + nt * 8 + 2 * tq + (e & 1);
        const int jl = e < 2 ? ja : jb;
        gv[nt][e] = nt >= nt0 && jl <= il && il < L
                        ? gcb[(size_t)il * g.T + jl]
                        : 0.f;
      }
    }
    float sacc[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMaxP / 16; ++ks) {
      if (ks * 16 >= P16) break;
      mma_nk<kTile / 8>(sacc, xa[ks], ys, LDP, ks * 16, nt0, kTile / 8, lane);
    }
    // Z^T = S' o L^T o dt_j and M^T = (C B^T)^T o L^T, in f32, and x . W's
    // sum_i M_ij S'_ji
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = i0 + nt * 8 + 2 * tq + (e & 1);
        const int jl = e < 2 ? ja : jb;
        const float l = jl <= il ? expf(cum_s[il] - cum_s[jl]) : 0.f;
        const float m = gv[nt][e] * l;
        if (e < 2)
          xwa += m * sacc[nt][e];
        else
          xwb += m * sacc[nt][e];
        sacc[nt][e] *= l * dt_s[jl];
        gv[nt][e] = m;
      }
    }
    // dB += Z^T C_I, W += M^T dY_I, both rounded to bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (2 * kk < nt0) continue;
      uint32_t pz[4], pm[4];
      pack_a(pz, sacc, kk);
      pack_a(pm, gv, kk);
      mma_kn<kMaxN / 8>(accb, pz, cs, LDN, kk * 16, 0, N16 / 8, lane);
      mma_kn<kMaxP / 8>(accw, pm, ys, LDP, kk * 16, 0, P16 / 8, lane);
    }
    __syncthreads();                      // this stage consumed
  }

  // dx = dt_j W_j, ddt's direct term x_j . W_j, dcum -= dt_j x_j . W_j
  xwa = quad_sum(xwa);
  xwb = quad_sum(xwb);
  const float dta = dt_s[ja], dtb = dt_s[jb];
  const size_t xrs = (size_t)g.H * P, nrs = (size_t)g.H * N;
  bf16* dxb = static_cast<bf16*>(g.dx) + ((size_t)b * g.S + c0) * xrs +
              (size_t)h * P;
  bf16* dbb = static_cast<bf16*>(g.db) + ((size_t)b * g.S + c0) * nrs +
              (size_t)h * N;
#pragma unroll
  for (int pt = 0; pt < kMaxP / 8; ++pt) {
    const int p = pt * 8 + 2 * tq;
    if (p >= P) break;
    if (ja < L)
      *reinterpret_cast<uint32_t*>(dxb + ja * xrs + p) =
          pack_bf16(dta * accw[pt][0], dta * accw[pt][1]);
    if (jb < L)
      *reinterpret_cast<uint32_t*>(dxb + jb * xrs + p) =
          pack_bf16(dtb * accw[pt][2], dtb * accw[pt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt) {
    const int n = nt * 8 + 2 * tq;
    if (n >= N) break;
    if (ja < L)
      *reinterpret_cast<uint32_t*>(dbb + ja * nrs + n) =
          pack_bf16(accb[nt][0], accb[nt][1]);
    if (jb < L)
      *reinterpret_cast<uint32_t*>(dbb + jb * nrs + n) =
          pack_bf16(accb[nt][2], accb[nt][3]);
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int jl = r == 0 ? ja : jb;
      if (jl >= L) continue;
      const float xw = r == 0 ? xwa : xwb, d = r == 0 ? dta : dtb;
      g.ddt[((size_t)b * g.S + c0 + jl) * g.H + h] = xw;
      float* dc = g.dcum + (size_t)bh * g.S + c0 + jl;
      *dc = *dc - d * xw + (jl == L - 1 ? leave : 0.f);
    }
  }
}

// ============================================================ f32 (first
// version): f32 FMAs on the CUDA cores, tiles widened in shared memory
constexpr int kThreads = 256;
constexpr int kZ = kTile + 1;             // row length of a 64 x 64 tile

// rows [r0, r0 + nr) of a strided (rows, W) array into dst (kTile, W + 1),
// each row times scale[r] when scale is given; rows past nr zero
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int r0, int nr, int W,
                                          const float* scale) {
  for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
    const int r = e / W, k = e % W;
    float v = 0.f;
    if (r < nr) {
      v = src[(r0 + r) * rs + k];
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * (W + 1) + k] = v;
  }
}

// a contiguous (P, N) f32 matrix into dst (P, N + 1)
__device__ __forceinline__ void load_state(float* dst, const float* src,
                                           int P, int N) {
  for (int e = threadIdx.x; e < P * N; e += kThreads)
    dst[(e / N) * (N + 1) + e % N] = src[e];
}

// sum of v over the 16 lanes that share a row group (lanes 0-15, 16-31)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- launch 1: chunk states.  kFwd: S_c = sum_j dt_j exp(cum_last -
// cum_j) x_j B_j^T and cum_last; else E_c = sum_i exp(cum_i) dy_i C_i^T.
// Thread (ti, tj) = (tid / 16, tid % 16) owns rows p = ti + 16 r and
// columns n = tj + 16 s of the (P, N) sum.
template <bool kFwd>
__global__ void __launch_bounds__(kThreads) states_kernel(Args g) {
  extern __shared__ float sm[];
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int P = g.P, N = g.N;
  float* dt_s = sm;
  float* cum_s = dt_s + kMaxChunk;
  float* w_s = cum_s + kMaxChunk;
  float* u_s = w_s + kMaxChunk;           // (kTile, P + 1)
  float* v_s = u_s + kTile * (P + 1);     // (kTile, N + 1)

  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  const float cum_last = cum_s[L - 1];
  for (int i = tid; i < kMaxChunk; i += kThreads)
    w_s[i] = i >= L ? 0.f
                    : kFwd ? dt_s[i] * expf(cum_last - cum_s[i])
                           : expf(cum_s[i]);
  __syncthreads();
  const float* u = static_cast<const float*>(kFwd ? g.x : g.dy) +
                   (kFwd ? off(g.xs, b, c0, h) : off(g.ys, b, c0, h));
  const long long us = kFwd ? g.xs.s : g.ys.s;
  const float* v = static_cast<const float*>(kFwd ? g.bm : g.cm) +
                   (kFwd ? off(g.bs, b, c0, h) : off(g.cs, b, c0, h));
  const long long vs = kFwd ? g.bs.s : g.cs.s;

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nr = min(kTile, L - t0);
    load_rows(u_s, u, us, t0, nr, P, w_s + t0);
    load_rows(v_s, v, vs, t0, nr, N, nullptr);
    __syncthreads();
    for (int j = 0; j < nr; ++j) {
      float uu[4], vv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = ti + 16 * r;
        uu[r] = p < P ? u_s[j * (P + 1) + p] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int n = tj + 16 * s;
        vv[s] = n < N ? v_s[j * (N + 1) + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] += uu[r] * vv[s];
    }
    __syncthreads();
  }
  float* out = (kFwd ? g.hprev : g.dstate) + ((size_t)bh * g.nc + c) * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ti + 16 * r;
    if (p >= P) break;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = tj + 16 * s;
      if (n < N) out[p * N + n] = acc[r][s];
    }
  }
  if (kFwd && tid == 0) g.decay[(size_t)bh * g.nc + c] = cum_last;
}

// ---- launch 2 (both dtypes): the forward's state pass (h_c =
// exp(cum_last_c) h_{c-1} + S_c from 0; S_c overwritten by the state
// entering c; h_final) and the reverse pass (D_{c-1} = exp(cum_last_c) D_c
// + E_c from dh_final or 0; E_c overwritten by D_c).  A thread per state
// element; the loads of kPass chunks are issued together, so a thread
// waits on memory once per kPass chunks rather than once per chunk (as
// csrc/ssd_chunk.cu's pass does; the same sums in the same order).
constexpr int kPass = 8;

__global__ void __launch_bounds__(256)
pass_kernel(float* __restrict__ hprev, float* __restrict__ hf,
            float* __restrict__ dstate, const float* __restrict__ dhf,
            const float* __restrict__ decay, int nc, int PN) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= PN) return;
  const float* d = decay + (size_t)bh * nc;
  float* s = hprev + (size_t)bh * nc * PN + e;
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
  float* q = dstate + (size_t)bh * nc * PN + e;
  float gc = dhf != nullptr ? dhf[(size_t)bh * PN + e] : 0.f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kPass) {   // chunks c1, c1 - 1, ..
    float ec[kPass], dc[kPass];
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      ec[k] = c1 - k >= 0 ? q[(size_t)(c1 - k) * PN] : 0.f;
      dc[k] = c1 - k >= 0 ? expf(d[c1 - k]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      if (c1 - k >= 0) {
        q[(size_t)(c1 - k) * PN] = gc;
        gc = dc[k] * gc + ec[k];
      }
    }
  }
}

size_t f32_rows_smem(int P, int N) {
  return sizeof(float) * (2 * kMaxChunk + 2 * kTile * (N + 1) +
                          2 * kTile * (P + 1) + kTile * kZ);
}

// ---- launch 3: rows.  Tile I of chunk c: dC_I and dcum's dy . y part.
// Thread (ti, tj) owns rows i = ti + 16 r (r < 4) of the tile, columns
// j = tj + 16 s (s < 4) of each 64 x 64 product and n = tj + 16 s (s < 8)
// of dC.
__global__ void __launch_bounds__(kThreads) rows_kernel(Args g) {
  extern __shared__ float sm[];
  const int bh = blockIdx.x, c = blockIdx.y, I = blockIdx.z;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int i0 = I * kTile;
  if (i0 >= L) return;                    // rows past S do not exist
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int P = g.P, N = g.N, NP = N + 1, PP = P + 1;
  const int ni = min(kTile, L - i0);
  float* dt_s = sm;
  float* cum_s = dt_s + kMaxChunk;
  float* c_s = cum_s + kMaxChunk;         // (kTile, N + 1) C_I
  float* y_s = c_s + kTile * NP;          // (kTile, P + 1) dY_I
  float* b_s = y_s + kTile * PP;          // (kTile, N + 1) B_J; h_prev first
  float* x_s = b_s + kTile * NP;          // (kTile, P + 1) X_J
  float* z_s = x_s + kTile * PP;          // (kTile, kZ) Z_IJ

  const float* xb = static_cast<const float*>(g.x) + off(g.xs, b, c0, h);
  const float* bb = static_cast<const float*>(g.bm) + off(g.bs, b, c0, h);
  const float* cb = static_cast<const float*>(g.cm) + off(g.cs, b, c0, h);
  const float* yb = static_cast<const float*>(g.dy) + off(g.ys, b, c0, h);
  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  load_rows(c_s, cb, g.cs.s, i0, ni, N, nullptr);
  load_rows(y_s, yb, g.ys.s, i0, ni, P, nullptr);
  load_state(b_s, g.hprev + ((size_t)bh * g.nc + c) * P * N, P, N);
  __syncthreads();

  // off-diagonal: dC = exp(cum_i) dY h_prev, and its share of dy . y,
  // C_i . that
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
  for (int p = 0; p < P; ++p) {
    float yy[4], hh[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) yy[r] = y_s[(ti + 16 * r) * PP + p];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = tj + 16 * s;
      hh[s] = n < N ? b_s[p * NP + n] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] += yy[r] * hh[s];
  }
  float dyy[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti + 16 * r;
    const float e = expf(cum_s[i0 + i]);
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = tj + 16 * s;
      acc[r][s] *= e;
      if (n < N) o += c_s[i * NP + n] * acc[r][s];
    }
    dyy[r] = o;
  }

  // diagonal: column tiles J <= I
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kTile, nj = min(kTile, L - j0);
    __syncthreads();                      // b_s (h_prev first), x_s, z_s free
    load_rows(b_s, bb, g.bs.s, j0, nj, N, nullptr);
    load_rows(x_s, xb, g.xs.s, j0, nj, P, nullptr);
    __syncthreads();
    float gg[4][4], qq[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) gg[r][s] = qq[r][s] = 0.f;
    for (int n = 0; n < N; ++n) {
      float u[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = c_s[(ti + 16 * r) * NP + n];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = b_s[(tj + 16 * s) * NP + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) gg[r][s] += u[r] * v[s];
    }
    for (int p = 0; p < P; ++p) {
      float u[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = y_s[(ti + 16 * r) * PP + p];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = x_s[(tj + 16 * s) * PP + p];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) qq[r][s] += u[r] * v[s];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = i0 + ti + 16 * r;    // chunk positions
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int jl = j0 + tj + 16 * s;
        const float z = jl <= il ? qq[r][s] * expf(cum_s[il] - cum_s[jl]) *
                                       dt_s[jl]
                                 : 0.f;
        dyy[r] += gg[r][s] * z;
        z_s[(ti + 16 * r) * kZ + tj + 16 * s] = z;
      }
    }
    __syncthreads();
    for (int j = 0; j < nj; ++j) {
      float zz[4], v[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) zz[r] = z_s[(ti + 16 * r) * kZ + j];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int n = tj + 16 * s;
        v[s] = n < N ? b_s[j * NP + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] += zz[r] * v[s];
    }
  }

  float* dcb = static_cast<float*>(g.dc) +
               ((size_t)b * g.S + c0 + i0) * g.H * N + (size_t)h * N;
  const size_t rs = (size_t)g.H * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti + 16 * r;
    const float d = sum16(dyy[r]);
    if (i >= ni) continue;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = tj + 16 * s;
      if (n < N) dcb[i * rs + n] = acc[r][s];
    }
    if (tj == 0) g.dcum[(size_t)bh * g.S + c0 + i0 + i] = d;
  }
}

size_t f32_cols_smem(int P, int N) {
  return sizeof(float) * (2 * kMaxChunk + 32 + 2 * kTile * (N + 1) +
                          2 * kTile * (P + 1) + 2 * kTile * kZ +
                          kMaxP * (N + 1));
}

// ---- launch 4: columns.  Tile J of chunk c: dB_J, W_J (dx, x . W) over
// row tiles I >= J after the state terms.  Thread (ti, tj) owns rows
// j = ti + 16 r (r < 4) of the tile, columns i = tj + 16 s (s < 4) of each
// 64 x 64 product, n = tj + 16 s (s < 8) of dB and p = tj + 16 s (s < 4)
// of W.
__global__ void __launch_bounds__(kThreads) cols_kernel(Args g) {
  extern __shared__ float sm[];
  const int bh = blockIdx.x, c = blockIdx.y, J = blockIdx.z;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = c * g.chunk, L = min(g.chunk, g.S - c0);
  const int j0 = J * kTile;
  if (j0 >= L) return;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int P = g.P, N = g.N, NP = N + 1, PP = P + 1;
  const int nj = min(kTile, L - j0);
  float* dt_s = sm;
  float* cum_s = dt_s + kMaxChunk;
  float* red = cum_s + kMaxChunk;         // 32
  float* b_s = red + 32;                  // (kTile, N + 1) B_J
  float* x_s = b_s + kTile * NP;          // (kTile, P + 1) X_J
  float* c_s = x_s + kTile * PP;          // (kTile, N + 1) C_I
  float* y_s = c_s + kTile * NP;          // (kTile, P + 1) dY_I
  float* zt_s = y_s + kTile * PP;         // (kTile, kZ) Z^T: [j][i]
  float* mt_s = zt_s + kTile * kZ;        // (kTile, kZ) M^T
  float* d_s = mt_s + kTile * kZ;         // (P, N + 1) D_c

  const float* xb = static_cast<const float*>(g.x) + off(g.xs, b, c0, h);
  const float* bb = static_cast<const float*>(g.bm) + off(g.bs, b, c0, h);
  const float* cb = static_cast<const float*>(g.cm) + off(g.cs, b, c0, h);
  const float* yb = static_cast<const float*>(g.dy) + off(g.ys, b, c0, h);
  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  const float cum_last = cum_s[L - 1];
  load_rows(b_s, bb, g.bs.s, j0, nj, N, nullptr);
  load_rows(x_s, xb, g.xs.s, j0, nj, P, nullptr);
  const float* dsrc = g.dstate + ((size_t)bh * g.nc + c) * P * N;
  load_state(d_s, dsrc, P, N);
  __syncthreads();

  // <D, state leaving the chunk>, for dcum at L - 1 (in this tile only)
  float leave = 0.f;
  if (j0 + kTile >= L) {
    const float* ho = c + 1 < g.nc
                          ? g.hprev + ((size_t)bh * g.nc + c + 1) * P * N
                          : g.hf + (size_t)bh * P * N;
    float v = 0.f;
    for (int e = tid; e < P * N; e += kThreads) v += dsrc[e] * ho[e];
    leave = block_sum(v, red);
  }

  // state terms: W = w_j B D^T, dB = w_j dt_j X D
  float accb[4][8], accw[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int s = 0; s < 8; ++s) accb[r][s] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) accw[r][s] = 0.f;
  }
  for (int n = 0; n < N; ++n) {
    float u[4], v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) u[r] = b_s[(ti + 16 * r) * NP + n];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = tj + 16 * s;
      v[s] = p < P ? d_s[p * NP + n] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) accw[r][s] += u[r] * v[s];
  }
  for (int p = 0; p < P; ++p) {
    float u[4], v[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) u[r] = x_s[(ti + 16 * r) * PP + p];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = tj + 16 * s;
      v[s] = n < N ? d_s[p * NP + n] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) accb[r][s] += u[r] * v[s];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int jl = j0 + ti + 16 * r;
    const float w = jl < L ? expf(cum_last - cum_s[jl]) : 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) accw[r][s] *= w;
#pragma unroll
    for (int s = 0; s < 8; ++s) accb[r][s] *= w * dt_s[jl];
  }

  // row tiles I >= J
  for (int i0 = j0; i0 < L; i0 += kTile) {
    const int ni = min(kTile, L - i0);
    __syncthreads();                      // c_s, y_s, zt_s, mt_s free
    load_rows(c_s, cb, g.cs.s, i0, ni, N, nullptr);
    load_rows(y_s, yb, g.ys.s, i0, ni, P, nullptr);
    __syncthreads();
    float gg[4][4], qq[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) gg[r][s] = qq[r][s] = 0.f;
    for (int n = 0; n < N; ++n) {
      float u[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = b_s[(ti + 16 * r) * NP + n];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = c_s[(tj + 16 * s) * NP + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) gg[r][s] += u[r] * v[s];
    }
    for (int p = 0; p < P; ++p) {
      float u[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = x_s[(ti + 16 * r) * PP + p];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = y_s[(tj + 16 * s) * PP + p];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) qq[r][s] += u[r] * v[s];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jl = j0 + ti + 16 * r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int il = i0 + tj + 16 * s;
        const float l = jl <= il ? expf(cum_s[il] - cum_s[jl]) : 0.f;
        mt_s[(ti + 16 * r) * kZ + tj + 16 * s] = gg[r][s] * l;
        zt_s[(ti + 16 * r) * kZ + tj + 16 * s] = qq[r][s] * l * dt_s[jl];
      }
    }
    __syncthreads();
    for (int i = 0; i < ni; ++i) {
      float zz[4], mm[4], cv[8], yv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        zz[r] = zt_s[(ti + 16 * r) * kZ + i];
        mm[r] = mt_s[(ti + 16 * r) * kZ + i];
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int n = tj + 16 * s;
        cv[s] = n < N ? c_s[i * NP + n] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = tj + 16 * s;
        yv[s] = p < P ? y_s[i * PP + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 8; ++s) accb[r][s] += zz[r] * cv[s];
#pragma unroll
        for (int s = 0; s < 4; ++s) accw[r][s] += mm[r] * yv[s];
      }
    }
  }

  // dx = dt_j W_j, ddt's direct term x_j . W_j, dcum -= dt_j x_j . W_j
  const size_t xrs = (size_t)g.H * P, nrs = (size_t)g.H * N;
  float* dxb = static_cast<float*>(g.dx) + ((size_t)b * g.S + c0 + j0) * xrs +
               (size_t)h * P;
  float* dbb = static_cast<float*>(g.db) + ((size_t)b * g.S + c0 + j0) * nrs +
               (size_t)h * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ti + 16 * r, jl = j0 + j;
    float xw = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = tj + 16 * s;
      if (p < P) xw += x_s[j * PP + p] * accw[r][s];
    }
    xw = sum16(xw);
    if (j >= nj) continue;
    const float d = dt_s[jl];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = tj + 16 * s;
      if (p < P) dxb[j * xrs + p] = d * accw[r][s];
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = tj + 16 * s;
      if (n < N) dbb[j * nrs + n] = accb[r][s];
    }
    if (tj == 0) {
      g.ddt[((size_t)b * g.S + c0 + jl) * g.H + h] = xw;
      float* dc = g.dcum + (size_t)bh * g.S + c0 + jl;
      *dc = *dc - d * xw + (jl == L - 1 ? leave : 0.f);
    }
  }
}

// ---- launch 6 (both dtypes): ddt += a r and da = sum dt r, r the reverse
// cumsum of dcum within each chunk.  One block per head, a thread per chunk
// position.
__global__ void __launch_bounds__(kMaxChunk) dcum_kernel(Args g) {
  __shared__ float sc[kMaxChunk];
  __shared__ float red[32];
  const int h = blockIdx.x, tid = threadIdx.x;
  const float A = g.a[h];
  float acc = 0.f;
  for (int b = 0; b < g.B; ++b) {
    for (int c0 = 0; c0 < g.S; c0 += g.chunk) {
      const int L = min(g.chunk, g.S - c0);
      const size_t bh = (size_t)b * g.H + h;
      sc[tid] = tid < L ? g.dcum[bh * g.S + c0 + tid] : 0.f;
      __syncthreads();
      for (int o = 1; o < kMaxChunk; o <<= 1) {
        const float t = tid + o < kMaxChunk ? sc[tid + o] : 0.f;
        __syncthreads();
        sc[tid] += t;
        __syncthreads();
      }
      if (tid < L) {
        const float r = sc[tid];
        g.ddt[((size_t)b * g.S + c0 + tid) * g.H + h] += A * r;
        acc += g.dt[off(g.ds, b, c0 + tid, h)] * r;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((tid & 31) == 0) red[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kMaxChunk / 32; ++w) s += red[w];
    g.da[h] = s;
  }
}

// ================================================================ host
size_t states_tc_smem(int P, int N) {
  return 2 * kMaxChunk * sizeof(float) +
         (size_t)kTile * (2 * (round16(P) + 8) + (round16(N) + 8)) *
             sizeof(bf16);
}

size_t cb_smem(int N) {
  return (size_t)2 * kTile * (round16(N) + 8) * sizeof(bf16);
}

size_t f32_states_smem(int P, int N) {
  return sizeof(float) * (3 * kMaxChunk + kTile * (P + 1) + kTile * (N + 1));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// one launch: refused (shared memory) or failed to start -> its error
#define LAUNCH(kernel, grid, threads, smem, st, ...)                    \
  do {                                                                  \
    cudaError_t e_ = allow_smem(kernel, smem);                          \
    if (e_ != cudaSuccess) return e_;                                   \
    kernel<<<grid, threads, smem, st>>>(__VA_ARGS__);                   \
    if ((e_ = cudaGetLastError()) != cudaSuccess) return e_;            \
  } while (0)

cudaError_t launch_pass(const Args& g, cudaStream_t st) {
  const int PN = g.P * g.N;
  pass_kernel<<<dim3((PN + 255) / 256, g.B * g.H), 256, 0, st>>>(
      g.hprev, g.hf, g.dstate, g.dhf, g.decay, g.nc, PN);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Args& g, int phases, cudaStream_t st) {
  const int BH = g.B * g.H, tiles = g.T / kTile;
  cudaError_t err;
  if (phases & 1) {                       // the states, h_prev and D
    LAUNCH(states_tc_kernel, dim3(BH, g.nc, 2), kTcThreads,
           states_tc_smem(g.P, g.N), st, g);
    if ((err = launch_pass(g, st)) != cudaSuccess) return err;
  }
  if (phases & 4)                         // C B^T once per group
    LAUNCH(cb_kernel, dim3(g.B * g.G, g.nc, tiles * (tiles + 1) / 2),
           kTcThreads, cb_smem(g.N), st, g);
  if (phases & 2) {                       // the within-chunk gradients
    LAUNCH(rows_tc_kernel, dim3(BH, g.nc, tiles), kTcThreads,
           rows_smem(g.P, g.N), st, g);
    LAUNCH(cols_tc_kernel, dim3(BH, g.nc, tiles), kTcThreads,
           cols_smem(g.P, g.N), st, g);
    dcum_kernel<<<g.H, kMaxChunk, 0, st>>>(g);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

cudaError_t launch_f32(const Args& g, int phases, cudaStream_t st) {
  const int BH = g.B * g.H, tiles = g.T / kTile;
  const size_t s_st = f32_states_smem(g.P, g.N);
  cudaError_t err;
  if (phases & 1) {
    LAUNCH(states_kernel<true>, dim3(BH, g.nc), kThreads, s_st, st, g);
    LAUNCH(states_kernel<false>, dim3(BH, g.nc), kThreads, s_st, st, g);
    if ((err = launch_pass(g, st)) != cudaSuccess) return err;
  }
  if (phases & 2) {
    LAUNCH(rows_kernel, dim3(BH, g.nc, tiles), kThreads,
           f32_rows_smem(g.P, g.N), st, g);
    LAUNCH(cols_kernel, dim3(BH, g.nc, tiles), kThreads,
           f32_cols_smem(g.P, g.N), st, g);
    dcum_kernel<<<g.H, kMaxChunk, 0, st>>>(g);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

bool valid_dims(int B, int S, int H, int P, int N, int chunk, int G) {
  return B > 0 && H > 0 && S > 0 && P > 0 && P <= kMaxP && N > 0 &&
         N <= kMaxN && chunk > 0 && chunk <= kMaxChunk &&
         (S + chunk - 1) / chunk <= 65535 && (G == 1 || G == H);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, and dx, dB, dC); dt, a,
// dh_final, ddt, da and the scratch are f32.  x, B, C and dy are (B, S, H,
// P or N) and dt (B, S, H), each through its (B, S, H) element strides (the
// last axis unit-stride; a stride may be 0); dx (B, S, H, P), dB and dC (B,
// S, H, N) per head, ddt (B, S, H) and da (H,) are written contiguous.
// dh_final (B, H, P, N) contiguous, or null for a zero gradient of h_final.
// Scratch: hprev and dstate (B, H, n_chunks, P, N), hf (B, H, P, N), decay
// (B, H, n_chunks), dcum (B, H, S), and in bf16 cb (B, n_chunks, G, T, T),
// T the chunk rounded up to 64: G = 1 takes B's and C's head stride 0 (one
// group read for every head), G = H one C B^T per head.  `phases`: 1 = the
// states, the forward's state pass and the reverse pass (into hprev, hf,
// dstate, decay), 4 = C B^T (bf16 only, into cb), 2 = the within-chunk
// gradients from them; 7 (bf16) or 3 (f32) = all.  P <= 64, N <= 128,
// chunk <= 256; in bf16 P and N multiples of 8, x, B, C, dy and their
// strides 16-byte aligned.  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int repro_ssd_chunk_bwd(
    int dtype, int phases, const void* x, const void* dt, const void* a,
    const void* b, const void* c, const void* dy, const void* dh_final,
    void* dx, void* ddt, void* da, void* db, void* dc, void* hprev, void* hf,
    void* dstate, void* decay, void* dcum, void* cb, int B, int S, int H,
    int P, int N, int chunk, int G, long long xsb, long long xss,
    long long xsh, long long dsb, long long dss, long long dsh, long long bsb,
    long long bss, long long bsh, long long csb, long long css, long long csh,
    long long ysb, long long yss, long long ysh, void* stream) {
  if (!valid_dims(B, S, H, P, N, chunk, G) || phases <= 0 || phases > 7 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && (phases & 4)) return (int)cudaErrorInvalidValue;
  if (dtype == 1 &&
      (P % 8 || N % 8 || (G == 1 && H > 1 && (bsh != 0 || csh != 0)) ||
       ((phases & 6) && cb == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args g;
  g.x = x;
  g.bm = b;
  g.cm = c;
  g.dy = dy;
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.dhf = static_cast<const float*>(dh_final);
  g.dx = dx;
  g.db = db;
  g.dc = dc;
  g.ddt = static_cast<float*>(ddt);
  g.da = static_cast<float*>(da);
  g.hprev = static_cast<float*>(hprev);
  g.hf = static_cast<float*>(hf);
  g.dstate = static_cast<float*>(dstate);
  g.decay = static_cast<float*>(decay);
  g.dcum = static_cast<float*>(dcum);
  g.cb = static_cast<float*>(cb);
  g.B = B;
  g.H = H;
  g.S = S;
  g.P = P;
  g.N = N;
  g.chunk = chunk;
  g.nc = (S + chunk - 1) / chunk;
  g.G = G;
  g.T = (chunk + kTile - 1) / kTile * kTile;
  g.xs = {xsb, xss, xsh};
  g.ds = {dsb, dss, dsh};
  g.bs = {bsb, bss, bsh};
  g.cs = {csb, css, csh};
  g.ys = {ysb, yss, ysh};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? (int)launch_f32(g, phases, st)
                    : (int)launch_bf16(g, phases, st);
}

// The bf16 backward's launches at these sizes, in launch order (chunk
// states, state passes, C B^T, rows, columns, dcum): four numbers each into
// `out` (24): blocks, threads a block, dynamic shared memory bytes a
// block, and the blocks an SM holds at once as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports it.  Returns 0 or a
// CUDA error.
extern "C" int repro_ssd_chunk_bwd_plan(int B, int S, int H, int P, int N,
                                        int chunk, int G, long long* out) {
  if (!valid_dims(B, S, H, P, N, chunk, G) || P % 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + chunk - 1) / chunk, tiles = (chunk + kTile - 1) / kTile;
  const int BH = B * H, PN = P * N;
  struct Row {
    const void* fn;
    long long blocks;
    int threads;
    size_t smem;
  } rows[6] = {
      {(const void*)states_tc_kernel, 2LL * BH * nc, kTcThreads,
       states_tc_smem(P, N)},
      {(const void*)pass_kernel, (long long)((PN + 255) / 256) * BH, 256, 0},
      {(const void*)cb_kernel, (long long)B * G * nc * tiles * (tiles + 1) / 2,
       kTcThreads, cb_smem(N)},
      {(const void*)rows_tc_kernel, (long long)BH * nc * tiles, kTcThreads,
       rows_smem(P, N)},
      {(const void*)cols_tc_kernel, (long long)BH * nc * tiles, kTcThreads,
       cols_smem(P, N)},
      {(const void*)dcum_kernel, H, kMaxChunk, 0}};
  for (int k = 0; k < 6; ++k) {
    cudaError_t err = cudaFuncSetAttribute(
        rows[k].fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rows[k].smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rows[k].fn, rows[k].threads, rows[k].smem);
    if (err != cudaSuccess) return (int)err;
    out[4 * k] = rows[k].blocks;
    out[4 * k + 1] = rows[k].threads;
    out[4 * k + 2] = (long long)rows[k].smem;
    out[4 * k + 3] = per_sm;
  }
  return 0;
}
