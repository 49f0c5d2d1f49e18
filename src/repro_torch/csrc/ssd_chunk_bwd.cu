// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a): chunk-parallel,
// f32 sums on the CUDA cores.
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
// Design: five launches on f32 scratch the wrapper allocates, each block
// 256 threads, every product an f32 FMA on the CUDA cores from tiles of 64
// positions held in shared memory in f32 (bf16 inputs are widened once as
// they are loaded); the block's 64 x 64 (or 64 x N, 64 x P) output tile is
// a 4 x 4 (4 x 8) register tile per thread:
//   1. chunk states, grid (B*H, nc), twice: the forward's S_c = sum_j w_j
//      dt_j x_j B_j^T with its cum_last, then E_c (dy for x, C for B,
//      exp(cum_i) for the weight);
//   2. the forward's state pass over S_c (h_prev in place, h_final), and
//      the reverse pass over E_c (D_c in place), grid (P*N / 256, B*H);
//   3. rows, grid (B*H, nc, chunk / 64): a 64-row tile I of dC and of
//      dy . y over the column tiles J <= I (C_I and dY_I stay in shared
//      memory, B_J and X_J stream); writes dC and dcum's first part;
//   4. columns, grid (B*H, nc, chunk / 64): a 64-column tile J of dB, W
//      (so dx and x . W) over the row tiles I >= J, after the state terms
//      from D; adds -dt (x . W) and, at L - 1, <D, state leaving> to dcum;
//   5. dcum to ddt and da, grid (H): each block walks its head's (b,
//      chunk) pairs in order, a reverse scan of 256 positions each, and
//      reduces da in a fixed order (no atomics: two runs give the same
//      bits, as a resumed training run must).
// Rows and columns recompute C B^T and dY X^T each (the same products
// twice), which keeps every output tile in one block and every sum in a
// fixed order.
//
// What bounds it: at mamba2-780m's train microbatch (4 x 1024, H 48, P 64,
// N 128, chunk 256) the function reads x, dy (bf16), dt and B, C once per
// group and writes dx, ddt and dB, dC once per group, about 81 MB (0.024 ms
// at 3.35 TB/s; writing dB and dC per head, as this version does, adds
// 97 MB).  Its products, on the lower triangle where masked (C B^T, dY X^T,
// Z B, Z^T C, M^T dY) and whole (dY h_prev, X D, B D^T, and the chunk
// states S_c and E_c), are about 42 GFLOP (0.043 ms at 989 TFLOP/s bf16):
// operations bound it, at about 0.043 ms (chip_smoke.py reckons both from
// the run's shapes).  This first version runs the products in f32 on the
// CUDA cores (67 TFLOP/s peak, and these tiles feed the FMAs from shared
// memory at about half that) and computes C B^T and dY X^T twice, so it
// stays far from that bound; the next version moves the products onto
// mma.sync / wgmma in bf16 as the forward does, shares the two products
// between rows and columns, and sums dB and dC over a group's heads
// itself (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kThreads = 256;
constexpr int kTile = 64;                 // positions per tile
constexpr int kZ = kTile + 1;             // row length of a 64 x 64 tile

struct Strides {
  long long b, s, h;                      // element strides of (B, S, H)
};

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
  int B, H, S, P, N, chunk, nc;
  Strides xs, ds, bs, cs, ys;
};

__device__ __forceinline__ long long off(const Strides& st, int b, long long s,
                                         int h) {
  return b * st.b + s * st.s + h * st.h;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// rows [r0, r0 + nr) of a strided (rows, W) array into dst (kTile, W + 1)
// in f32, each row times scale[r] when scale is given; rows past nr zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long rs, int r0, int nr, int W,
                                          const float* scale) {
  for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
    const int r = e / W, k = e % W;
    float v = 0.f;
    if (r < nr) {
      v = ld(src + (r0 + r) * rs + k);
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

// sum of v over the block, in a fixed order; every thread gets it
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// ---- launch 1: chunk states.  kFwd: S_c = sum_j dt_j exp(cum_last -
// cum_j) x_j B_j^T and cum_last; else E_c = sum_i exp(cum_i) dy_i C_i^T.
// Thread (ti, tj) = (tid / 16, tid % 16) owns rows p = ti + 16 r and
// columns n = tj + 16 s of the (P, N) sum.
template <typename T, bool kFwd>
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
  const T* u = static_cast<const T*>(kFwd ? g.x : g.dy) +
               (kFwd ? off(g.xs, b, c0, h) : off(g.ys, b, c0, h));
  const long long us = kFwd ? g.xs.s : g.ys.s;
  const T* v = static_cast<const T*>(kFwd ? g.bm : g.cm) +
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

// ---- launch 2: the forward's state pass (h_c = exp(cum_last_c) h_{c-1} +
// S_c from 0; S_c overwritten by the state entering c; h_final) and the
// reverse pass (D_{c-1} = exp(cum_last_c) D_c + E_c from dh_final or 0; E_c
// overwritten by D_c).  A thread per state element.
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
  for (int c = 0; c < nc; ++c) {
    const float sc = s[(size_t)c * PN];
    s[(size_t)c * PN] = hc;
    hc = expf(d[c]) * hc + sc;
  }
  hf[(size_t)bh * PN + e] = hc;
  float* q = dstate + (size_t)bh * nc * PN + e;
  float gc = dhf != nullptr ? dhf[(size_t)bh * PN + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float ec = q[(size_t)c * PN];
    q[(size_t)c * PN] = gc;
    gc = expf(d[c]) * gc + ec;
  }
}

size_t rows_smem(int P, int N) {
  return sizeof(float) * (2 * kMaxChunk + 2 * kTile * (N + 1) +
                          2 * kTile * (P + 1) + kTile * kZ);
}

// ---- launch 3: rows.  Tile I of chunk c: dC_I and dcum's dy . y part.
// Thread (ti, tj) owns rows i = ti + 16 r (r < 4) of the tile, columns
// j = tj + 16 s (s < 4) of each 64 x 64 product and n = tj + 16 s (s < 8)
// of dC.
template <typename T>
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

  const T* xb = static_cast<const T*>(g.x) + off(g.xs, b, c0, h);
  const T* bb = static_cast<const T*>(g.bm) + off(g.bs, b, c0, h);
  const T* cb = static_cast<const T*>(g.cm) + off(g.cs, b, c0, h);
  const T* yb = static_cast<const T*>(g.dy) + off(g.ys, b, c0, h);
  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  load_rows(c_s, cb, g.cs.s, i0, ni, N, (const float*)nullptr);
  load_rows(y_s, yb, g.ys.s, i0, ni, P, (const float*)nullptr);
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
    load_rows(b_s, bb, g.bs.s, j0, nj, N, (const float*)nullptr);
    load_rows(x_s, xb, g.xs.s, j0, nj, P, (const float*)nullptr);
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

  T* dcb = static_cast<T*>(g.dc) + ((size_t)b * g.S + c0 + i0) * g.H * N +
           (size_t)h * N;
  const size_t rs = (size_t)g.H * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti + 16 * r;
    const float d = sum16(dyy[r]);
    if (i >= ni) continue;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = tj + 16 * s;
      if (n < N) put(dcb + i * rs + n, acc[r][s]);
    }
    if (tj == 0) g.dcum[(size_t)bh * g.S + c0 + i0 + i] = d;
  }
}

size_t cols_smem(int P, int N) {
  return sizeof(float) * (2 * kMaxChunk + 32 + 2 * kTile * (N + 1) +
                          2 * kTile * (P + 1) + 2 * kTile * kZ +
                          kMaxP * (N + 1));
}

// ---- launch 4: columns.  Tile J of chunk c: dB_J, W_J (dx, x . W) over
// row tiles I >= J after the state terms.  Thread (ti, tj) owns rows
// j = ti + 16 r (r < 4) of the tile, columns i = tj + 16 s (s < 4) of each
// 64 x 64 product, n = tj + 16 s (s < 8) of dB and p = tj + 16 s (s < 4)
// of W.
template <typename T>
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

  const T* xb = static_cast<const T*>(g.x) + off(g.xs, b, c0, h);
  const T* bb = static_cast<const T*>(g.bm) + off(g.bs, b, c0, h);
  const T* cb = static_cast<const T*>(g.cm) + off(g.cs, b, c0, h);
  const T* yb = static_cast<const T*>(g.dy) + off(g.ys, b, c0, h);
  chunk_cumsum(g.dt + off(g.ds, b, c0, h), g.ds.s, g.a[h], L, dt_s, cum_s);
  const float cum_last = cum_s[L - 1];
  load_rows(b_s, bb, g.bs.s, j0, nj, N, (const float*)nullptr);
  load_rows(x_s, xb, g.xs.s, j0, nj, P, (const float*)nullptr);
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
    load_rows(c_s, cb, g.cs.s, i0, ni, N, (const float*)nullptr);
    load_rows(y_s, yb, g.ys.s, i0, ni, P, (const float*)nullptr);
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
  T* dxb = static_cast<T*>(g.dx) + ((size_t)b * g.S + c0 + j0) * xrs +
           (size_t)h * P;
  T* dbb = static_cast<T*>(g.db) + ((size_t)b * g.S + c0 + j0) * nrs +
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
      if (p < P) put(dxb + j * xrs + p, d * accw[r][s]);
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = tj + 16 * s;
      if (n < N) put(dbb + j * nrs + n, accb[r][s]);
    }
    if (tj == 0) {
      g.ddt[((size_t)b * g.S + c0 + jl) * g.H + h] = xw;
      float* dc = g.dcum + (size_t)bh * g.S + c0 + jl;
      *dc = *dc - d * xw + (jl == L - 1 ? leave : 0.f);
    }
  }
}

// ---- launch 5: ddt += a r and da = sum dt r, r the reverse cumsum of dcum
// within each chunk.  One block per head, a thread per chunk position.
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
size_t states_smem(int P, int N) {
  return sizeof(float) * (3 * kMaxChunk + kTile * (P + 1) + kTile * (N + 1));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_all(const Args& g, int phases, cudaStream_t st) {
  const int BH = g.B * g.H, PN = g.P * g.N;
  const int tiles = (g.chunk + kTile - 1) / kTile;
  const size_t s_st = states_smem(g.P, g.N), s_rows = rows_smem(g.P, g.N),
               s_cols = cols_smem(g.P, g.N);
  cudaError_t err;
  if (phases & 1) {                       // the forward's states, h_prev
    if ((err = allow_smem(states_kernel<T, true>, s_st)) != cudaSuccess)
      return err;
    if ((err = allow_smem(states_kernel<T, false>, s_st)) != cudaSuccess)
      return err;
    states_kernel<T, true><<<dim3(BH, g.nc), kThreads, s_st, st>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    states_kernel<T, false><<<dim3(BH, g.nc), kThreads, s_st, st>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    pass_kernel<<<dim3((PN + 255) / 256, BH), 256, 0, st>>>(
        g.hprev, g.hf, g.dstate, g.dhf, g.decay, g.nc, PN);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & 2) {                       // the within-chunk gradients
    if ((err = allow_smem(rows_kernel<T>, s_rows)) != cudaSuccess) return err;
    if ((err = allow_smem(cols_kernel<T>, s_cols)) != cudaSuccess) return err;
    rows_kernel<T><<<dim3(BH, g.nc, tiles), kThreads, s_rows, st>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    cols_kernel<T><<<dim3(BH, g.nc, tiles), kThreads, s_cols, st>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dcum_kernel<<<g.H, kMaxChunk, 0, st>>>(g);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, and dx, dB, dC); dt, a,
// dh_final, ddt, da and the scratch are f32.  x, B, C and dy are (B, S, H,
// P or N) and dt (B, S, H), each through its (B, S, H) element strides (the
// last axis unit-stride; a stride may be 0); dx (B, S, H, P), dB and dC (B,
// S, H, N) per head, ddt (B, S, H) and da (H,) are written contiguous.
// dh_final (B, H, P, N) contiguous, or null for a zero gradient of h_final.
// Scratch: hprev and dstate (B, H, n_chunks, P, N), hf (B, H, P, N), decay
// (B, H, n_chunks), dcum (B, H, S).  `phases`: 1 = the states, the
// forward's state pass and the reverse pass (into hprev, hf, dstate,
// decay), 2 = the within-chunk gradients from them, 3 = both.  P <= 64,
// N <= 128, chunk <= 256.  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int repro_ssd_chunk_bwd(
    int dtype, int phases, const void* x, const void* dt, const void* a,
    const void* b, const void* c, const void* dy, const void* dh_final,
    void* dx, void* ddt, void* da, void* db, void* dc, void* hprev, void* hf,
    void* dstate, void* decay, void* dcum, int B, int S, int H, int P, int N,
    int chunk, long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long bsb, long long bss, long long bsh,
    long long csb, long long css, long long csh, long long ysb, long long yss,
    long long ysh, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || chunk <= 0 || chunk > kMaxChunk || phases <= 0 ||
      phases > 3 || (S + chunk - 1) / chunk > 65535 || (dtype != 0 && dtype != 1))
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
  g.B = B;
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
  g.ys = {ysb, yss, ysh};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? (int)launch_all<float>(g, phases, st)
                    : (int)launch_all<bf16>(g, phases, st);
}
