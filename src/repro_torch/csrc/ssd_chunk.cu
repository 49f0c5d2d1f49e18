// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk/kernel.py::_kernel
// (launched by ssd_scan_bh, wrapped by ops.py::ssd_scan).
//
// What it computes, per (batch * head) row bh, from a zero state, chunk by
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
// What bounds it: in this first version, the f32 FMAs on the CUDA cores.
// Per chunk of Q positions and row bh it does about Q^2/2 (N + P) + 2 Q P N
// MACs against Q (P + 2N) values read: at mamba2-780m's P 64, N 128,
// Q 256 about 40 FLOP per byte in bf16, past the f32 CUDA cores' ~20
// FLOP/byte ridge (but under the tensor cores' ~295).
//
// Design (the simple first version):
//   * the TPU kernel holds the chunk's (Q, Q) decay matrix in f32 VMEM --
//     256 KB at Q 256, more than an SM's 228 KB of shared memory.  Here
//     one block of 256 threads per bh loops over the chunks (the TPU's
//     sequential chunk grid) with the (P, N) f32 state in shared memory
//     (33 KB at P 64, N 128) and tiles the chunk's rows by 32: for row
//     tile I it forms the (32, 32) decay-weighted C_I B_J^T block for each
//     column tile J <= I in shared memory and multiplies it into x_J dt_J,
//     so no (Q, Q) matrix ever exists;
//   * the inclusive cumsum of dt * a over the chunk is a Hillis-Steele
//     scan in shared memory (one thread per position);
//   * tiles are loaded as f32 with rows padded by one float, so every
//     inner product walks shared memory without bank conflicts;
//   * all sums are f32; y is rounded to the activation type once.
// Tensor cores (wgmma on the C B^T and state products), reading B and C
// once per group instead of once per head, and splitting a sequence over
// blocks when B * H rows are too few to fill 132 SMs are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                 // row (and column) tile
constexpr int kMaxChunk = 256;            // one scan thread per position
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kYAcc = kRows * kMaxP / kThreads;     // (row, p) per thread
constexpr int kHAcc = kMaxP * kMaxN / kThreads;     // (p, n) per thread
constexpr int kGAcc = kRows * kRows / kThreads;     // (i, j) per thread
static_assert(kThreads == kMaxChunk, "the scan maps a thread per position");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int P, int N) {
  const int NP = N + 1, PP = P + 1;
  return sizeof(float) * ((size_t)P * NP + 2 * kRows * NP + kRows * PP +
                          kRows * (kRows + 1) + 2 * kMaxChunk);
}

// rows [r0, r0 + nr) of a (S, W) row-major array -> dst (kRows, W + 1),
// times scale_s[r] when scale_s is given; rows past nr are zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int nr, int W,
                                          const float* scale_s) {
  for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
    const int r = e / W, c = e % W;
    float v = 0.f;
    if (r < nr) {
      v = to_f32(src[(size_t)(r0 + r) * W + c]);
      if (scale_s != nullptr) v *= scale_s[r];
    }
    dst[r * (W + 1) + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bmat,
                 const T* __restrict__ cmat, T* __restrict__ y,
                 float* __restrict__ h_final, int S, int P, int N,
                 int chunk) {
  extern __shared__ float sm[];
  const int NP = N + 1, PP = P + 1, GP = kRows + 1;
  float* h_s = sm;                          // (P, N + 1) state
  float* c_s = h_s + P * NP;                // (kRows, N + 1) C row tile
  float* b_s = c_s + kRows * NP;            // (kRows, N + 1) B column tile
  float* x_s = b_s + kRows * NP;            // (kRows, P + 1) scaled x tile
  float* g_s = x_s + kRows * PP;            // (kRows, kRows + 1) C B^T * L
  float* cum_s = g_s + kRows * GP;          // (kMaxChunk) cumsum of dt * a
  float* w_s = cum_s + kMaxChunk;           // (kMaxChunk) row scales

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const float A = a[bh];
  const T* xb = x + (size_t)bh * S * P;
  const float* dtb = dt + (size_t)bh * S;
  const T* bb = bmat + (size_t)bh * S * N;
  const T* cb = cmat + (size_t)bh * S * N;
  T* yb = y + (size_t)bh * S * P;

  for (int e = tid; e < P * NP; e += kThreads) h_s[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int L = min(chunk, S - c0);
    __syncthreads();  // the previous chunk's state is written
    // ---- dt and the inclusive cumsum of dt * a over the chunk
    const float d = tid < L ? dtb[c0 + tid] : 0.f;
    cum_s[tid] = d * A;
    __syncthreads();
    for (int off = 1; off < L; off <<= 1) {
      const float v = (tid >= off && tid < L) ? cum_s[tid - off] : 0.f;
      __syncthreads();
      cum_s[tid] += v;
      __syncthreads();
    }
    const float cum_last = cum_s[L - 1];
    const int n_tiles = (L + kRows - 1) / kRows;

    // ---- y, one row tile at a time
    for (int I = 0; I < n_tiles; ++I) {
      const int i0 = I * kRows;
      const int ni = min(kRows, L - i0);
      __syncthreads();  // c_s, w_s free
      w_s[tid] = d;     // dt by chunk position, to scale x tiles
      load_rows(c_s, cb, c0 + i0, ni, N, nullptr);
      __syncthreads();
      float yacc[kYAcc];
      // off-diagonal: exp(cum_i) * C_i . h[p]
#pragma unroll
      for (int k = 0; k < kYAcc; ++k) {
        const int e = tid + k * kThreads;
        yacc[k] = 0.f;
        if (e < kRows * P) {
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
        const int j0 = J * kRows;
        const int nj = min(kRows, L - j0);
        __syncthreads();  // b_s, x_s, g_s consumed
        load_rows(b_s, bb, c0 + j0, nj, N, nullptr);
        load_rows(x_s, xb, c0 + j0, nj, P, w_s + j0);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kGAcc; ++k) {
          const int e = tid + k * kThreads;
          const int r = e / kRows, j = e % kRows;
          float g = 0.f;
          if (r < ni && j < nj && j0 + j <= i0 + r) {
            for (int n = 0; n < N; ++n) g += c_s[r * NP + n] * b_s[j * NP + n];
            g *= expf(cum_s[i0 + r] - cum_s[j0 + j]);
          }
          g_s[r * GP + j] = g;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kYAcc; ++k) {
          const int e = tid + k * kThreads;
          if (e < kRows * P) {
            const int r = e / P, p = e % P;
            float s = 0.f;
#pragma unroll 8
            for (int j = 0; j < kRows; ++j) s += g_s[r * GP + j] * x_s[j * PP + p];
            yacc[k] += s;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kYAcc; ++k) {
        const int e = tid + k * kThreads;
        if (e < kRows * P) {
          const int r = e / P, p = e % P;
          if (r < ni) from_f32(yb + (size_t)(c0 + i0 + r) * P + p, yacc[k]);
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
      const int e = tid + k * kThreads;
      hacc[k] = e < P * N ? h_s[(e / N) * NP + e % N] * decay : 0.f;
    }
    for (int J = 0; J < n_tiles; ++J) {
      const int j0 = J * kRows;
      const int nj = min(kRows, L - j0);
      __syncthreads();  // b_s, x_s consumed (and w_s written)
      load_rows(b_s, bb, c0 + j0, nj, N, nullptr);
      load_rows(x_s, xb, c0 + j0, nj, P, w_s + j0);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kHAcc; ++k) {
        const int e = tid + k * kThreads;
        if (e < P * N) {
          const int p = e / N, n = e % N;
          float s = 0.f;
#pragma unroll 8
          for (int j = 0; j < kRows; ++j) s += x_s[j * PP + p] * b_s[j * NP + n];
          hacc[k] += s;
        }
      }
    }
    __syncthreads();  // nobody reads h_s any more in this chunk
#pragma unroll
    for (int k = 0; k < kHAcc; ++k) {
      const int e = tid + k * kThreads;
      if (e < P * N) h_s[(e / N) * NP + e % N] = hacc[k];
    }
  }
  __syncthreads();
  float* hb = h_final + (size_t)bh * P * N;
  for (int e = tid; e < P * N; e += kThreads) hb[e] = h_s[(e / N) * NP + e % N];
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* a,
                         const void* b, const void* c, void* y, float* hf,
                         int BH, int S, int P, int N, int chunk,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), hf, S, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, y); dt, a and h_final f32.
// x (BH, S, P), dt (BH, S), a (BH,), B and C (BH, S, N), y (BH, S, P),
// h_final (BH, P, N), all contiguous.  P <= 64, N <= 128, chunk <= 256.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_ssd_chunk_scan(int dtype, const void* x, const void* dt,
                                    const void* a, const void* b,
                                    const void* c, void* y, void* h_final,
                                    int BH, int S, int P, int N, int chunk,
                                    void* stream) {
  if (BH <= 0 || S <= 0 || P <= 0 || P > kMaxP || N <= 0 || N > kMaxN ||
      chunk <= 0 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const auto* dtp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(a);
  auto* hp = static_cast<float*>(h_final);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(x, dtp, ap, b, c, y, hp, BH, S, P, N,
                                    chunk, st);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(x, dtp, ap, b, c, y, hp, BH, S,
                                            P, N, chunk, st);
  return (int)cudaErrorInvalidValue;
}
