// Tropical (min, +) batched matrix product for Hopper (sm_90a).
//
//   C[b, i, j] = min_k  A[b, i, k] + B[b, k, j]      f32 [B,M,K] x [B,K,N]
//
// Replaces the Pallas TPU kernels of the JAX package:
//   repro/kernels/minplus.py:116  _minplus_kernel_batched
//                                 (minplus_matmul_pallas_batched, :145)
//   repro/kernels/minplus.py:43   _minplus_kernel (minplus_matmul_pallas, :75)
//                                 -- the 2-D product is the B = 1 view here.
//
// What bounds it on this card.  The tensor cores only multiply-add, so a
// (min, +) product runs on the CUDA cores: 2*B*M*N*K operations (one add,
// one min per candidate) against 4*B*(M*K + K*N + M*N) bytes.  The routing
// path's stacks are tiny (B = 62 matrices of 24 x 24 per greedy round):
// ~1.7 MFLOP and ~0.43 MB, a bound of about 0.13 us (bytes) -- far below the
// few microseconds a launch costs.  Launch latency, not the SMs or HBM,
// is what bounds the product at the shapes the main path gives it.
//
// What the design does about it.
//   * Small path (M, K, N <= 32, every catalog topology): one block owns one
//     whole matrix pair in shared memory and computes all M*N*K candidates,
//     so a whole [D, V, V] stack is one launch with D blocks and no
//     K-loop over tiles, no accumulator carried between blocks.
//   * Tiled path (any dimension >= 33): 64 x 64 output tiles, 256 threads,
//     4 x 4 register accumulators per thread, K staged through shared
//     memory 16 at a time.  The ragged M, N and K edges are masked in the
//     kernel (out-of-range operands load +INFINITY, which min absorbs), so
//     the caller needs no 1e30 padding.
//   * Bit-exactness is structural: every candidate is one __fadd_rn and
//     min is exact, so the result does not depend on tiling or order.  The
//     build adds -fmad=false anyway.  fminf drops a NaN where jnp.min would
//     propagate it; the operands are finite by construction (edge weights
//     are validated by make_network/InferenceJob and clipped to 1e30).
//
// Closure (minplus_closure_f32).  ops.minplus_closure forces a stack's
// diagonal to min(w_uu, 0) and squares it closure_steps(V) times: five
// squarings at V = 24, each a launch of the product above, so the
// section V large greedy solve spent 50 launches a solve (10 rounds x 5)
// on its [62, 24, 24] stacks.  For V <= 32 one launch does it all: one
// block owns one matrix of the stack in shared memory, double-buffered
// (2 x 32 x 33 floats), forces its diagonal, runs every squaring in-block
// with a __syncthreads() between them, and writes D once.  Its bound at
// [62, 24, 24] is 0.128 us of operations (five squarings, 8.6 MFLOP at the
// 67 TFLOP/s float32 rate) against 0.085 us of bytes (W read once, D
// written once): launch latency bounds it as it does the product, and
// the design pays it once instead of five times.  Each candidate is the
// same one __fadd_rn and min is exact, so the result equals the repeated
// product bit for bit.
//
// Plain C interface (bound with ctypes): minplus_batched_f32 and
// minplus_closure_f32 return cudaGetLastError() after the launch, 0 on
// success.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSmall = 32;     // small path: whole matrices up to 32 x 32
constexpr int kSmallRows = 8;  // block = 32 x 8 threads

constexpr int kBM = 64, kBN = 64, kBK = 16;  // tiled path
constexpr int kThreads = 256;                // 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(kSmall * kSmallRows)
minplus_small_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int M, int K, int N,
                     long long sAb, long long sAm, long long sBb,
                     long long sBk, long long sCb, long long sCm) {
  __shared__ float As[kSmall][kSmall + 1];
  __shared__ float Bs[kSmall][kSmall + 1];
  const long long b = blockIdx.x;
  const float* Ab = A + b * sAb;
  const float* Bb = B + b * sBb;
  const int tid = threadIdx.y * kSmall + threadIdx.x;
  const int nthreads = kSmall * kSmallRows;
  for (int e = tid; e < M * K; e += nthreads) {
    const int i = e / K, k = e - i * K;
    As[i][k] = Ab[i * sAm + k];
  }
  for (int e = tid; e < K * N; e += nthreads) {
    const int k = e / N, j = e - k * N;
    Bs[k][j] = Bb[k * sBk + j];
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= N) return;
  float* Cb = C + b * sCb;
  for (int i = threadIdx.y; i < M; i += kSmallRows) {
    float acc = INFINITY;
    for (int k = 0; k < K; ++k)
      acc = fminf(acc, __fadd_rn(As[i][k], Bs[k][j]));
    Cb[i * sCm + j] = acc;
  }
}

// D[b] = closure of W[b]: the diagonal forced to min(w_uu, 0) (kept as is
// where it is <= 0, as torch.clamp(max=0) does), then `steps` squarings
// d <- d (min,+) d.  W and D are contiguous [batch, V, V], V <= 32.
__global__ void __launch_bounds__(kSmall * kSmallRows)
minplus_closure_kernel(const float* __restrict__ W, float* __restrict__ D,
                       int V, int steps) {
  __shared__ float buf[2][kSmall][kSmall + 1];
  const long long base = static_cast<long long>(blockIdx.x) * V * V;
  const int tid = threadIdx.y * kSmall + threadIdx.x;
  for (int e = tid; e < V * V; e += kSmall * kSmallRows) {
    const int i = e / V, j = e - i * V;
    const float w = W[base + e];
    buf[0][i][j] = (i == j && w > 0.f) ? 0.f : w;
  }
  __syncthreads();
  const int j = threadIdx.x;
  for (int s = 0; s < steps; ++s) {
    float(*src)[kSmall + 1] = buf[s & 1];
    float(*dst)[kSmall + 1] = buf[(s + 1) & 1];
    if (j < V) {
      for (int i = threadIdx.y; i < V; i += kSmallRows) {
        float acc = INFINITY;
        for (int k = 0; k < V; ++k)
          acc = fminf(acc, __fadd_rn(src[i][k], src[k][j]));
        dst[i][j] = acc;
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < V * V; e += kSmall * kSmallRows)
    D[base + e] = buf[steps & 1][e / V][e % V];
}

__global__ void __launch_bounds__(kThreads)
minplus_tiled_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int M, int K, int N,
                     int tiles_m, int tiles_n,
                     long long sAb, long long sAm, long long sBb,
                     long long sBk, long long sCb, long long sCm) {
  __shared__ float As[kBK][kBM + 1];  // A tile, transposed: As[k][i]
  __shared__ float Bs[kBK][kBN + 1];
  const int tiles = tiles_m * tiles_n;
  const long long b = blockIdx.x / tiles;
  const int t = blockIdx.x - static_cast<int>(b * tiles);
  const int m0 = (t / tiles_n) * kBM;
  const int n0 = (t % tiles_n) * kBN;
  const float* Ab = A + b * sAb;
  const float* Bb = B + b * sBb;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = INFINITY;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int i = e / kBK, k = e % kBK;
      const int gi = m0 + i, gk = k0 + k;
      As[k][i] = (gi < M && gk < K) ? Ab[gi * sAm + gk] : INFINITY;
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int k = e / kBN, j = e % kBN;
      const int gk = k0 + k, gj = n0 + j;
      Bs[k][j] = (gk < K && gj < N) ? Bb[gk * sBk + gj] : INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fminf(acc[r][c], __fadd_rn(a[r], bv[c]));
    }
    __syncthreads();
  }

  float* Cb = C + b * sCb;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = m0 + ty + 16 * r;
    if (gi >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = n0 + tx + 16 * c;
      if (gj < N) Cb[gi * sCm + gj] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

int minplus_batched_f32(const float* A, const float* B, float* C, int batch,
                        int M, int K, int N, long long sAb, long long sAm,
                        long long sBb, long long sBk, long long sCb,
                        long long sCm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kSmall && K <= kSmall && N <= kSmall) {
    minplus_small_kernel<<<batch, dim3(kSmall, kSmallRows), 0, s>>>(
        A, B, C, M, K, N, sAb, sAm, sBb, sBk, sCb, sCm);
  } else {
    const int tiles_m = (M + kBM - 1) / kBM;
    const int tiles_n = (N + kBN - 1) / kBN;
    const long long blocks = static_cast<long long>(batch) * tiles_m * tiles_n;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    minplus_tiled_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        A, B, C, M, K, N, tiles_m, tiles_n, sAb, sAm, sBb, sBk, sCb, sCm);
  }
  return static_cast<int>(cudaGetLastError());
}

// W, D: contiguous [batch, V, V] float32, 1 <= V <= 32, steps >= 0.
int minplus_closure_f32(const float* W, float* D, int batch, int V,
                        int steps, void* stream) {
  if (batch < 1 || V < 1 || V > kSmall || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  minplus_closure_kernel<<<batch, dim3(kSmall, kSmallRows), 0,
                           static_cast<cudaStream_t>(stream)>>>(W, D, V,
                                                                steps);
  return static_cast<int>(cudaGetLastError());
}

const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
