// Flash-attention backward for Hopper (sm_90a): two kernels, dQ and dK/dV.
//
// With the forward's logsumexp L saved, P is recomputed tile by tile and
// never stored:
//
//   P[i, j]  = exp(scale * Q[i] . K[j] - L[i])       (0 where masked)
//   dS[i, j] = P[i, j] * (dO[i] . V[j] - delta[i]) * scale,
//   delta[i] = dO[i] . O[i]                          (computed by the caller)
//   dQ[i] = sum_j dS[i, j] K[j]
//   dK[j] = sum_i dS[i, j] Q[i],   dV[j] = sum_i P[i, j] dO[i]
//
// over keys j <= i (causal) or all keys; Q, K are [BH, S, D], V, dO are
// [BH, S, DV], float32 or bfloat16, D, DV <= 256 (D != DV allowed); L and
// delta are [BH, S] float32.  dQ, dK, dV are written in the input type.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   repro/kernels/flash.py:170  _flash_dq_kernel  (flash_bwd, :292; call :300)
//   repro/kernels/flash.py:211  _flash_dkv_kernel (flash_bwd, :292; call :320)
// The reference's split is kept: one kernel reduces over key tiles (dQ),
// the other over query tiles (dK, dV), so no output is shared between
// blocks, nothing is added with atomics, and the gradients are the same
// bits from run to run.  Unlike the reference, which tiles S by
// min(512, S) and never writes the rows past (S // 512) * 512, every
// S >= 1 is exact here: ragged query rows and key columns of the last
// tiles are masked.
//
// What bounds it on this card.  At the training path's shape (smollm-135m,
// [36, 2048, 64] bf16 per layer, causal: 7.553e7 (query, key) pairs) the
// dQ kernel does three products per pair (Q K^T, dO V^T, dS K: 384 FLOP),
// 2.90e10 FLOP, 29.3 us at the 989 TFLOP/s bf16 tensor-core peak, against
// ~47 MB of Q, K, V, dO, L, delta and dQ (~14 us at 3.35 TB/s); the dK/dV
// kernel does four (Q K^T, dO V^T, P^T dO, dS^T Q: 512 FLOP), 3.87e10 FLOP,
// 39.1 us, against ~57 MB (~17 us).  Both are bound by operations, on the
// tensor cores.
//
// What the design does about it, and what it does not.  These first
// kernels are simple and right: every product runs on the CUDA cores in
// float32 (67 TFLOP/s peak, so at least ~430 us and ~580 us at that
// shape), not on the tensor cores.  The reference's (bh, nq, nk) grid with
// its sequential innermost axis becomes a loop inside the block, as in
// flash_fwd.cu:
//   * dQ: one block of 256 threads owns one (bh, BR-row query tile) and
//     walks the BR-key tiles up to the causal limit, dQ accumulated in
//     float32 registers (thread (ty, tx) owns rows ty + 16 i, columns
//     tx + 16 j).  Query tiles are issued heaviest first.
//   * dK/dV: one block owns one (bh, BR-key tile) and walks the query
//     tiles from the diagonal tile to the end, dK and dV accumulated in
//     float32 registers.  Key tiles are issued heaviest (first) first.
// Every operand tile is staged through shared memory as float32 (rows
// padded to a multiple of 4 and read as float4); P and dS of the current
// tile pair go through shared memory once, so P is never rounded to the
// input type.  BR is 64, or 32 when D or DV exceeds 128: four float32
// tiles of 64 rows of 256 columns would need 266 KB, beyond the 227 KB a
// block may have, and halving the rows keeps every operand in float32.
// Not done here, and left for a later change: wgmma on the tensor cores,
// TMA loads with a multi-stage pipeline, GQA without the materialised K/V
// repeat, and delta folded into the dQ kernel.
//
// Numerics: expf is the accurate library function (no --use_fast_math);
// the mask is the reference's -1e30 (exp(-1e30 - L) = 0, written here as
// 0); FMA contraction is allowed, because the kernels are held to a
// tolerance against their plain version, not to bit equality.
//
// Plain C interface (bound with ctypes): flash_bwd_dq and flash_bwd_dkv
// return cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may opt into

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int pad4(int d) { return ((d + 3) / 4) * 4; }
__host__ __device__ constexpr int row_stride(int d) {
  return pad4(d) + 4;  // float4-aligned rows, no bank conflicts
}

// Shared floats of either kernel at BR rows: four operand tiles (Q, K at
// row_stride(D); V, dO at row_stride(DV)), `ntiles` [BR, BR + 1] tiles of
// P / dS, and L and delta of the query tile.
__host__ __device__ constexpr size_t smem_floats(int br, int d, int dv,
                                                 int ntiles) {
  return 2 * static_cast<size_t>(br) * (row_stride(d) + row_stride(dv)) +
         static_cast<size_t>(ntiles) * br * (br + 1) + 2 * br;
}

// Stage rows [r0, r0 + BR) of a [S, width] operand into a float32 tile
// with row stride ld; rows past S and columns past width are zero.
template <typename T, int BR>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, int width, int ld) {
  const int wpad = pad4(width);
  for (int e = threadIdx.x; e < BR * wpad; e += kThreads) {
    const int r = e / wpad, c = e - r * wpad;
    const int g = r0 + r;
    dst[r * ld + c] =
        (g < S && c < width)
            ? to_f32(src[static_cast<long long>(g) * width + c])
            : 0.f;
  }
}

// acc[i][j] += A[ty + 16 i] . B[tx + 16 j] over `len` (a multiple of 4)
// columns of two float32 tiles with row stride ld.
template <int RI>
__device__ __forceinline__ void tile_dot(float (&acc)[RI][RI], const float* A,
                                         const float* B, int len, int ld,
                                         int ty, int tx) {
  for (int c = 0; c < len; c += 4) {
    float4 a[RI], b[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * ld + c]);
#pragma unroll
    for (int j = 0; j < RI; ++j)
      b[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * ld + c]);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// P and dS of the tile pair (query rows q0 + ty + 16 i, keys k0 + tx + 16 j)
// from the scores s = Q.K and dp = dO.V of that pair.
template <int RI>
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[RI][RI], float (&dp)[RI][RI], const float* lse_s,
    const float* delta_s, int q0, int k0, int S, float scale, int causal,
    int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool masked = qpos >= S || kpos >= S || (causal && kpos > qpos);
      const float p = masked ? 0.f : expf(s[i][j] * scale - lse_s[r]);
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]) * scale;
    }
  }
}

// dQ: one block per (bh, BR-row query tile); NJ * 16 >= D.
template <typename T, int BR, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                    const T* __restrict__ V, const T* __restrict__ dO,
                    const float* __restrict__ LSE,
                    const float* __restrict__ DELTA, T* __restrict__ dQ,
                    int S, int D, int DV, float scale, int causal) {
  constexpr int RI = BR / 16;
  constexpr int ldp = BR + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = row_stride(D), ldv = row_stride(DV);
  float* Qs = smem;                 // [BR][ldk]
  float* Ks = Qs + BR * ldk;        // [BR][ldk]
  float* dOs = Ks + BR * ldk;       // [BR][ldv]
  float* Vs = dOs + BR * ldv;       // [BR][ldv]
  float* dSs = Vs + BR * ldv;       // [BR][ldp]
  float* lse_s = dSs + BR * ldp;    // [BR]
  float* delta_s = lse_s + BR;      // [BR]

  const long long bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * BR;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* Kb = K + bh * S * D;
  const T* Vb = V + bh * S * DV;

  load_tile<T, BR>(Qs, Q + bh * S * D, q0, S, D, ldk);
  load_tile<T, BR>(dOs, dO + bh * S * DV, q0, S, DV, ldv);
  if (tid < BR) {
    const int g = q0 + tid;
    lse_s[tid] = g < S ? LSE[bh * S + g] : 0.f;
    delta_s[tid] = g < S ? DELTA[bh * S + g] : 0.f;
  }

  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int nk = (S + BR - 1) / BR;
  // causal: key tile kt overlaps query tile qt iff kt * BR <= q0 + BR - 1,
  // i.e. kt <= qt (query and key tiles have the same BR rows)
  if (causal && nk > qt + 1) nk = qt + 1;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();  // the previous tile's readers of Ks, Vs, dSs are done
    load_tile<T, BR>(Ks, Kb, k0, S, D, ldk);
    load_tile<T, BR>(Vs, Vb, k0, S, DV, ldv);
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<RI>(s, Qs, Ks, pad4(D), ldk, ty, tx);
    tile_dot<RI>(dp, dOs, Vs, pad4(DV), ldv, ty, tx);
    probs_and_dscores<RI>(s, dp, lse_s, delta_s, q0, k0, S, scale, causal,
                          ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j)
        dSs[(ty + 16 * i) * ldp + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ[r] += sum_c dS[r][c] K[c]
    for (int c = 0; c < BR; ++c) {
      float ds[RI], kv[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dSs[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        kv[j] = col < D ? Ks[c * ldk + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  T* dQb = dQ + bh * S * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int g = q0 + ty + 16 * i;
    if (g >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) store(&dQb[static_cast<long long>(g) * D + col], acc[i][j]);
    }
  }
}

// dK, dV: one block per (bh, BR-key tile); NJK * 16 >= D, NJV * 16 >= DV.
template <typename T, int BR, int NJK, int NJV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                     const T* __restrict__ V, const T* __restrict__ dO,
                     const float* __restrict__ LSE,
                     const float* __restrict__ DELTA, T* __restrict__ dK,
                     T* __restrict__ dV, int S, int D, int DV, float scale,
                     int causal) {
  constexpr int RI = BR / 16;
  constexpr int ldp = BR + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = row_stride(D), ldv = row_stride(DV);
  float* Qs = smem;                 // [BR][ldk]
  float* Ks = Qs + BR * ldk;        // [BR][ldk]
  float* dOs = Ks + BR * ldk;       // [BR][ldv]
  float* Vs = dOs + BR * ldv;       // [BR][ldv]
  float* Ps = Vs + BR * ldv;        // [BR][ldp]: P[query row][key]
  float* dSs = Ps + BR * ldp;       // [BR][ldp]: dS[query row][key]
  float* lse_s = dSs + BR * ldp;    // [BR]
  float* delta_s = lse_s + BR;      // [BR]

  const long long bh = blockIdx.x;
  const int kt = blockIdx.y;        // heaviest causal tiles (kt = 0) first
  const int k0 = kt * BR;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* Qb = Q + bh * S * D;
  const T* dOb = dO + bh * S * DV;

  load_tile<T, BR>(Ks, K + bh * S * D, k0, S, D, ldk);
  load_tile<T, BR>(Vs, V + bh * S * DV, k0, S, DV, ldv);

  float acc_k[RI][NJK], acc_v[RI][NJV];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < NJK; ++j) acc_k[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NJV; ++j) acc_v[i][j] = 0.f;
  }

  const int nq = (S + BR - 1) / BR;
  // causal: query tile qt overlaps key tile kt iff kt <= qt
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * BR;
    __syncthreads();  // the previous tile's readers of Qs, dOs, Ps are done
    load_tile<T, BR>(Qs, Qb, q0, S, D, ldk);
    load_tile<T, BR>(dOs, dOb, q0, S, DV, ldv);
    if (tid < BR) {
      const int g = q0 + tid;
      lse_s[tid] = g < S ? LSE[bh * S + g] : 0.f;
      delta_s[tid] = g < S ? DELTA[bh * S + g] : 0.f;
    }
    __syncthreads();

    // thread (ty, tx): query rows ty + 16 i, keys tx + 16 j of the pair
    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<RI>(s, Qs, Ks, pad4(D), ldk, ty, tx);
    tile_dot<RI>(dp, dOs, Vs, pad4(DV), ldv, ty, tx);
    probs_and_dscores<RI>(s, dp, lse_s, delta_s, q0, k0, S, scale, causal,
                          ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = s[i][j];
        dSs[(ty + 16 * i) * ldp + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // thread (ty, tx) now owns keys ty + 16 i and columns tx + 16 j:
    // dV[key] += sum_r P[r][key] dO[r],  dK[key] += sum_r dS[r][key] Q[r]
    for (int r = 0; r < BR; ++r) {
      float p[RI], ds[RI], dov[NJV], qv[NJK];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        p[i] = Ps[r * ldp + ty + 16 * i];
        ds[i] = dSs[r * ldp + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJV; ++j) {
        const int col = tx + 16 * j;
        dov[j] = col < DV ? dOs[r * ldv + col] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NJK; ++j) {
        const int col = tx + 16 * j;
        qv[j] = col < D ? Qs[r * ldk + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < NJV; ++j)
          acc_v[i][j] = fmaf(p[i], dov[j], acc_v[i][j]);
#pragma unroll
        for (int j = 0; j < NJK; ++j)
          acc_k[i][j] = fmaf(ds[i], qv[j], acc_k[i][j]);
      }
    }
  }

  T* dKb = dK + bh * S * D;
  T* dVb = dV + bh * S * DV;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int g = k0 + ty + 16 * i;
    if (g >= S) continue;
#pragma unroll
    for (int j = 0; j < NJK; ++j) {
      const int col = tx + 16 * j;
      if (col < D) store(&dKb[static_cast<long long>(g) * D + col],
                         acc_k[i][j]);
    }
#pragma unroll
    for (int j = 0; j < NJV; ++j) {
      const int col = tx + 16 * j;
      if (col < DV) store(&dVb[static_cast<long long>(g) * DV + col],
                          acc_v[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, s, d, dv_dim;
  float scale;
  int causal;
  cudaStream_t stream;
};

// Opt the kernel into `bytes` of dynamic shared memory and check the grid.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes, int tiles) {
  if (bytes > static_cast<size_t>(kMaxSmem) || tiles > 65535)
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int BR, int NJ>
cudaError_t launch_dq(const Args& a) {
  const size_t bytes = smem_floats(BR, a.d, a.dv_dim, 1) * sizeof(float);
  const dim3 grid(a.bh, (a.s + BR - 1) / BR);
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, BR, NJ>, bytes, grid.y);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, BR, NJ><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.s, a.d, a.dv_dim, a.scale, a.causal);
  return cudaGetLastError();
}

// BR = 64, or 32 when D or DV exceeds 128 (NJK or NJV is 16; see the
// header).
template <typename T, int NJK, int NJV>
cudaError_t launch_dkv(const Args& a) {
  constexpr int BR = (NJK > 8 || NJV > 8) ? 32 : 64;
  const size_t bytes = smem_floats(BR, a.d, a.dv_dim, 2) * sizeof(float);
  const dim3 grid(a.bh, (a.s + BR - 1) / BR);
  cudaError_t err =
      prepare(flash_bwd_dkv_kernel<T, BR, NJK, NJV>, bytes, grid.y);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, BR, NJK, NJV><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s, a.d,
      a.dv_dim, a.scale, a.causal);
  return cudaGetLastError();
}

// Column blocks: NJ = 4, 8 or 16 (16 NJ >= width).  Rows: BR = 64, or 32
// when D or DV exceeds 128 (see the header).
template <typename T>
cudaError_t dispatch_dq(const Args& a) {
  const bool wide = a.d > 128 || a.dv_dim > 128;
  if (a.d <= 64)
    return wide ? launch_dq<T, 32, 4>(a) : launch_dq<T, 64, 4>(a);
  if (a.d <= 128)
    return wide ? launch_dq<T, 32, 8>(a) : launch_dq<T, 64, 8>(a);
  return launch_dq<T, 32, 16>(a);
}

template <typename T, int NJK>
cudaError_t dispatch_dkv_v(const Args& a) {
  if (a.dv_dim <= 64) return launch_dkv<T, NJK, 4>(a);
  if (a.dv_dim <= 128) return launch_dkv<T, NJK, 8>(a);
  return launch_dkv<T, NJK, 16>(a);
}

template <typename T>
cudaError_t dispatch_dkv(const Args& a) {
  if (a.d <= 64) return dispatch_dkv_v<T, 4>(a);
  if (a.d <= 128) return dispatch_dkv_v<T, 8>(a);
  return dispatch_dkv_v<T, 16>(a);
}

bool valid(int dtype, int bh, int s, int d, int dv) {
  return bh >= 1 && s >= 1 && d >= 1 && d <= 256 && dv >= 1 && dv <= 256 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int dtype, int bh, int s, int d, int dv,
                 float scale, int causal, void* stream) {
  if (!valid(dtype, bh, s, d, dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, s, d, dv,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dtype == 0 ? dispatch_dq<float>(a)
                                     : dispatch_dq<__nv_bfloat16>(a));
}

int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv_out, int dtype, int bh, int s, int d,
                  int dv, float scale, int causal, void* stream) {
  if (!valid(dtype, bh, s, d, dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv_out, bh, s, d, dv,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dtype == 0 ? dispatch_dkv<float>(a)
                                     : dispatch_dkv<__nv_bfloat16>(a));
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
