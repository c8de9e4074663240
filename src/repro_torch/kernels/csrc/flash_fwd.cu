// Flash-attention forward (online softmax) for Hopper (sm_90a).
//
//   O[b, i]   = sum_j softmax_j(scale * Q[b, i] . K[b, j]) V[b, j]
//   LSE[b, i] = log sum_j exp(scale * Q[b, i] . K[b, j])
//
// over keys j <= i (causal) or all keys; Q, K are [BH, S, D] and V is
// [BH, S, DV], float32 or bfloat16, D, DV <= 256 (D != DV allowed).  O is
// written in the input type, LSE in float32, or not at all when the LSE
// pointer is null.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   repro/kernels/flash.py:125  _flash_fwd_lse_kernel (flash_fwd_lse, :259)
//   repro/kernels/flash.py:35   _flash_kernel (flash_attention_bhsd, :85)
//                               -- the same kernel with a null LSE pointer.
// Unlike the reference, which tiles S by min(512, S) and never writes the
// rows past (S // bq) * bq, every S >= 1 is exact here: the ragged query
// rows and key columns of the last tiles are masked.
//
// What bounds it on this card.  At the main path's shape (smollm-135m
// prefill, [36, 2048, 64] bf16 per layer) the causal work is
// 2 * BH * S^2 * D = 1.93e10 FLOP, 19.5 us at the 989 TFLOP/s bf16
// tensor-core peak, against 38 MB of Q, K, V, O and LSE, 11.3 us at
// 3.35 TB/s: the bound is set by operations, on the tensor cores.
//
// What the design does about it, and what it does not.  This first kernel
// is simple and right: the products run on the CUDA cores in float32
// (67 TFLOP/s peak, so at least ~288 us at that shape), not on the tensor
// cores.  One block of 256 threads owns one (bh, 64-row query tile); a
// loop inside the block walks the 64-key tiles of K and V up to the causal
// limit (the reference's k_start <= q_start + bq - 1), so fully masked
// tiles are never loaded -- half the work of a dense pass.  Q, K and V are
// staged through shared memory as float32 (D padded to a multiple of 4 and
// read as float4); each thread keeps a 4 x 4 block of the score tile and a
// 4 x (DV / 16) block of the output accumulator in registers.  The running
// max, sum and rescale factor of the online softmax are float32 in shared
// memory; P is never rounded to the input type.  Tiles of query rows are
// issued heaviest first so the causal tail does not straggle.  Not done
// here, and left for a later change: wgmma on the tensor cores, TMA loads
// with a multi-stage pipeline, and GQA without the materialised K/V repeat.
//
// Numerics: expf/logf are the accurate library functions (no
// --use_fast_math); FMA contraction is allowed in this kernel, because it
// is held to a tolerance against its plain version, not to bit equality.
//
// Plain C interface (bound with ctypes): flash_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per inner tile (== kBQ: see nk below)
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kPs = kBK + 1;    // padded row of the score tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int qk_stride(int d) {
  return ((d + 3) / 4) * 4 + 4;  // float4-aligned rows, no bank conflicts
}

__host__ __device__ constexpr size_t smem_floats(int d, int dv) {
  return static_cast<size_t>(kBQ + kBK) * qk_stride(d) +
         static_cast<size_t>(kBK) * dv + static_cast<size_t>(kBQ) * kPs +
         3 * kBQ;
}

// Thread (ty, tx) owns rows ty + 16 i (i < 4) and columns tx + 16 j
// (j < NJ, so DV <= 16 * NJ) of the [64, DV] output tile.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, T* __restrict__ O,
                 float* __restrict__ LSE, int S, int D, int DV, float scale,
                 int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = qk_stride(D);
  float* Qs = smem;                  // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;         // [kBK][ld]
  float* Vs = Ks + kBK * ld;         // [kBK][DV]
  float* Ps = Vs + kBK * DV;         // [kBQ][kPs]: scores, then P
  float* m_s = Ps + kBQ * kPs;       // [kBQ] running max
  float* l_s = m_s + kBQ;            // [kBQ] running sum
  float* a_s = l_s + kBQ;            // [kBQ] this tile's rescale factor

  const long long bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int dpad = ((D + 3) / 4) * 4;
  const T* Qb = Q + bh * S * D;
  const T* Kb = K + bh * S * D;
  const T* Vb = V + bh * S * DV;

  for (int e = tid; e < kBQ * dpad; e += kThreads) {
    const int r = e / dpad, c = e - r * dpad;
    const int g = q0 + r;
    Qs[r * ld + c] =
        (g < S && c < D) ? to_f32(Qb[static_cast<long long>(g) * D + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int nk = (S + kBK - 1) / kBK;
  // causal: key tile kt overlaps the query tile iff kt * kBK <= q0 + kBQ - 1,
  // i.e. kt <= qt since kBK == kBQ
  if (causal && nk > qt + 1) nk = qt + 1;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    for (int e = tid; e < kBK * dpad; e += kThreads) {
      const int r = e / dpad, c = e - r * dpad;
      const int g = k0 + r;
      Ks[r * ld + c] = (g < S && c < D)
                           ? to_f32(Kb[static_cast<long long>(g) * D + c])
                           : 0.f;
    }
    for (int e = tid; e < kBK * DV; e += kThreads) {
      const int r = e / DV, c = e - r * DV;
      const int g = k0 + r;
      Vs[e] = g < S ? to_f32(Vb[static_cast<long long>(g) * DV + c]) : 0.f;
    }
    __syncthreads();

    // scores: s[i][j] = Q[ty + 16 i] . K[tx + 16 j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < dpad; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * ld + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * ld + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool masked = kpos >= S || (causal && kpos > q0 + r);
        Ps[r * kPs + c] = masked ? kNegInf : s[i][j] * scale;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 columns each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = Ps + r * kPs;
      float mx = kNegInf;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBK; ++c) {
      float p[4], v[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPs + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        v[j] = col < DV ? Vs[c * DV + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* Ob = O + bh * S * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, g = q0 + r;
    if (g >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < DV) store(&Ob[static_cast<long long>(g) * DV + col],
                          acc[i][j] / l);
    }
  }
  if (LSE != nullptr && tid < kBQ && q0 + tid < S)
    LSE[bh * S + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int s, int d, int dv, float scale,
                   int causal, cudaStream_t stream) {
  const size_t bytes = smem_floats(d, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s, d, dv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int s, int d, int dv, float scale,
                     int causal, cudaStream_t stream) {
  if (dv <= 64)
    return launch<T, 4>(q, k, v, o, lse, bh, s, d, dv, scale, causal, stream);
  if (dv <= 128)
    return launch<T, 8>(q, k, v, o, lse, bh, s, d, dv, scale, causal, stream);
  return launch<T, 16>(q, k, v, o, lse, bh, s, d, dv, scale, causal, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  lse may be null (no LSE output).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              float* lse, int dtype, int bh, int s, int d, int dv,
              float scale, int causal, void* stream) {
  if (bh < 1 || s < 1 || d < 1 || d > 256 || dv < 1 || dv > 256 ||
      (s + kBQ - 1) / kBQ > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, o, lse, bh, s, d, dv, scale, causal, st)
          : dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, s, d, dv, scale,
                                    causal, st);
  return static_cast<int>(err);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
