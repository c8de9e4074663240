// Flash-attention forward on Hopper's tensor cores (sm_90a): bf16, D = DV
// in {64, 128}.
//
//   O[b, i]   = sum_j softmax_j(scale * Q[b, i] . K[b, j]) V[b, j]
//   LSE[b, i] = log sum_j exp(scale * Q[b, i] . K[b, j])
//
// over keys j <= i (causal) or all keys; Q, K, V are [BH, S, D] bf16.  O is
// written in bf16, LSE in float32, or not at all when the LSE pointer is
// null.  Every other dtype and head width takes flash_fwd.cu's kernel; the
// wrapper (kernels/flash.py:kernel_variant) chooses by dtype and shape alone.
//
// Replaces the Pallas TPU kernels of the JAX package, as flash_fwd.cu does:
//   repro/kernels/flash.py:125  _flash_fwd_lse_kernel (flash_fwd_lse, :259)
//   repro/kernels/flash.py:35   _flash_kernel (flash_attention_bhsd, :85)
//                               -- the same kernel with a null LSE pointer.
// Every S >= 1 is exact, as in flash_fwd.cu: the ragged query rows and key
// columns of the last tiles are masked.
//
// What bounds it on this card.  At the main path's shape (smollm-135m,
// [36, 2048, 64] bf16 per layer, causal) the work is 2 * BH * pairs *
// (D + DV) = 1.93e10 FLOP, 19.5 us at the 989 TFLOP/s bf16 tensor-core
// peak, against 38 MB of Q, K, V, O and LSE, 11.3 us at 3.35 TB/s: it is
// bound by operations, on the tensor cores.
//
// What the design does about it.  Both products run on the tensor cores
// with wgmma, and the tiles arrive by TMA (sm90.cuh):
//   * one block of 288 threads owns one (bh, 128-row query tile): two
//     consumer warpgroups of 64 rows each and one producer warp.  Query
//     tiles are issued heaviest first.
//   * the producer loads the Q tile once, then streams tiles of K and V
//     (128 keys at D = 64, 64 at D = 128) into a two-stage ring guarded by
//     full / empty mbarriers, up to the causal limit; the loads of tile
//     j + 1 run under the products of tile j.  The 3-D tensor maps
//     (D, S, BH) zero-fill rows past S.
//   * S = Q K^T is an SS wgmma (Q and K both K-major in shared memory) into
//     float32 registers; the online softmax runs on those registers (row max
//     and sum reduced across the four threads that hold a row, the scale
//     folded into exp2f with log2(e)); masked scores are -inf.
//   * O += P V is an RS wgmma: P is rounded to bf16 once into A registers
//     (the accumulator layout is the A layout) and V is read MN-major (B's
//     transpose bit).  The running sum l adds the float32 P, so the LSE does
//     not see the rounding; rounding P moves O by far less than the bf16
//     gate (PERF.md).
//   * the epilogue stores O / l in bf16 straight from registers, and
//     LSE = m + log(l) when its pointer is non-null.
// Not done here: a persistent grid and GQA without the materialised K/V
// repeat.  Overlapping one tile's softmax with the next tile's products
// inside a warpgroup (two products in flight, waited one at a time) was
// slower than this plain order on the H100, at D = 64 and 128 (PERF.md).
//
// Numerics: scores, the softmax and O accumulate in float32; P is rounded
// to bf16 once before P V; exp2f and logf are the library functions (no
// --use_fast_math).  Held to the plain version by a tolerance.
//
// Plain C interface (bound with ctypes): flash_fwd_sm90 and
// flash_sm90_probe return 0, a cudaError_t after the launch, or an
// sm90::kErr* code (see flash_sm90_error_string).

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 128;         // query rows per block (2 x 64)
// Keys per tile: 128 at D = 64 (fewer, larger products and barrier round
// trips; faster than 64 keys on the H100); 64 at D = 128, where a 128-key
// S accumulator beside the 128-column O accumulator spills and is slower.
template <int D>
constexpr int kKeyTile = D == 64 ? 128 : 64;
constexpr int kStages = 2;       // K/V ring
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared bytes: Q [kBQ, D], then kStages x (K [kBK, D], V [kBK, D]), each in
// 64-column blocks of 128-byte rows (kBK = kKeyTile<D>).
template <int D>
struct Layout {
  static constexpr int kBK = kKeyTile<D>;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKBytes = kBK * D * 2;
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr int kBytes = kQBytes + kStages * kStageBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ O, float* __restrict__ LSE,
                      int S, float scale_log2, int causal) {
  using L = Layout<D>;
  constexpr int kBK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_full[kStages], bar_empty[kStages];
  uint8_t* q_s = sm90::align_1024(smem_raw);
  uint8_t* kv_s = q_s + L::kQBytes;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  int nk = (S + kBK - 1) / kBK;
  if (causal && nk > (q0 + kBQ) / kBK) nk = (q0 + kBQ) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&bar_full[s], 1);
      sm90::mbar_init(&bar_empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: one lane issues TMA
    if (lane == 0) {
      sm90::mbar_expect_tx(&bar_q, L::kQBytes);
      for (int c = 0; c < D / 64; ++c)
        sm90::tma_load_3d(q_s + c * kBQ * 128, &tm_q, &bar_q, 64 * c, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        sm90::mbar_wait(&bar_empty[s], ((j / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&bar_full[s], L::kStageBytes);
        uint8_t* k_s = kv_s + s * L::kStageBytes;
        uint8_t* v_s = k_s + L::kKBytes;
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_3d(k_s + c * kBK * 128, &tm_k, &bar_full[s], 64 * c,
                            j * kBK, bh);
          sm90::tma_load_3d(v_s + c * kBK * 128, &tm_v, &bar_full[s], 64 * c,
                            j * kBK, bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg owns query rows q0 + 64 wg .. + 63; thread t holds
  // rows row0 and row0 + 8 and, in each 8-column block, columns col + {0, 1}.
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int qw0 = q0 + 64 * wg;
  const int row0 = qw0 + 16 * (t / 32) + (t % 32) / 4;
  const int col = 2 * (t % 4);
  // causal: this warpgroup's last key is qw0 + 63, in tile (qw0 + 63) / kBK
  const int nk_wg = causal ? min(nk, (qw0 + 63) / kBK + 1) : nk;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  sm90::mbar_wait(&bar_q, 0);
  for (int j = 0; j < nk; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&bar_full[s], (j / kStages) & 1);
    const uint8_t* k_s = kv_s + s * L::kStageBytes;
    const uint8_t* v_s = k_s + L::kKBytes;
    if (j < nk_wg) {
      // S = Q K^T: [64 rows, kBK keys]
      float sc[kBK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int blk = kk / 4, off = (kk % 4) * 32;
        sm90::wgmma_ss<kBK, 0>(
            sc,
            sm90::desc_sw128(q_s + blk * kBQ * 128 + wg * 64 * 128 + off, 16,
                             1024),
            sm90::desc_sw128(k_s + blk * kBK * 128 + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // scale into log2 units, mask, online softmax on the registers
      const int k0 = j * kBK;
      const bool ragged =
          k0 + kBK > S || (causal && k0 + kBK - 1 > qw0);
      float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * jj + 2 * i + c;
            const int key = k0 + 8 * jj + col + c;
            float x = sc[idx] * scale_log2;
            if (ragged && (key >= S || (causal && key > row))) x = -INFINITY;
            sc[idx] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);  // finite: key 0 is in tile 0
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * jj + 2 * i + c;
            const float p = exp2f(sc[idx] - m_new);
            sc[idx] = p;
            rowsum[i] += p;
          }
        l[i] = l[i] * alpha[i] + rowsum[i];  // float32 P, before rounding
      }
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * jj + 2 * i] *= alpha[i];
          o[4 * jj + 2 * i + 1] *= alpha[i];
        }

      // O += bf16(P) V: V [kBK keys, D] read MN-major
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) sm90::acc_to_a(sc, kk, pa[kk]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        sm90::wgmma_rs<D, 1>(
            o, pa[kk], sm90::desc_sw128(v_s + kk * 16 * 128, kBK * 128, 1024),
            1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) sm90::fence_regs(pa[kk]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bar_empty[s]);
  }

  __nv_bfloat16* Ob = O + static_cast<long long>(bh) * S * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int row = row0 + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(
          &Ob[static_cast<long long>(row) * D + 8 * jj + col]) =
          __floats2bfloat162_rn(o[4 * jj + 2 * i] / lt,
                                o[4 * jj + 2 * i + 1] / lt);
    if (LSE != nullptr && t % 4 == 0)
      LSE[static_cast<long long>(bh) * S + row] = m[i] * kLn2 + logf(lt);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int s, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = sm90::encode_bf16_3d(&tm_q, q, bh, s, D, kBQ);
  if (!err) err = sm90::encode_bf16_3d(&tm_k, k, bh, s, D, kKeyTile<D>);
  if (!err) err = sm90::encode_bf16_3d(&tm_v, v, bh, s, D, kKeyTile<D>);
  if (err) return err;
  const int bytes = Layout<D>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, s,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// The tile products alone, for the card's tests: one warpgroup computes
// S = A B^T (SS, both K-major) for A, B [64, D] and O = bf16(S) C (RS, C
// [64, D] MN-major), and writes S [64, 64] and O [64, D] in float32.
template <int D>
__global__ void __launch_bounds__(128)
sm90_probe_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_c,
                  float* __restrict__ s_out, float* __restrict__ o_out) {
  constexpr int kTile = 64 * D * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar;
  uint8_t* a_s = sm90::align_1024(smem_raw);
  uint8_t* b_s = a_s + kTile;
  uint8_t* c_s = b_s + kTile;
  const int t = threadIdx.x;
  if (t == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    sm90::mbar_expect_tx(&bar, 3 * kTile);
    for (int c = 0; c < D / 64; ++c) {
      sm90::tma_load_3d(a_s + c * 64 * 128, &tm_a, &bar, 64 * c, 0, 0);
      sm90::tma_load_3d(b_s + c * 64 * 128, &tm_b, &bar, 64 * c, 0, 0);
      sm90::tma_load_3d(c_s + c * 64 * 128, &tm_c, &bar, 64 * c, 0, 0);
    }
  }
  sm90::mbar_wait(&bar, 0);

  float sc[32], o[D / 2];
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
    sm90::wgmma_ss<64, 0>(sc, sm90::desc_sw128(a_s + off, 16, 1024),
                          sm90::desc_sw128(b_s + off, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a(sc, kk, pa[kk]);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<D, 1>(
        o, pa[kk], sm90::desc_sw128(c_s + kk * 16 * 128, 64 * 128, 1024), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]);

  const int row0 = 16 * (t / 32) + (t % 32) / 4, col = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        s_out[row * 64 + 8 * jj + col + c] = sc[4 * jj + 2 * i + c];
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        o_out[row * D + 8 * jj + col + c] = o[4 * jj + 2 * i + c];
  }
}

template <int D>
int launch_probe(const void* a, const void* b, const void* c, float* s_out,
                 float* o_out, cudaStream_t stream) {
  CUtensorMap tm_a, tm_b, tm_c;
  int err = sm90::encode_bf16_3d(&tm_a, a, 1, 64, D, 64);
  if (!err) err = sm90::encode_bf16_3d(&tm_b, b, 1, 64, D, 64);
  if (!err) err = sm90::encode_bf16_3d(&tm_c, c, 1, 64, D, 64);
  if (err) return err;
  const int bytes = 3 * 64 * D * 2 + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      sm90_probe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  sm90_probe_kernel<D><<<1, 128, bytes, stream>>>(tm_a, tm_b, tm_c, s_out,
                                                  o_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: [bh, s, d] bf16, contiguous, 16-byte aligned; d is 64 or 128.
// lse may be null (no LSE output).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int s, int d, float scale, int causal,
                   void* stream) {
  if (bh < 1 || s < 1 || (s + kBQ - 1) / kBQ > 65535 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(q, k, v, o, lse, bh, s, scale, causal, st)
                 : launch<128>(q, k, v, o, lse, bh, s, scale, causal, st);
}

// a, b, c: [64, d] bf16; s_out [64, 64] and o_out [64, d] float32.
int flash_sm90_probe(const void* a, const void* b, const void* c,
                     float* s_out, float* o_out, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_probe<64>(a, b, c, s_out, o_out, st);
  if (d == 128) return launch_probe<128>(a, b, c, s_out, o_out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_sm90_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
