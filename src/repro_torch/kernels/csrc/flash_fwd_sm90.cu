// Flash-attention forward on Hopper's tensor cores (sm_90a): bf16, head
// widths (D, DV) in {(64, 64), (128, 128), (96, 96), (192, 128)}.
//
//   O[b, i]   = sum_j softmax_j(scale * Q[b, i] . K[b, j]) V[b, j]
//   LSE[b, i] = log sum_j exp(scale * Q[b, i] . K[b, j])
//
// over keys j <= i (causal) or all keys; Q, K are [BH, S, D] and V [BH, S,
// DV] bf16.  O [BH, S, DV] is written in bf16, LSE in float32, or not at
// all when the LSE pointer is null.  Every other dtype and head width takes
// flash_fwd.cu's kernel; the wrapper (kernels/flash.py:kernel_variant)
// chooses by dtype and shape alone.
//
// Replaces the Pallas TPU kernels of the JAX package, as flash_fwd.cu does:
//   repro/kernels/flash.py:125  _flash_fwd_lse_kernel (flash_fwd_lse, :259)
//   repro/kernels/flash.py:35   _flash_kernel (flash_attention_bhsd, :85)
//                               -- the same kernel with a null LSE pointer.
// Every S >= 1 is exact, as in flash_fwd.cu: the ragged query rows and key
// columns of the last tiles are masked.
//
// What bounds it on this card.  The work is 2 * BH * pairs * (D + DV)
// FLOP over the (causal) (query, key) pairs, against Q, K, V, O and LSE
// read or written once; at 989 TFLOP/s bf16 and 3.35 TB/s every path
// shape is bound by operations, on the tensor cores:
//   smollm-135m [36, 2048, 64]:          1.93e10 FLOP, 19.5 us (38 MB, 11.3)
//   olmoe-1b-7b [64, 2048, 128]:         6.88e10 FLOP, 69.5 us
//   phi-3-vision [32, 2624, 96]:         4.23e10 FLOP, 42.8 us (65 MB, 19.3)
//   deepseek-v2 MLA [128, 2048, 192->128]: 1.72e11 FLOP, 173.8 us (337 MB,
//                                          100.5)
//
// What the design does about it.  Both products run on the tensor cores
// with wgmma, and the tiles arrive by TMA (sm90.cuh):
//   * one block of 288 threads owns one (bh, 128-row query tile): two
//     consumer warpgroups of 64 rows each and one producer warp.  Query
//     tiles are issued heaviest first.
//   * the producer loads the Q tile once, then streams tiles of K and V
//     (128 keys at D = DV = 64, 64 at the wider pairs) into a two-stage
//     ring guarded by full / empty mbarriers, up to the causal limit; the
//     loads of tile j + 1 run under the products of tile j.  The 3-D
//     tensor maps (D or DV, S, BH) zero-fill rows past S, and columns past
//     96 of a 96-wide tile's second 64-column block.
//   * S = Q K^T is an SS wgmma (Q and K both K-major in shared memory, D /
//     16 k-steps) into float32 registers; the online softmax runs on those
//     registers (row max and sum reduced across the four threads that hold
//     a row, the scale folded into exp2f with log2(e)); masked scores are
//     -inf.
//   * O += P V is an RS wgmma of N = DV (96 and 192 -> 128 included: one
//     instruction a k-step): P is rounded to bf16 once into A registers
//     (the accumulator layout is the A layout) and V is read MN-major (B's
//     transpose bit).  The running sum l adds the float32 P, so the LSE
//     does not see the rounding; rounding P moves O by far less than the
//     bf16 gate (PERF.md; tests/test_torch_flash.py:
//     rounded_p_forward_gate_share at every pair).
//   * the epilogue stores O / l in bf16 straight from registers, and
//     LSE = m + log(l) when its pointer is non-null.
// Registers a consumer thread: DV / 2 of O and kBK / 2 of S, so 64 + 32 at
// (128, 128) and (192, 128), 48 + 32 at (96, 96).  Shared memory: 96 KB at
// (96, 96) (Q 32 KB, two stages of K 16 + V 16), 129 KB at (192, 128) (Q
// 48 KB, two stages of K 24 + V 16).
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
// Keys per tile: 128 at D = DV = 64 (fewer, larger products and barrier
// round trips; faster than 64 keys on the H100); 64 at every wider pair,
// where a 128-key S accumulator beside an O accumulator of 48-64 columns
// a thread would crowd the registers (at D = 128 it spilled and was slower).
template <int D, int DV>
constexpr int kKeyTile = (D == 64 && DV == 64) ? 128 : 64;
constexpr int kStages = 2;       // K/V ring
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared bytes: Q [kBQ, D], then kStages x (K [kBK, D], V [kBK, DV]), each
// in 64-column blocks of 128-byte rows (kBK = kKeyTile<D, DV>).
template <int D, int DV>
struct Layout {
  static constexpr int kBK = kKeyTile<D, DV>;
  static constexpr int kQBytes = kBQ * 128 * sm90::col_blocks(D);
  static constexpr int kKBytes = kBK * 128 * sm90::col_blocks(D);
  static constexpr int kVBytes = kBK * 128 * sm90::col_blocks(DV);
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBytes = kQBytes + kStages * kStageBytes + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ O, float* __restrict__ LSE,
                      int S, float scale_log2, int causal) {
  using L = Layout<D, DV>;
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
      for (int c = 0; c < sm90::col_blocks(D); ++c)
        sm90::tma_load_3d(q_s + c * kBQ * 128, &tm_q, &bar_q, 64 * c, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        sm90::mbar_wait(&bar_empty[s], ((j / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&bar_full[s], L::kStageBytes);
        uint8_t* k_s = kv_s + s * L::kStageBytes;
        uint8_t* v_s = k_s + L::kKBytes;
        for (int c = 0; c < sm90::col_blocks(D); ++c)
          sm90::tma_load_3d(k_s + c * kBK * 128, &tm_k, &bar_full[s], 64 * c,
                            j * kBK, bh);
        for (int c = 0; c < sm90::col_blocks(DV); ++c)
          sm90::tma_load_3d(v_s + c * kBK * 128, &tm_v, &bar_full[s], 64 * c,
                            j * kBK, bh);
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

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  sm90::mbar_wait(&bar_q, 0);
  for (int j = 0; j < nk; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&bar_full[s], (j / kStages) & 1);
    const uint8_t* k_s = kv_s + s * L::kStageBytes;
    const uint8_t* v_s = k_s + L::kKBytes;
    if (j < nk_wg) {
      // S = Q K^T: [64 rows, kBK keys], D / 16 k-steps
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
      for (int jj = 0; jj < DV / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * jj + 2 * i] *= alpha[i];
          o[4 * jj + 2 * i + 1] *= alpha[i];
        }

      // O += bf16(P) V: V [kBK keys, DV] read MN-major, N = DV
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) sm90::acc_to_a(sc, kk, pa[kk]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        sm90::wgmma_rs<DV, 1>(
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

  __nv_bfloat16* Ob = O + static_cast<long long>(bh) * S * DV;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int row = row0 + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(
          &Ob[static_cast<long long>(row) * DV + 8 * jj + col]) =
          __floats2bfloat162_rn(o[4 * jj + 2 * i] / lt,
                                o[4 * jj + 2 * i + 1] / lt);
    if (LSE != nullptr && t % 4 == 0)
      LSE[static_cast<long long>(bh) * S + row] = m[i] * kLn2 + logf(lt);
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int s, float scale, int causal, cudaStream_t stream) {
  constexpr int kBK = kKeyTile<D, DV>;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = sm90::encode_bf16_3d(&tm_q, q, bh, s, D, kBQ);
  if (!err) err = sm90::encode_bf16_3d(&tm_k, k, bh, s, D, kBK);
  if (!err) err = sm90::encode_bf16_3d(&tm_v, v, bh, s, DV, kBK);
  if (err) return err;
  const int bytes = Layout<D, DV>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  flash_fwd_sm90_kernel<D, DV><<<grid, kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, s,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// The tile products alone, for the card's tests: one warpgroup computes
// S = A B^T (SS, both K-major, K-depth D) for A, B [64, D] and
// O = bf16(S) C (RS, C [64, N] MN-major), and writes S [64, 64] and
// O [64, N] in float32.  D and N take the kernels' widths, 96 and 192
// among them, with their tiles in whole 64-column blocks as the kernels
// lay them out.
template <int D, int N>
__global__ void __launch_bounds__(128)
sm90_probe_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_c,
                  float* __restrict__ s_out, float* __restrict__ o_out) {
  constexpr int kABytes = 64 * 128 * sm90::col_blocks(D);
  constexpr int kCBytes = 64 * 128 * sm90::col_blocks(N);
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar;
  uint8_t* a_s = sm90::align_1024(smem_raw);
  uint8_t* b_s = a_s + kABytes;
  uint8_t* c_s = b_s + kABytes;
  const int t = threadIdx.x;
  if (t == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    sm90::mbar_expect_tx(&bar, 2 * kABytes + kCBytes);
    for (int c = 0; c < sm90::col_blocks(D); ++c) {
      sm90::tma_load_3d(a_s + c * 64 * 128, &tm_a, &bar, 64 * c, 0, 0);
      sm90::tma_load_3d(b_s + c * 64 * 128, &tm_b, &bar, 64 * c, 0, 0);
    }
    for (int c = 0; c < sm90::col_blocks(N); ++c)
      sm90::tma_load_3d(c_s + c * 64 * 128, &tm_c, &bar, 64 * c, 0, 0);
  }
  sm90::mbar_wait(&bar, 0);

  float sc[32], o[N / 2];
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
  for (int i = 0; i < N / 2; ++i) o[i] = 0.f;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<N, 1>(
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
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        o_out[row * N + 8 * jj + col + c] = o[4 * jj + 2 * i + c];
  }
}

template <int D, int N>
int launch_probe(const void* a, const void* b, const void* c, float* s_out,
                 float* o_out, cudaStream_t stream) {
  CUtensorMap tm_a, tm_b, tm_c;
  int err = sm90::encode_bf16_3d(&tm_a, a, 1, 64, D, 64);
  if (!err) err = sm90::encode_bf16_3d(&tm_b, b, 1, 64, D, 64);
  if (!err) err = sm90::encode_bf16_3d(&tm_c, c, 1, 64, N, 64);
  if (err) return err;
  const int bytes =
      64 * 128 * (2 * sm90::col_blocks(D) + sm90::col_blocks(N)) + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      sm90_probe_kernel<D, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  sm90_probe_kernel<D, N><<<1, 128, bytes, stream>>>(tm_a, tm_b, tm_c,
                                                     s_out, o_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k: [bh, s, d] and v, o: [bh, s, dv] bf16, contiguous, 16-byte aligned;
// (d, dv) is (64, 64), (128, 128), (96, 96) or (192, 128).  lse may be
// null (no LSE output).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int s, int d, int dv, float scale,
                   int causal, void* stream) {
  if (bh < 1 || s < 1 || (s + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64 && dv == 64)
    return launch<64, 64>(q, k, v, o, lse, bh, s, scale, causal, st);
  if (d == 128 && dv == 128)
    return launch<128, 128>(q, k, v, o, lse, bh, s, scale, causal, st);
  if (d == 96 && dv == 96)
    return launch<96, 96>(q, k, v, o, lse, bh, s, scale, causal, st);
  if (d == 192 && dv == 128)
    return launch<192, 128>(q, k, v, o, lse, bh, s, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a, b: [64, d] and c: [64, n] bf16; s_out [64, 64] and o_out [64, n]
// float32.  (d, n) is (64, 64), (128, 128), (96, 96), (192, 128) or
// (192, 192).
int flash_sm90_probe(const void* a, const void* b, const void* c,
                     float* s_out, float* o_out, int d, int n,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64 && n == 64)
    return launch_probe<64, 64>(a, b, c, s_out, o_out, st);
  if (d == 128 && n == 128)
    return launch_probe<128, 128>(a, b, c, s_out, o_out, st);
  if (d == 96 && n == 96)
    return launch_probe<96, 96>(a, b, c, s_out, o_out, st);
  if (d == 192 && n == 128)
    return launch_probe<192, 128>(a, b, c, s_out, o_out, st);
  if (d == 192 && n == 192)
    return launch_probe<192, 192>(a, b, c, s_out, o_out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_sm90_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
