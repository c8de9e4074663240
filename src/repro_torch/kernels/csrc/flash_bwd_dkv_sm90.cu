// Flash-attention dK/dV backward on Hopper's tensor cores (sm_90a): bf16,
// D = DV in {64, 128}.
//
// With the forward's logsumexp L and delta[i] = dO[i] . O[i] (computed by
// the caller), P is recomputed tile by tile and never stored:
//
//   P[i, j]  = exp(scale * Q[i] . K[j] - L[i])       (0 where masked)
//   dS[i, j] = P[i, j] * (dO[i] . V[j] - delta[i]) * scale
//   dK[j] = sum_i dS[i, j] Q[i],   dV[j] = sum_i P[i, j] dO[i]
//
// over queries i >= j (causal) or all queries; Q, K, V, dO are [BH, S, D]
// bf16, L and delta [BH, S] float32; dK and dV are written in bf16.  Every
// other dtype and head width takes flash_bwd.cu's dK/dV kernel; the wrapper
// (kernels/flash.py:kernel_variant) chooses by dtype and shape alone.
//
// Replaces the Pallas TPU kernel of the JAX package, as flash_bwd.cu's
// dK/dV kernel does:
//   repro/kernels/flash.py:211  _flash_dkv_kernel (flash_bwd, :292; call :320)
// One block owns one (bh, 128-key tile) and writes its dK and dV once: no
// output is shared between blocks, nothing is added with atomics, and the
// gradients are the same bits from run to run.  Every S >= 1 is exact:
// ragged query rows and key columns are masked, and P and dS of a query
// row past S are 0 by select, whatever its L or delta reads.
//
// What bounds it on this card.  At the training path's shape (smollm-135m,
// [36, 2048, 64] bf16 per layer, causal: 7.553e7 (query, key) pairs) the
// kernel does four products a pair (K Q^T, V dO^T, P^T dO, dS^T Q: 512
// FLOP), 3.87e10 FLOP, 39.1 us at the 989 TFLOP/s bf16 tensor-core peak,
// against ~57 MB (~17 us at 3.35 TB/s): bound by operations.
//
// What the design does about it.  Every product runs on the tensor cores
// with wgmma, fed by TMA (sm90.cuh):
//   * one block of 384 threads: two consumer warpgroups of 64 keys each
//     and one producer warpgroup, which hands most of its registers to
//     the consumers (setmaxnreg: 40 and 232 a thread), so the four
//     accumulators and the split operands fit without spills.  Key tiles
//     are issued heaviest (first) first.
//   * the producer loads the block's K and V once, then streams BQ-row
//     tiles of Q and dO (BQ = 64, or 32 at D = 128 to keep the four
//     accumulators in registers) and the tile's BQ values of L and delta
//     from the diagonal query tile onward into a three-stage ring guarded
//     by full / empty mbarriers.  L and delta come through 1-D maps over
//     all BH * S rows (any S: a 2-D map would need S * 4 bytes to be a
//     multiple of 16), so a tile's rows past S read the next head's
//     values, or zeros at the end, which the mask discards.  A 1-D box
//     must start on a 16-byte boundary, so a stage takes BQ + 4 values
//     from the boundary at or before the tile's first row and reads them
//     at that offset (0-3).
//   * S^T = K Q^T and dP^T = V dO^T are SS wgmmas (all four operands
//     K-major) into float32 registers; P^T = exp2(S^T scale log2(e) -
//     L log2(e)) and dS^T = P^T (dP^T - delta) scale on the registers.
//   * dV += P^T dO and dK += dS^T Q are RS wgmmas: the accumulators of P^T
//     and dS^T are the A operands in registers, dO and Q are read MN-major
//     (B's transpose bit) from the same shared tiles the SS products read
//     K-major.
//   * Split register operands.  Rounding P^T and dS^T to bf16 once puts dK
//     and dV at 3.1x and 3.8x of the bf16 gate (atol 1e-3 + rtol 8e-3
//     |want|, held by chip_smoke.py and tests/test_torch_cuda.py); split
//     into hi = bf16(x) and lo = bf16(x - hi), each a product into the same
//     float32 accumulator, they land at 0.60x and 0.74x
//     (tests/test_torch_flash.py:split_operand_gate_ratios, [4, 2048, 64]
//     on the CPU).  The split costs 1.5x the products (six passes a tile
//     pair instead of four) and buys the gate.
// Not done here: overlap of one tile's exp with the next tile's products,
// a persistent grid, and GQA without the materialised K/V repeat.
//
// Numerics: every product accumulates in float32; exp2f is the library
// function (no --use_fast_math).  Held to the plain version by a tolerance.
//
// Plain C interface (bound with ctypes): flash_bwd_dkv_sm90 returns 0, a
// cudaError_t after the launch, or an sm90::kErr* code (see
// flash_bwd_dkv_sm90_error_string).

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBKV = 128;        // keys per block (2 x 64)
// Q/dO ring: three stages were faster than two on the H100, at D = 64 and
// 128
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer WG
// Registers a thread: three warps share each of the SM's four register
// files (16,384 each), 168 apiece at launch; the producer warpgroup drops
// to 40 and the consumers take 232 (2 x 232 + 40 = 3 x 168).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Shared bytes: K [kBKV, D], V [kBKV, D], then kStages x (Q [BQ, D],
// dO [BQ, D]), each in 64-column blocks of 128-byte rows, then kStages x
// (L, delta) in float32, kRowBox values each at a kRowStride pitch (a TMA
// destination is 128-byte aligned).
template <int D, int BQ>
struct Layout {
  static constexpr int kKBytes = kBKV * D * 2;
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr int kRowBox = BQ + 4;  // a tile's rows from a 16-B start
  static constexpr int kRowStride = (kRowBox * 4 + 127) / 128 * 32;
  static constexpr int kRowBytes = 2 * kRowBox * 4;  // L and delta loaded
  static constexpr int kBytes =
      2 * kKBytes + kStages * (kStageBytes + 2 * kRowStride * 4) + 1024;
};

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_delta,
                          __nv_bfloat16* __restrict__ dK,
                          __nv_bfloat16* __restrict__ dV, int S, float scale,
                          int causal) {
  using L = Layout<D, BQ>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_kv, bar_full[kStages], bar_empty[kStages];
  uint8_t* k_s = sm90::align_1024(smem_raw);
  uint8_t* v_s = k_s + L::kKBytes;
  uint8_t* qdo_s = v_s + L::kKBytes;
  float* rows_s = reinterpret_cast<float*>(qdo_s + kStages * L::kStageBytes);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBKV;  // heaviest causal tiles (first) first
  const int nq = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // the diagonal query tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&bar_full[s], 1);
      sm90::mbar_init(&bar_empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one lane issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      sm90::mbar_expect_tx(&bar_kv, 2 * L::kKBytes);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_3d(k_s + c * kBKV * 128, &tm_k, &bar_kv, 64 * c, k0,
                          bh);
        sm90::tma_load_3d(v_s + c * kBKV * 128, &tm_v, &bar_kv, 64 * c, k0,
                          bh);
      }
      for (int n = 0; n < nq - qt0; ++n) {
        const int s = n % kStages;
        sm90::mbar_wait(&bar_empty[s], ((n / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&bar_full[s], L::kStageBytes + L::kRowBytes);
        uint8_t* q_s = qdo_s + s * L::kStageBytes;
        uint8_t* do_s = q_s + L::kQBytes;
        const int q0 = (qt0 + n) * BQ;
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_3d(q_s + c * BQ * 128, &tm_q, &bar_full[s], 64 * c,
                            q0, bh);
          sm90::tma_load_3d(do_s + c * BQ * 128, &tm_do, &bar_full[s],
                            64 * c, q0, bh);
        }
        float* lse_s = rows_s + s * 2 * L::kRowStride;
        const int r0 = (bh * S + q0) & ~3;  // 16-byte boundary at or before
        sm90::tma_load_1d(lse_s, &tm_lse, &bar_full[s], r0);
        sm90::tma_load_1d(lse_s + L::kRowStride, &tm_delta, &bar_full[s],
                          r0);
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    // Consumer warpgroup wg owns keys k0 + 64 wg .. + 63; thread t holds keys
    // kr0 and kr0 + 8 and, in each 8-column block of a query tile, queries
    // col + {0, 1}.
    const int wg = warp / 4, t = threadIdx.x % 128;
    const int kw0 = k0 + 64 * wg;
    const int kr0 = kw0 + 16 * (t / 32) + (t % 32) / 4;
    const int col = 2 * (t % 4);
    const float scale_log2 = scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(&bar_kv, 0);
    for (int n = 0; n < nq - qt0; ++n) {
      const int s = n % kStages;
      const int q0 = (qt0 + n) * BQ;
      sm90::mbar_wait(&bar_full[s], (n / kStages) & 1);
      const uint8_t* q_s = qdo_s + s * L::kStageBytes;
      const uint8_t* do_s = q_s + L::kQBytes;
      // causal: a query tile wholly before this warpgroup's first key adds 0
      if (!(causal && q0 + BQ - 1 < kw0)) {
        // S^T = K Q^T and dP^T = V dO^T: [64 keys, BQ queries]
        float st[BQ / 2], dp[BQ / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int blk = kk / 4, off = (kk % 4) * 32;
          const int a_off = blk * kBKV * 128 + wg * 64 * 128 + off;
          const int b_off = blk * BQ * 128 + off;
          sm90::wgmma_ss<BQ, 0>(st, sm90::desc_sw128(k_s + a_off, 16, 1024),
                                sm90::desc_sw128(q_s + b_off, 16, 1024),
                                kk > 0);
          sm90::wgmma_ss<BQ, 0>(dp, sm90::desc_sw128(v_s + a_off, 16, 1024),
                                sm90::desc_sw128(do_s + b_off, 16, 1024),
                                kk > 0);
        }
        sm90::wgmma_commit();
        // L (in log2 units) and delta of this thread's queries
        const float* lse_s =
            rows_s + s * 2 * L::kRowStride + ((bh * S + q0) & 3);
        float lse2[BQ / 4], dlt[BQ / 4];
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            lse2[2 * jj + c] = lse_s[8 * jj + col + c] * kLog2e;
            dlt[2 * jj + c] = lse_s[L::kRowStride + 8 * jj + col + c];
          }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dp);

#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int idx = 4 * jj + 2 * i + c;
              const int qc = q0 + 8 * jj + col + c, kr = kr0 + 8 * i;
              const bool valid = qc < S && kr < S && !(causal && kr > qc);
              const float p =
                  valid ? exp2f(fmaf(st[idx], scale_log2, -lse2[2 * jj + c]))
                        : 0.f;
              st[idx] = p;
              dp[idx] = valid ? p * (dp[idx] - dlt[2 * jj + c]) * scale : 0.f;
            }

        // dV += P^T dO and dK += dS^T Q, each operand split into hi + lo
        uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4];
        uint32_t ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          sm90::acc_to_a_split(st, kk, p_hi[kk], p_lo[kk]);
          sm90::acc_to_a_split(dp, kk, ds_hi[kk], ds_lo[kk]);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t d_do =
              sm90::desc_sw128(do_s + kk * 16 * 128, BQ * 128, 1024);
          const uint64_t d_q =
              sm90::desc_sw128(q_s + kk * 16 * 128, BQ * 128, 1024);
          sm90::wgmma_rs<D, 1>(dv, p_hi[kk], d_do, 1);
          sm90::wgmma_rs<D, 1>(dv, p_lo[kk], d_do, 1);
          sm90::wgmma_rs<D, 1>(dk, ds_hi[kk], d_q, 1);
          sm90::wgmma_rs<D, 1>(dk, ds_lo[kk], d_q, 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dk);
        sm90::fence_regs(dv);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          sm90::fence_regs(p_hi[kk]);
          sm90::fence_regs(p_lo[kk]);
          sm90::fence_regs(ds_hi[kk]);
          sm90::fence_regs(ds_lo[kk]);
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&bar_empty[s]);
    }

    const long long base = static_cast<long long>(bh) * S * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kr0 + 8 * i;
      if (kr >= S) continue;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const long long at =
            base + static_cast<long long>(kr) * D + 8 * jj + col;
        *reinterpret_cast<__nv_bfloat162*>(&dK[at]) =
            __floats2bfloat162_rn(dk[4 * jj + 2 * i], dk[4 * jj + 2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&dV[at]) =
            __floats2bfloat162_rn(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
      }
    }
  }
}

// BQ = 64 at D = 64; 32 at D = 128, where dK and dV take 64 float32
// registers each and the S^T / dP^T accumulators must stay small.
template <int D, int BQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int s, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta;
  const long long rows = static_cast<long long>(bh) * s;
  int err = sm90::encode_bf16_3d(&tm_q, q, bh, s, D, BQ);
  if (!err) err = sm90::encode_bf16_3d(&tm_k, k, bh, s, D, kBKV);
  if (!err) err = sm90::encode_bf16_3d(&tm_v, v, bh, s, D, kBKV);
  if (!err) err = sm90::encode_bf16_3d(&tm_do, dout, bh, s, D, BQ);
  const int box = Layout<D, BQ>::kRowBox;
  if (!err) err = sm90::encode_f32_1d(&tm_lse, lse, rows, box);
  if (!err) err = sm90::encode_f32_1d(&tm_delta, delta, rows, box);
  if (err) return err;
  const int bytes = Layout<D, BQ>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<D, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (s + kBKV - 1) / kBKV);
  flash_bwd_dkv_sm90_kernel<D, BQ><<<grid, kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta,
      static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: [bh, s, d] bf16, contiguous, 16-byte aligned; d is
// 64 or 128; lse, delta: [bh, s] float32, 16-byte aligned; bh * s < 2^31
// (TMA coordinates are 32-bit).
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int s,
                       int d, float scale, int causal, void* stream) {
  if (bh < 1 || s < 1 || (s + kBKV - 1) / kBKV > 65535 ||
      static_cast<long long>(bh) * s > 2147483647LL || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64, 64>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                                  scale, causal, st)
                 : launch<128, 32>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                                   scale, causal, st);
}

const char* flash_bwd_dkv_sm90_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
