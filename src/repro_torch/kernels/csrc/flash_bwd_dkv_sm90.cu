// Flash-attention dK/dV backward on Hopper's tensor cores (sm_90a): bf16,
// head widths (D, DV) in {(64, 64), (128, 128), (96, 96), (192, 128)}.
//
// With the forward's logsumexp L and delta[i] = dO[i] . O[i] (computed by
// the caller), P is recomputed tile by tile and never stored:
//
//   P[i, j]  = exp(scale * Q[i] . K[j] - L[i])       (0 where masked)
//   dS[i, j] = P[i, j] * (dO[i] . V[j] - delta[i]) * scale
//   dK[j] = sum_i dS[i, j] Q[i],   dV[j] = sum_i P[i, j] dO[i]
//
// over queries i >= j (causal) or all queries; Q, K are [BH, S, D] and V,
// dO [BH, S, DV] bf16, L and delta [BH, S] float32; dK [BH, S, D] and dV
// [BH, S, DV] are written in bf16.  Every other dtype and head width takes
// flash_bwd.cu's dK/dV kernel; the wrapper (kernels/flash.py:
// kernel_variant) chooses by dtype and shape alone.
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
// What bounds it on this card.  Four products a (query, key) pair (K Q^T
// and dP^T over D and DV, P^T dO and dS^T Q: 2 (2 D + 2 DV) FLOP), at 989
// TFLOP/s bf16 against Q, K, V, dO, L, delta, dK and dV moved once at 3.35
// TB/s; every path shape is bound by operations:
//   smollm-135m [36, 2048, 64]:            3.87e10 FLOP, 39.1 us (~57 MB, 17)
//   phi-3-vision [32, 2624, 96]:           8.46e10 FLOP, 85.6 us (~97 MB, 29)
//   deepseek-v2 MLA [128, 2048, 192->128]: 3.44e11 FLOP, 347.6 us (~504 MB,
//                                          150)
//
// What the design does about it.  Every product runs on the tensor cores
// with wgmma, fed by TMA (sm90.cuh):
//   * one block of 384 threads: two consumer warpgroups of 64 keys each
//     and one producer warpgroup, which hands most of its registers to
//     the consumers (setmaxnreg: 40 and 232 a thread), so the four
//     accumulators and the split operands fit without spills.  Key tiles
//     are issued heaviest (first) first.
//   * the producer loads the block's K and V once, then streams BQ-row
//     tiles of Q and dO and the tile's BQ values of L and delta from the
//     diagonal query tile onward into a three-stage ring guarded by full /
//     empty mbarriers.  BQ shrinks as the pair widens, to keep the dK and
//     dV accumulators ((D + DV) / 2 floats a thread: 64, 96, 128, 160) and
//     S^T, dP^T and their split operands (2 BQ) under 232 registers: BQ =
//     64 at (64, 64), 32 at (96, 96) and (128, 128), 16 at (192, 128)
//     (S^T and dP^T are then m64n16 products).  L and delta come through
//     1-D maps over all BH * S rows (any S: a 2-D map would need S * 4
//     bytes to be a multiple of 16), so a tile's rows past S read the next
//     head's values, or zeros at the end, which the mask discards.  A 1-D
//     box must start on a 16-byte boundary, so a stage takes BQ + 4 values
//     from the boundary at or before the tile's first row and reads them
//     at that offset (0-3).  Shared memory: 112 KB at (96, 96) (K, V 32 KB
//     each with 96-wide rows zero-padded to 128; stages of Q 8 + dO 8 KB),
//     ~111 KB at (192, 128) (K 48, V 32; stages of Q 6 + dO 4 KB).
//   * S^T = K Q^T and dP^T = V dO^T are SS wgmmas (all four operands
//     K-major, D / 16 and DV / 16 k-steps) into float32 registers; P^T =
//     exp2(S^T scale log2(e) - L log2(e)) and dS^T = P^T (dP^T - delta)
//     scale on the registers.
//   * dV += P^T dO (N = DV) and dK += dS^T Q (N = D: 192 at MLA) are RS
//     wgmmas: the accumulators of P^T and dS^T are the A operands in
//     registers, dO and Q are read MN-major (B's transpose bit) from the
//     same shared tiles the SS products read K-major.
//   * Split register operands.  Rounding P^T and dS^T to bf16 once puts dK
//     and dV at 3.1x and 3.8x of the bf16 gate (atol 1e-3 + rtol 8e-3
//     |want|, held by chip_smoke.py and tests/test_torch_cuda.py); split
//     into hi = bf16(x) and lo = bf16(x - hi), each a product into the same
//     float32 accumulator, they land at 0.60x and 0.74x
//     (tests/test_torch_flash.py:split_operand_gate_ratios, [4, 2048, 64]
//     on the CPU; 0.54-0.64x at (96, 96) and (192, 128), where once reads
//     2.3-3.5x).  The split costs 1.5x the products (six passes a tile
//     pair instead of four) and buys the gate.
// Not done here: overlap of one tile's exp with the next tile's products,
// a persistent grid, GQA without the materialised K/V repeat, and dK's
// columns split between warpgroups (which would let (192, 128) take BQ =
// 32).
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

// Shared bytes: K [kBKV, D], V [kBKV, DV], then kStages x (Q [BQ, D],
// dO [BQ, DV]), each in 64-column blocks of 128-byte rows, then kStages x
// (L, delta) in float32, kRowBox values each at a kRowStride pitch (a TMA
// destination is 128-byte aligned).
template <int D, int DV, int BQ>
struct Layout {
  static constexpr int kKBytes = kBKV * 128 * sm90::col_blocks(D);
  static constexpr int kVBytes = kBKV * 128 * sm90::col_blocks(DV);
  static constexpr int kQBytes = BQ * 128 * sm90::col_blocks(D);
  static constexpr int kDOBytes = BQ * 128 * sm90::col_blocks(DV);
  static constexpr int kStageBytes = kQBytes + kDOBytes;
  static constexpr int kRowBox = BQ + 4;  // a tile's rows from a 16-B start
  static constexpr int kRowStride = (kRowBox * 4 + 127) / 128 * 32;
  static constexpr int kRowBytes = 2 * kRowBox * 4;  // L and delta loaded
  static constexpr int kBytes = kKBytes + kVBytes +
                                kStages * (kStageBytes + 2 * kRowStride * 4) +
                                1024;
};

template <int D, int DV, int BQ>
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
  using L = Layout<D, DV, BQ>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_kv, bar_full[kStages], bar_empty[kStages];
  uint8_t* k_s = sm90::align_1024(smem_raw);
  uint8_t* v_s = k_s + L::kKBytes;
  uint8_t* qdo_s = v_s + L::kVBytes;
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
      sm90::mbar_expect_tx(&bar_kv, L::kKBytes + L::kVBytes);
      for (int c = 0; c < sm90::col_blocks(D); ++c)
        sm90::tma_load_3d(k_s + c * kBKV * 128, &tm_k, &bar_kv, 64 * c, k0,
                          bh);
      for (int c = 0; c < sm90::col_blocks(DV); ++c)
        sm90::tma_load_3d(v_s + c * kBKV * 128, &tm_v, &bar_kv, 64 * c, k0,
                          bh);
      for (int n = 0; n < nq - qt0; ++n) {
        const int s = n % kStages;
        sm90::mbar_wait(&bar_empty[s], ((n / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&bar_full[s], L::kStageBytes + L::kRowBytes);
        uint8_t* q_s = qdo_s + s * L::kStageBytes;
        uint8_t* do_s = q_s + L::kQBytes;
        const int q0 = (qt0 + n) * BQ;
        for (int c = 0; c < sm90::col_blocks(D); ++c)
          sm90::tma_load_3d(q_s + c * BQ * 128, &tm_q, &bar_full[s], 64 * c,
                            q0, bh);
        for (int c = 0; c < sm90::col_blocks(DV); ++c)
          sm90::tma_load_3d(do_s + c * BQ * 128, &tm_do, &bar_full[s],
                            64 * c, q0, bh);
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

    float dk[D / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;

    sm90::mbar_wait(&bar_kv, 0);
    for (int n = 0; n < nq - qt0; ++n) {
      const int s = n % kStages;
      const int q0 = (qt0 + n) * BQ;
      sm90::mbar_wait(&bar_full[s], (n / kStages) & 1);
      const uint8_t* q_s = qdo_s + s * L::kStageBytes;
      const uint8_t* do_s = q_s + L::kQBytes;
      // causal: a query tile wholly before this warpgroup's first key adds 0
      if (!(causal && q0 + BQ - 1 < kw0)) {
        // S^T = K Q^T (depth D) and dP^T = V dO^T (depth DV): [64 keys, BQ
        // queries]
        float st[BQ / 2], dp[BQ / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int blk = kk / 4, off = (kk % 4) * 32;
          sm90::wgmma_ss<BQ, 0>(
              st,
              sm90::desc_sw128(
                  k_s + blk * kBKV * 128 + wg * 64 * 128 + off, 16, 1024),
              sm90::desc_sw128(q_s + blk * BQ * 128 + off, 16, 1024),
              kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          const int blk = kk / 4, off = (kk % 4) * 32;
          sm90::wgmma_ss<BQ, 0>(
              dp,
              sm90::desc_sw128(
                  v_s + blk * kBKV * 128 + wg * 64 * 128 + off, 16, 1024),
              sm90::desc_sw128(do_s + blk * BQ * 128 + off, 16, 1024),
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

        // dV += P^T dO (N = DV) and dK += dS^T Q (N = D), each operand split
        // into hi + lo
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
          sm90::wgmma_rs<DV, 1>(dv, p_hi[kk], d_do, 1);
          sm90::wgmma_rs<DV, 1>(dv, p_lo[kk], d_do, 1);
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

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kr0 + 8 * i;
      if (kr >= S) continue;
      const long long row = static_cast<long long>(bh) * S + kr;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(&dK[row * D + 8 * jj + col]) =
            __floats2bfloat162_rn(dk[4 * jj + 2 * i], dk[4 * jj + 2 * i + 1]);
#pragma unroll
      for (int jj = 0; jj < DV / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(&dV[row * DV + 8 * jj + col]) =
            __floats2bfloat162_rn(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
    }
  }
}

// BQ = 64 at D = DV = 64; 32 at (128, 128) and (96, 96); 16 at (192, 128).
// The dK and dV accumulators take (D + DV) / 2 float32 registers a thread
// (64, 128, 96, 160), and S^T, dP^T and their split operands 2 BQ more,
// so BQ shrinks as the pair widens to stay under 232 without spills.
template <int D, int DV, int BQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int s, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta;
  const long long rows = static_cast<long long>(bh) * s;
  int err = sm90::encode_bf16_3d(&tm_q, q, bh, s, D, BQ);
  if (!err) err = sm90::encode_bf16_3d(&tm_k, k, bh, s, D, kBKV);
  if (!err) err = sm90::encode_bf16_3d(&tm_v, v, bh, s, DV, kBKV);
  if (!err) err = sm90::encode_bf16_3d(&tm_do, dout, bh, s, DV, BQ);
  const int box = Layout<D, DV, BQ>::kRowBox;
  if (!err) err = sm90::encode_f32_1d(&tm_lse, lse, rows, box);
  if (!err) err = sm90::encode_f32_1d(&tm_delta, delta, rows, box);
  if (err) return err;
  const int bytes = Layout<D, DV, BQ>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<D, DV, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (s + kBKV - 1) / kBKV);
  flash_bwd_dkv_sm90_kernel<D, DV, BQ><<<grid, kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta,
      static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, dk: [bh, s, d] and v, dout, dv: [bh, s, dv] bf16, contiguous,
// 16-byte aligned; (d, dv) is (64, 64), (128, 128), (96, 96) or (192, 128);
// lse, delta: [bh, s] float32, 16-byte aligned; bh * s < 2^31 (TMA
// coordinates are 32-bit).
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int s,
                       int d, int d_v, float scale, int causal,
                       void* stream) {
  if (bh < 1 || s < 1 || (s + kBKV - 1) / kBKV > 65535 ||
      static_cast<long long>(bh) * s > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64 && d_v == 64)
    return launch<64, 64, 64>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                              scale, causal, st);
  if (d == 128 && d_v == 128)
    return launch<128, 128, 32>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                                scale, causal, st);
  if (d == 96 && d_v == 96)
    return launch<96, 96, 32>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                              scale, causal, st);
  if (d == 192 && d_v == 128)
    return launch<192, 128, 16>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                                scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_bwd_dkv_sm90_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
