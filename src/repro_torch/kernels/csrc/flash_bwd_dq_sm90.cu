// Flash-attention dQ backward on Hopper's tensor cores (sm_90a): bf16,
// head widths (D, DV) in {(64, 64), (128, 128), (96, 96), (192, 128)}.
//
// With the forward's logsumexp L and delta[i] = dO[i] . O[i] (computed by
// the caller), P is recomputed tile by tile and never stored:
//
//   P[i, j]  = exp(scale * Q[i] . K[j] - L[i])       (0 where masked)
//   dS[i, j] = P[i, j] * (dO[i] . V[j] - delta[i]) * scale
//   dQ[i]    = sum_j dS[i, j] K[j]
//
// over keys j <= i (causal) or all keys; Q, K are [BH, S, D] and V, dO
// [BH, S, DV] bf16, L and delta [BH, S] float32; dQ [BH, S, D] is written
// in bf16.  Every other dtype and head width takes flash_bwd.cu's dQ
// kernel; the wrapper (kernels/flash.py:kernel_variant) chooses by dtype
// and shape alone.
//
// Replaces the Pallas TPU kernel of the JAX package, as flash_bwd.cu's dQ
// kernel does:
//   repro/kernels/flash.py:170  _flash_dq_kernel (flash_bwd, :292; call :300)
// One block owns one (bh, 128-row query tile) and writes its dQ rows once:
// no output is shared between blocks, nothing is added with atomics, and
// dQ is the same bits from run to run.  Every S >= 1 is exact: ragged
// query rows and key columns are masked, and P and dS of a query row past
// S are 0 by select, whatever its L or delta would read.
//
// What bounds it on this card.  Three products a (query, key) pair (Q K^T
// over D, dO V^T over DV, dS K over the keys into D columns: 2 (2 D + DV)
// FLOP), at 989 TFLOP/s bf16 against Q, K, V, dO, L, delta and dQ moved
// once at 3.35 TB/s; every path shape is bound by operations:
//   smollm-135m [36, 2048, 64]:            2.90e10 FLOP, 29.33 us (~48 MB, 14)
//   olmoe-1b-7b [64, 2048, 128]:           1.03e11 FLOP, 104.3 us (~169 MB, 50)
//   phi-3-vision [32, 2624, 96]:           6.35e10 FLOP, 64.19 us (~81 MB, 24)
//   deepseek-v2 MLA [128, 2048, 192->128]: 2.75e11 FLOP, 278.07 us (~438 MB,
//                                          131)
//
// What the design does about it.  Every product runs on the tensor cores
// with wgmma, fed by TMA (sm90.cuh); it is the forward's loop
// (flash_fwd_sm90.cu) with a second score product and dS in place of the
// online softmax:
//   * one block of 384 threads: two consumer warpgroups of 64 query rows
//     each and one producer warpgroup, which hands most of its registers
//     to the consumers (setmaxnreg: 40 and 232 a thread, as in
//     flash_bwd_dkv_sm90.cu).  Query tiles are issued heaviest first.
//   * the producer loads the block's Q and dO tiles once, then streams
//     64-key tiles of K and V into a three-stage ring guarded by full /
//     empty mbarriers, up to the causal limit; the 3-D tensor maps
//     (width, S, BH) zero-fill rows past S.  Each tile is col_blocks(width)
//     64-column blocks of 128-byte rows: a 96-wide tile is two blocks whose
//     columns 96-127 TMA fills with zeros (the mbarrier counts the whole
//     boxes), a 192-wide one three.  Shared memory: 81 KB at (64, 64), 161
//     KB at (128, 128), 161 KB at (96, 96) (Q, dO 32 KB each; stages of
//     K 16 + V 16 KB), 201 KB at (192, 128) (Q 48, dO 32; K 24 + V 16).
//     Each consumer thread reads the L and delta of its own two rows once,
//     with plain loads.
//   * S = Q K^T (D / 16 k-steps) and dP = dO V^T (DV / 16) are SS wgmmas
//     (all four operands K-major) into float32 registers; P = exp2(S
//     scale log2(e) - L log2(e)) and dS = P (dP - delta) scale on the
//     registers.
//   * dQ += dS K is an RS wgmma of N = D (64, 96, 128 or 192): the
//     accumulator of dS is the A operand in registers, and K is read
//     MN-major (B's transpose bit; 64-column blocks one K tile apart) from
//     the same shared tile that Q K^T read K-major.  The epilogue writes
//     the accumulator's D columns, none of the zero padding.
//   * Split register operand.  Rounding dS to bf16 once puts dQ at 2.62x
//     (64), 1.88x (128), 3.05x (96, 96) and 1.90x (192, 128) of the bf16
//     gate (atol 1e-3 + rtol 8e-3 |want|, held by chip_smoke.py and
//     tests/test_torch_cuda.py); split into hi = bf16(x) and lo = bf16(x -
//     hi), both products into the same float32 accumulator, it lands at
//     0.54x, 0.68x, 0.76x and 0.56x
//     (tests/test_torch_flash.py:split_operand_gate_ratios, [4, 2048, d]
//     on the CPU).  The split costs four products a tile instead of three
//     and buys the gate.
//   * 64-key tiles at every width: a thread holds dQ (D / 2 floats: 32,
//     48, 64, 96), S and dP (32 + 32) and the split dS (32), at most ~160
//     live values at (192, 128), within the consumers' 232 registers
//     without spills.
// Not done here: overlap of one tile's exp with the next tile's products,
// a persistent grid, delta computed in the kernel, and GQA without the
// materialised K/V repeat.
//
// Numerics: every product accumulates in float32; exp2f is the library
// function (no --use_fast_math).  Held to the plain version by a tolerance.
//
// Plain C interface (bound with ctypes): flash_bwd_dq_sm90 returns 0, a
// cudaError_t after the launch, or an sm90::kErr* code (see
// flash_bwd_dq_sm90_error_string).

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 128;         // query rows per block (2 x 64)
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kStages = 3;       // K/V ring
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer WG
// Registers a thread: three warps share each of the SM's four register
// files, 168 apiece at launch; the producer warpgroup drops to 40 and the
// consumers take 232 (2 x 232 + 40 = 3 x 168).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Shared bytes: Q [kBQ, D], dO [kBQ, DV], then kStages x (K [kBK, D],
// V [kBK, DV]), each in 64-column blocks of 128-byte rows (whole blocks:
// TMA writes, and the mbarrier counts, a 96-wide tile's zero half too).
template <int D, int DV>
struct Layout {
  static constexpr int kQBytes = kBQ * 128 * sm90::col_blocks(D);
  static constexpr int kDOBytes = kBQ * 128 * sm90::col_blocks(DV);
  static constexpr int kKBytes = kBK * 128 * sm90::col_blocks(D);
  static constexpr int kVBytes = kBK * 128 * sm90::col_blocks(DV);
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBytes =
      kQBytes + kDOBytes + kStages * kStageBytes + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ LSE,
                         const float* __restrict__ Delta,
                         __nv_bfloat16* __restrict__ dQ, int S, float scale,
                         int causal) {
  using L = Layout<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_full[kStages], bar_empty[kStages];
  uint8_t* q_s = sm90::align_1024(smem_raw);
  uint8_t* do_s = q_s + L::kQBytes;
  uint8_t* kv_s = do_s + L::kDOBytes;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
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

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one lane issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      sm90::mbar_expect_tx(&bar_q, L::kQBytes + L::kDOBytes);
      for (int c = 0; c < sm90::col_blocks(D); ++c)
        sm90::tma_load_3d(q_s + c * kBQ * 128, &tm_q, &bar_q, 64 * c, q0, bh);
      for (int c = 0; c < sm90::col_blocks(DV); ++c)
        sm90::tma_load_3d(do_s + c * kBQ * 128, &tm_do, &bar_q, 64 * c, q0,
                          bh);
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
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    // Consumer warpgroup wg owns query rows q0 + 64 wg .. + 63; thread t
    // holds rows row0 and row0 + 8 and, in each 8-column block, columns
    // col + {0, 1}.
    const int wg = warp / 4, t = threadIdx.x % 128;
    const int qw0 = q0 + 64 * wg;
    const int row0 = qw0 + 16 * (t / 32) + (t % 32) / 4;
    const int col = 2 * (t % 4);
    // causal: this warpgroup's last key is qw0 + 63, in tile (qw0 + 63) / kBK;
    // a warpgroup wholly past S computes nothing
    const int nk_wg =
        qw0 >= S ? 0 : (causal ? min(nk, (qw0 + 63) / kBK + 1) : nk);
    const float scale_log2 = scale * kLog2e;

    // L (in log2 units) and delta of this thread's two rows, read once
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const long long at = static_cast<long long>(bh) * S + row;
      lse2[i] = row < S ? LSE[at] * kLog2e : 0.f;
      dlt[i] = row < S ? Delta[at] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    sm90::mbar_wait(&bar_q, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % kStages;
      sm90::mbar_wait(&bar_full[s], (j / kStages) & 1);
      const uint8_t* k_s = kv_s + s * L::kStageBytes;
      const uint8_t* v_s = k_s + L::kKBytes;
      if (j < nk_wg) {
        // S = Q K^T (depth D) and dP = dO V^T (depth DV): [64 rows, kBK
        // keys]
        float sc[kBK / 2], dp[kBK / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int blk = kk / 4, off = (kk % 4) * 32;
          sm90::wgmma_ss<kBK, 0>(
              sc,
              sm90::desc_sw128(q_s + blk * kBQ * 128 + wg * 64 * 128 + off,
                               16, 1024),
              sm90::desc_sw128(k_s + blk * kBK * 128 + off, 16, 1024),
              kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          const int blk = kk / 4, off = (kk % 4) * 32;
          sm90::wgmma_ss<kBK, 0>(
              dp,
              sm90::desc_sw128(do_s + blk * kBQ * 128 + wg * 64 * 128 + off,
                               16, 1024),
              sm90::desc_sw128(v_s + blk * kBK * 128 + off, 16, 1024),
              kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);

        // P and dS on the registers; masked pairs and rows past S give 0
        const int k0 = j * kBK;
        const bool ragged = k0 + kBK > S || qw0 + 64 > S ||
                            (causal && k0 + kBK - 1 > qw0);
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int idx = 4 * jj + 2 * i + c;
              const int key = k0 + 8 * jj + col + c, row = row0 + 8 * i;
              const bool valid =
                  !ragged || (row < S && key < S && !(causal && key > row));
              const float p =
                  valid ? exp2f(fmaf(sc[idx], scale_log2, -lse2[i])) : 0.f;
              dp[idx] = valid ? p * (dp[idx] - dlt[i]) * scale : 0.f;
            }

        // dQ += dS K, dS split into hi + lo, K [kBK keys, D] read MN-major
        // (N = D; its 64-column blocks one K tile, kBK * 128 bytes, apart)
        uint32_t ds_hi[kBK / 16][4], ds_lo[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          sm90::acc_to_a_split(dp, kk, ds_hi[kk], ds_lo[kk]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t d_k =
              sm90::desc_sw128(k_s + kk * 16 * 128, kBK * 128, 1024);
          sm90::wgmma_rs<D, 1>(dq, ds_hi[kk], d_k, 1);
          sm90::wgmma_rs<D, 1>(dq, ds_lo[kk], d_k, 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          sm90::fence_regs(ds_hi[kk]);
          sm90::fence_regs(ds_lo[kk]);
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&bar_empty[s]);
    }

    __nv_bfloat16* dQb = dQ + static_cast<long long>(bh) * S * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= S) continue;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(
            &dQb[static_cast<long long>(row) * D + 8 * jj + col]) =
            __floats2bfloat162_rn(dq[4 * jj + 2 * i], dq[4 * jj + 2 * i + 1]);
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh, int s,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = sm90::encode_bf16_3d(&tm_q, q, bh, s, D, kBQ);
  if (!err) err = sm90::encode_bf16_3d(&tm_k, k, bh, s, D, kBK);
  if (!err) err = sm90::encode_bf16_3d(&tm_v, v, bh, s, DV, kBK);
  if (!err) err = sm90::encode_bf16_3d(&tm_do, dout, bh, s, DV, kBQ);
  if (err) return err;
  const int bytes = Layout<D, DV>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  flash_bwd_dq_sm90_kernel<D, DV><<<grid, kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq),
      s, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, dq: [bh, s, d] and v, dout: [bh, s, dv] bf16, contiguous, 16-byte
// aligned; (d, dv) is (64, 64), (128, 128), (96, 96) or (192, 128); lse,
// delta: [bh, s] float32; bh * s < 2^31 (TMA coordinates are 32-bit).
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int s, int d, int d_v, float scale,
                      int causal, void* stream) {
  if (bh < 1 || s < 1 || (s + kBQ - 1) / kBQ > 65535 ||
      static_cast<long long>(bh) * s > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64 && d_v == 64)
    return launch<64, 64>(q, k, v, dout, lse, delta, dq, bh, s, scale,
                          causal, st);
  if (d == 128 && d_v == 128)
    return launch<128, 128>(q, k, v, dout, lse, delta, dq, bh, s, scale,
                            causal, st);
  if (d == 96 && d_v == 96)
    return launch<96, 96>(q, k, v, dout, lse, delta, dq, bh, s, scale,
                          causal, st);
  if (d == 192 && d_v == 128)
    return launch<192, 128>(q, k, v, dout, lse, delta, dq, bh, s, scale,
                            causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_bwd_dq_sm90_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
