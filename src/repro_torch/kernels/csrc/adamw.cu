// Fused AdamW with global-norm clipping for Hopper (sm_90a).
//
// A port-only kernel: the JAX package's repro/optim/adamw.py runs plain jnp
// ops here and has no Pallas kernel.  It replaces the per-leaf PyTorch code
// of repro_torch/optim/adamw.py (AdamW._apply), which stays as the CPU path
// and the plain version the tests hold this one to.
//
//   sumsq:    partials[off + b] = sum over block b's share of g*g    (float32)
//   finalize: gnorm = sqrt(sum of all partials), in a fixed order;
//             scale = min(1, clip * (1 / max(gnorm, 1e-9)))
//   update:   g' = g*scale; m' = b1 m + (1-b1) g'; v' = b2 v + (1-b2) g' g';
//             p' = p - lr (m'/bc1 / (sqrt(v'/bc2) + eps) + wd p)
//
// What bounds it on this card.  An optimizer step does a few dozen float32
// operations a parameter and moves far more bytes than that: the update reads
// p, g (bf16: 2 + 2 B) and m, v (float32: 4 + 4 B) and writes p, m and v
// (2 + 4 + 4 B), and the norm reads g once more (2 B): 24 B a bf16 parameter.
// At 1.885 G parameters (the OLMoE train cell) that is 45.2 GB a step, 13.5 ms
// at 3.35 TB/s.  HBM bandwidth, not the SMs, bounds it.  The per-leaf PyTorch
// code ran ~22 separate float32 passes, each reading and writing whole
// tensors: ~380 GB a step.
//
// What the design does about it.
//   * One pass over each leaf for the norm and one for the update, each with
//     16-byte vector loads and stores (8 elements a thread a step: one 16-byte
//     access of bf16, two of float32), in a grid-stride loop over at most
//     SMs x 4 blocks of 256 threads.  A leaf's ragged end past the last whole
//     vector is a scalar loop; a base that is not 16-byte aligned takes the
//     scalar loop for the whole leaf.  Reads and writes are streamed
//     (ld/st.global.cs): nothing is read twice in one pass.
//   * The norm takes no float atomics: each block writes its partial to its own
//     slot, and the finalize launch (one block) sums every slot of every leaf
//     in a fixed order, in double, then rounds to float32 and takes the root.
//     Two calls on the same inputs agree bit for bit.  Only this sum's order
//     differs from PyTorch's (a per-leaf torch.sum, then the leaves in order).
//   * The scalars (scale, lr and the two bias corrections 1 - b**t) are read
//     from device memory, so no value is brought to the host: the host never
//     waits for the card.
//   * Same work, same numbers: every operation of the update is one
//     round-to-nearest intrinsic, in PyTorch's order, and the build passes
//     -fmad=false, so nothing is contracted into an FMA.  The hyper-parameters
//     arrive as float32 rounded from the host's doubles, as PyTorch rounds a
//     Python scalar; the bf16 cast rounds to nearest even (__float2bfloat16_rn,
//     what PyTorch's cast uses on the card).  Given the same scale, p, m and v
//     equal the per-leaf path's bit for bit.  The finalize's scale follows
//     PyTorch's expression too: clamp, reciprocal, multiply, clamp, with NaN
//     passed through as torch.clamp passes it.
//
// Plain C interface (bound with ctypes).  dtype 0 is float32, 1 is bfloat16.
// Each entry returns cudaGetLastError() after its launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread moves a step
constexpr int kFinalThreads = 1024;

struct Hyper {
  float b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2, rounded on host
};

struct Scalars {
  float scale, lr, bc1, bc2;
};

// -- loads and stores of 8 elements, as float32 --------------------------

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);  // exact
}

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = bf16_bits_to_float(w[k] & 0xffffu);
    x[2 * k + 1] = bf16_bits_to_float(w[k] >> 16);
  }
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(x[4], x[5], x[6], x[7]));
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 u;
  u.x = float_to_bf16_bits(x[0]) | (float_to_bf16_bits(x[1]) << 16);
  u.y = float_to_bf16_bits(x[2]) | (float_to_bf16_bits(x[3]) << 16);
  u.z = float_to_bf16_bits(x[4]) | (float_to_bf16_bits(x[5]) << 16);
  u.w = float_to_bf16_bits(x[6]) | (float_to_bf16_bits(x[7]) << 16);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ float load1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { __stcs(p, x); }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// -- the sum of squares ---------------------------------------------------

// Sum of v over the block in a fixed pattern; the result is in thread 0.
template <typename Acc, int kBlock>
__device__ __forceinline__ Acc block_sum(Acc v) {
  __shared__ Acc warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : Acc(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const T* __restrict__ g, long long n,
                   float* __restrict__ partials) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float acc = 0.0f;
  long long done = 0;  // elements the vector loop covers
  if (aligned16(g)) {
    const long long nvec = n / kVec;
    for (long long i = tid; i < nvec; i += stride) {
      float x[kVec];
      load8(g + i * kVec, x);
      float sq[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) sq[k] = __fmul_rn(x[k], x[k]);
      const float s = __fadd_rn(
          __fadd_rn(__fadd_rn(sq[0], sq[1]), __fadd_rn(sq[2], sq[3])),
          __fadd_rn(__fadd_rn(sq[4], sq[5]), __fadd_rn(sq[6], sq[7])));
      acc = __fadd_rn(acc, s);
    }
    done = nvec * kVec;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float x = load1(g + i);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  acc = block_sum<float, kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinalThreads)
adamw_finalize_kernel(const float* __restrict__ partials, long long count,
                      float clip, float floor_norm,
                      float* __restrict__ gnorm_out,
                      float* __restrict__ scale_out) {
  double acc = 0.0;
  for (long long i = threadIdx.x; i < count; i += kFinalThreads)
    acc += static_cast<double>(partials[i]);
  acc = block_sum<double, kFinalThreads>(acc);
  if (threadIdx.x == 0) {
    const float gnorm = __fsqrt_rn(static_cast<float>(acc));
    // torch.clamp(clip / torch.clamp(gnorm, min=floor), max=1.0), where
    // clip / t is t.reciprocal() * clip; clamp passes NaN through
    const float lo = isnan(gnorm) ? gnorm : fmaxf(gnorm, floor_norm);
    const float s = __fmul_rn(__fdiv_rn(1.0f, lo), clip);
    *gnorm_out = gnorm;
    *scale_out = isnan(s) ? s : fminf(s, 1.0f);
  }
}

// -- the update -----------------------------------------------------------

// One element, in the per-leaf PyTorch code's order (optim/adamw.py, upd).
__device__ __forceinline__ float adamw_elem(float p, float g, float& m,
                                            float& v, const Scalars& s,
                                            const Hyper& h) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float mhat = __fdiv_rn(m, s.bc1);
  const float vhat = __fdiv_rn(v, s.bc2);
  const float delta = __fadd_rn(
      __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps)),
      __fmul_rn(h.wd, p));
  return __fsub_rn(p, __fmul_rn(s.lr, delta));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const T* __restrict__ p, const T* __restrict__ g,
                    const float* __restrict__ m, const float* __restrict__ v,
                    T* __restrict__ p_out, float* __restrict__ m_out,
                    float* __restrict__ v_out, long long n,
                    const float* __restrict__ scale,
                    const float* __restrict__ lr,
                    const float* __restrict__ bc1,
                    const float* __restrict__ bc2, Hyper h) {
  const Scalars s{*scale, *lr, *bc1, *bc2};
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) &&
      aligned16(p_out) && aligned16(m_out) && aligned16(v_out)) {
    const long long nvec = n / kVec;
    for (long long i = tid; i < nvec; i += stride) {
      const long long e = i * kVec;
      float pp[kVec], gg[kVec], mm[kVec], vv[kVec];
      load8(p + e, pp);
      load8(g + e, gg);
      load8(m + e, mm);
      load8(v + e, vv);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        pp[k] = adamw_elem(pp[k], gg[k], mm[k], vv[k], s, h);
      store8(p_out + e, pp);
      store8(m_out + e, mm);
      store8(v_out + e, vv);
    }
    done = nvec * kVec;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float mi = load1(m + i), vi = load1(v + i);
    const float pi = adamw_elem(load1(p + i), load1(g + i), mi, vi, s, h);
    store1(p_out + i, pi);
    store1(m_out + i, mi);
    store1(v_out + i, vi);
  }
}

}  // namespace

extern "C" {

// g: n elements of dtype; partials: blocks floats, one a block.
int adamw_sumsq(const void* g, int dtype, long long n, float* partials,
                int blocks, void* stream) {
  if (n < 1 || blocks < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    adamw_sumsq_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), n, partials);
  else
    adamw_sumsq_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), n, partials);
  return static_cast<int>(cudaGetLastError());
}

// partials: count >= 0 floats; gnorm, scale: one float each.
int adamw_finalize(const float* partials, long long count, float clip,
                   float floor_norm, float* gnorm, float* scale,
                   void* stream) {
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  adamw_finalize_kernel<<<1, kFinalThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      partials, count, clip, floor_norm, gnorm, scale);
  return static_cast<int>(cudaGetLastError());
}

// p, g, p_out: n elements of dtype; m, v, m_out, v_out: n floats; scale, lr,
// bc1, bc2: one float each on the device.
int adamw_update(const void* p, const void* g, const float* m, const float* v,
                 void* p_out, float* m_out, float* v_out, int dtype,
                 long long n, const float* scale, const float* lr,
                 const float* bc1, const float* bc2, float b1, float c1,
                 float b2, float c2, float eps, float wd, int blocks,
                 void* stream) {
  if (n < 1 || blocks < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, c1, b2, c2, eps, wd};
  if (dtype == 0)
    adamw_update_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(g), m, v,
        static_cast<float*>(p_out), m_out, v_out, n, scale, lr, bc1, bc2, h);
  else
    adamw_update_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p),
        static_cast<const __nv_bfloat16*>(g), m, v,
        static_cast<__nv_bfloat16*>(p_out), m_out, v_out, n, scale, lr, bc1,
        bc2, h);
  return static_cast<int>(cudaGetLastError());
}

const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
