// One launch of the memory-lean Adam update over every parameter (sm_90a).
//
// No Pallas kernel of the JAX package does this: there XLA fuses the whole
// optax chain of merlot_reserve_tpu/training/optimization.py
// (scale_by_bfloat16_adam, then add_decayed_weights or
// subtract_old_weights, then the schedule and -lr) into one program. The
// port's plain version, training/optimization.py `adam_update_reference`,
// runs about 49 device kernels per parameter tensor (21945 per update for
// the base model's 449 tensors). This kernel runs the same arithmetic in
// one launch.
//
// Per element, in f32, in the order and with the roundings of the eager
// ops on the card (each op rounds once, so every product and sum here is an
// explicit __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, which
// nvcc never contracts into an FMA):
//
//   next_m = (1-b1)*g + b1*f32(mu)
//   next_v = (1-b2)*(g*g) + b2*decode(nu)
//   mu <- bf16(next_m);  nu <- encode(next_v)
//   [bias correction: next_m *= 1/(1-b1^t), next_v *= 1/(1-b2^t): a tensor
//    divided by a Python scalar is a product with its f32 reciprocal on
//    the card]
//   u = next_m / (sqrt(next_v) + eps)
//   pretraining chain, decayed tensors:  u += wd*p
//   finetuning chain, masked tensors:    u += wd*(p - f32(anchor))
//   p += (u*step_size) * (-lr)
//
// decode(nu) = powf(|nu| (times 1 + 2^-9 where nu's sign bit is set), 1/3)
// with 1/3 rounded to f32, the function torch.pow(x, 1/3) calls on the
// card; encode is the cube-root bf16 code with subnormal intermediates
// flushed to zero (see unsigned_bfloat16_encode).
//
// f32 moments (use_bfloat16_adam off, optax's scale_by_adam): the same
// arithmetic with f32(mu) and decode(nu) read as the stored f32 values and
// mu <- next_m, nu <- next_v stored unrounded; one template instance each.
//
// Layout (multi-tensor apply): a device table of AdamTensor entries, one
// per parameter tensor, fixed for the optimizer's life (the parameters and
// moments are updated in place), a device array of this step's gradient
// pointers, and a block map: block b updates elements
// [block_start[b], block_start[b] + chunk) of tensor block_tensor[b].
//
// Bound on an H100: bytes. Per element g and p f32 read, p f32 written, mu
// and nu bf16 read and written (20 bytes; 28 with f32 moments), plus the
// bf16 anchor on the masked tensors of the finetuning chain; about 20
// flops. The base model's 3.1e8 parameters move 6.2 GB (8.7 GB with f32
// moments): 1.9 ms (2.6 ms) at 3.35 TB/s. This first version is simple:
// scalar loads, coalesced within a warp; nothing is staged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

struct AdamTensor {
  float* p;
  void* mu;                     // __nv_bfloat16, or float with f32_moments
  void* nu;
  const __nv_bfloat16* anchor;  // finetuning chain only; else null
  int64_t numel;
  int32_t decay;                // 1: decays (pretraining) or is masked (finetuning)
  int32_t pad;
};

struct AdamHyper {
  float one_minus_b1, b1, one_minus_b2, b2, eps;
  float inv_bc1, inv_bc2;       // f32 reciprocals of 1 - b^t
  float wd, step_size, neg_lr, one_third;
  int32_t bias_correction;
  int32_t finetune;             // 1: decay toward the anchor
  int32_t f32_moments;          // 1: mu and nu are f32 (optax's scale_by_adam)
};

struct AdamParams {
  const AdamTensor* tensors;
  const float* const* grads;
  const int32_t* block_tensor;
  const int64_t* block_start;
  int32_t num_blocks;
  int32_t chunk;
  AdamHyper h;
};

namespace {

constexpr float kMissingPrecision = 1.0f + 1.0f / 512.0f;  // exact in f32
constexpr int kThreads = 256;

__device__ __forceinline__ float flush_subnormal(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;
}

__device__ __forceinline__ float decode_nu(__nv_bfloat16 v, float one_third) {
  const unsigned short bits = __bfloat16_as_ushort(v);
  const float mag = __uint_as_float(static_cast<unsigned>(bits & 0x7fffu) << 16);
  const float x = __bfloat162float(v) >= 0.0f ? mag : __fmul_rn(mag, kMissingPrecision);
  return powf(x, one_third);
}

__device__ __forceinline__ __nv_bfloat16 encode_nu(float v) {
  const float v_pow = flush_subnormal(__fmul_rn(__fmul_rn(v, v), v));
  const __nv_bfloat16 v_bf = __float2bfloat16_rn(v_pow);
  const float v_bf32 = __bfloat162float(v_bf);
  const float err0 = flush_subnormal(fabsf(__fsub_rn(v_bf32, v_pow)));
  const float err1 =
      flush_subnormal(fabsf(__fsub_rn(__fmul_rn(v_bf32, kMissingPrecision), v_pow)));
  if (err0 < err1) return v_bf;
  return __ushort_as_bfloat16(__bfloat16_as_ushort(v_bf) ^ 0x8000u);
}

template <bool kF32Moments>
__global__ void __launch_bounds__(kThreads) adam_update_kernel(AdamParams prm) {
  const int32_t t = prm.block_tensor[blockIdx.x];
  const int64_t start = prm.block_start[blockIdx.x];
  const AdamTensor e = prm.tensors[t];
  const float* __restrict__ g = prm.grads[t];
  const AdamHyper h = prm.h;
  const int64_t end = min(start + static_cast<int64_t>(prm.chunk), e.numel);
  const bool decay = e.decay != 0;
  __nv_bfloat16* mu16 = static_cast<__nv_bfloat16*>(e.mu);
  __nv_bfloat16* nu16 = static_cast<__nv_bfloat16*>(e.nu);
  float* mu32 = static_cast<float*>(e.mu);
  float* nu32 = static_cast<float*>(e.nu);
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const float gi = g[i];
    const float p = e.p[i];
    const float m_prev = kF32Moments ? mu32[i] : __bfloat162float(mu16[i]);
    const float v_prev = kF32Moments ? nu32[i] : decode_nu(nu16[i], h.one_third);
    float next_m = __fadd_rn(__fmul_rn(h.one_minus_b1, gi), __fmul_rn(h.b1, m_prev));
    float next_v = __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(gi, gi)),
                             __fmul_rn(h.b2, v_prev));
    if (kF32Moments) {
      mu32[i] = next_m;
      nu32[i] = next_v;
    } else {
      mu16[i] = __float2bfloat16_rn(next_m);
      nu16[i] = encode_nu(next_v);
    }
    if (h.bias_correction) {
      next_m = __fmul_rn(next_m, h.inv_bc1);
      next_v = __fmul_rn(next_v, h.inv_bc2);
    }
    float u = __fdiv_rn(next_m, __fadd_rn(__fsqrt_rn(next_v), h.eps));
    if (decay) {
      const float base = h.finetune ? __fsub_rn(p, __bfloat162float(e.anchor[i])) : p;
      u = __fadd_rn(u, __fmul_rn(h.wd, base));
    }
    u = __fmul_rn(u, h.step_size);
    e.p[i] = __fadd_rn(p, __fmul_rn(u, h.neg_lr));
  }
}

__global__ void decode_probe_kernel(const __nv_bfloat16* in, float* out, int64_t n,
                                    float one_third) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = decode_nu(in[i], one_third);
}

}  // namespace

extern "C" {

// Sizes of the structs, so the Python side can check its ctypes mirrors.
size_t adam_update_params_size() { return sizeof(AdamParams); }
size_t adam_update_tensor_size() { return sizeof(AdamTensor); }

cudaError_t adam_update(const AdamParams* params, cudaStream_t stream) {
  if (params->num_blocks <= 0) return cudaSuccess;
  if (params->h.f32_moments) {
    adam_update_kernel<true><<<params->num_blocks, kThreads, 0, stream>>>(*params);
  } else {
    adam_update_kernel<false><<<params->num_blocks, kThreads, 0, stream>>>(*params);
  }
  return cudaGetLastError();
}

// The kernel's decode alone, for an exhaustive check of its 65536 inputs
// against torch.pow; not on any training path.
cudaError_t adam_decode_probe(const void* in, float* out, int64_t n, float one_third,
                              cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  decode_probe_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(in), out, n, one_third);
  return cudaGetLastError();
}

}  // extern "C"
