// Max-free qk-norm attention with fused half-split RoPE, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel flux_fp8_api_tpu/ops/attention_kernel.py:qknorm_attention
// in its three builds. Same function:
//   s   = rope(q) . rope(k)^T            f32 accumulate of bf16 operands
//   p   = exp(s * sm_scale - SHIFT)       f32; kv columns >= Lkv masked to 0
//   den = sum_j p                         f32, from the unrounded p
//   acc = bf16(p) . v                     f32 accumulate
//   out = acc / max(den, 1e-30)           rows whose logits all underflow give 0, not NaN
// FLUX RMS-norms q and k per head, so |logit| stays far inside the exp range and no
// running max (and no rescaling of acc) is needed.
//
// Builds (one template body, each build its own __global__ kernel, so the serving build
// pays nothing for the others):
//   serving  <false, false>  the function above;
//   stats    <true,  false>  also max |s| * |sm_scale| over the whole call into one f32
//                            (the guard rail's input; masked columns count as 0, a NaN
//                            logit makes the max NaN);
//   ablate   <false, true>   p = s * sm_scale - SHIFT with no exp, for measuring the exp's
//                            cost; everything else unchanged. Not a softmax.
//
// What bounds it on the H100: at L = 4608 with 24 heads of 128 a call does
// 4 * 24 * 4608^2 * 128 = 261 GFLOP and reads about 28 MB of q/k/v, about 9000 FLOP
// per byte, so it is bound by the tensor cores, not by memory. The design keeps both
// products on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulators in registers),
// keeps the 64 x L score rows out of device memory entirely (scores live in registers
// and go straight from the QK^T accumulators into the PV A-fragments), and applies the
// rotation once per tile as it is staged into shared memory.
//
// Layout: one thread block per (head, 64-row q tile), four warps of 16 q rows each.
// The block loops over 64-row kv tiles (the TPU kernel's sequential third grid axis).
// Head dim is fixed at 128. Tensors are addressed with (head, row) strides, so the
// caller may pass head-folded views of (B, L, N, D) activations without a copy; the
// last dimension must be contiguous. This is the simple first version: no cp.async/TMA
// pipelining and no wgmma.
//
// The stats build's max crosses blocks, which run in no order: each thread keeps a
// running fmaxf of |s| over its fragments (one instruction a logit), the warp reduces
// it with shuffles, the block through shared memory, and one thread per block does an
// atomicMax on the int bits of the (non-negative) float, whose order is the float
// order. fmaxf drops a NaN, so NaN comes in through den instead: an unmasked NaN logit
// makes p, and so its row's den, NaN, and a row whose den is NaN sets the thread's max
// to NaN before the reductions, which keep it (nan_max). A NaN has larger bits than
// +inf, so it also wins the atomicMax.

#include "tile_mma.cuh"

namespace {

constexpr float kShift = 20.0f;  // ops/attention_kernel.py SHIFT
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* cos_q;
  const float* sin_q;
  const float* cos_k;
  const float* sin_k;
  int64_t q_sh, q_sl, k_sh, k_sl, v_sh, v_sl, o_sh, o_sl;  // head / row strides (elements)
  int lq, lkv;
  float scale_log2;  // sm_scale * log2(e)
  float scale;       // sm_scale (ablate and stats builds)
  float* max_logit;  // stats build: zeroed f32 scalar on the device
};

// max that keeps a NaN from either side (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

// The body of all three builds; each __global__ kernel below is one instantiation.
template <bool kTrackMax, bool kAblateExp>
__device__ __forceinline__ void attention(const Args& args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kBlockQ * kLd;
  __nv_bfloat16* sv = sk + kBlockKV * kLd;

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within group

  const __nv_bfloat16* qh = args.q + head * args.q_sh;
  const __nv_bfloat16* kh = args.k + head * args.k_sh;
  const __nv_bfloat16* vh = args.v + head * args.v_sh;

  stage_tile(sq, qh, args.q_sl, q0, args.lq, args.cos_q, args.sin_q);
  __syncthreads();

  uint32_t qa[kD / 16][4];
  load_a_fragments(qa, sq, warp, lane);

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float den0 = 0.f, den1 = 0.f;  // rows g and g + 8 of this warp, partial over t
  float amax = 0.f;              // stats build: max |s| over this thread's fragments
  const float shift_log2 = kShift * kLog2e;

  for (int kv0 = 0; kv0 < args.lkv; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile's k/v reads are done
    stage_tile(sk, kh, args.k_sl, kv0, args.lkv, args.cos_k, args.sin_k);
    stage_tile(sv, vh, args.v_sl, kv0, args.lkv, nullptr, nullptr);
    __syncthreads();

    float s[kBlockKV / 8][4];
    qk_tile(s, qa, sk, lane);

    // p = exp(s * sm_scale - SHIFT), masked past lkv; den from the f32 p
    const bool tail = kv0 + kBlockKV > args.lkv;
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        if constexpr (kAblateExp) {
          p = s[j][e] * args.scale - kShift;
        } else {
          p = exp2f(s[j][e] * args.scale_log2 - shift_log2);
        }
        if (tail && kv0 + j * 8 + 2 * t + (e & 1) >= args.lkv) {
          p = 0.f;
        } else if constexpr (kTrackMax) {
          amax = fmaxf(amax, fabsf(s[j][e]));
        }
        s[j][e] = p;
      }
      den0 += s[j][0] + s[j][1];
      den1 += s[j][2] + s[j][3];
    }

    pv_tile(acc, s, sv, lane);
  }

  // den: sum the four partials of each row (lanes 4g .. 4g+3)
  den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
  den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 2);

  if constexpr (kTrackMax) {
    __shared__ float warp_max[kWarps];
    if (den0 != den0 || den1 != den1) amax = __int_as_float(0x7fc00000);  // a NaN logit
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) warp_max[warp] = amax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = warp_max[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = nan_max(m, warp_max[w]);
      // max(x_i) * c == max(x_i * c) for c >= 0, so scaling once per block is exact
      atomicMax(reinterpret_cast<int*>(args.max_logit), __float_as_int(m * fabsf(args.scale)));
    }
  }

  const float inv0 = 1.f / fmaxf(den0, 1e-30f);
  const float inv1 = 1.f / fmaxf(den1, 1e-30f);

  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  __nv_bfloat16* oh = args.o + head * args.o_sh;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < args.lq)
      *reinterpret_cast<uint32_t*>(oh + row0 * args.o_sl + c) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < args.lq)
      *reinterpret_cast<uint32_t*>(oh + row1 * args.o_sl + c) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

__global__ void __launch_bounds__(kThreads) qknorm_attention_kernel(const Args args) {
  attention<false, false>(args);
}

// Three blocks of 128 threads share an SM's 65,536 registers at up to 168 registers a
// thread, which the serving build uses. Left alone, ptxas gave the stats and ablate
// builds 171-172, which fits only two blocks per SM and made them 1.5-1.9x slower on an
// H100 for that reason alone; the ablation would then time occupancy, not the exp. So
// those two builds are held to three blocks per SM. (A minimum of 1 on the serving
// kernel is not the same as none: ptxas then took 198 registers.)
__global__ void __launch_bounds__(kThreads, 3) qknorm_attention_stats_kernel(const Args args) {
  attention<true, false>(args);
}

__global__ void __launch_bounds__(kThreads, 3) qknorm_attention_ablate_kernel(const Args args) {
  attention<false, true>(args);
}

int launch(void (*kernel)(const Args), bool& configured, const Args& args, int heads,
           cudaStream_t stream) {
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((args.lq + kBlockQ - 1) / kBlockQ, heads);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; cos/sin are
// (L, 128) f32 tables or all four null (no rope). A non-null max_logit selects the stats
// build (it must point at a zeroed f32 on the device, written on the same stream);
// ablate_exp != 0 selects the ablate build; the two do not combine. Returns
// cudaGetLastError() after the launch, so a refused launch is reported to the caller.
extern "C" int qknorm_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* cos_q, const void* sin_q, const void* cos_k, const void* sin_k,
    int64_t q_sh, int64_t q_sl, int64_t k_sh, int64_t k_sl,
    int64_t v_sh, int64_t v_sl, int64_t o_sh, int64_t o_sl,
    int heads, int lq, int lkv, float sm_scale, void* max_logit, int ablate_exp,
    void* stream) {
  Args args;
  args.q = static_cast<const __nv_bfloat16*>(q);
  args.k = static_cast<const __nv_bfloat16*>(k);
  args.v = static_cast<const __nv_bfloat16*>(v);
  args.o = static_cast<__nv_bfloat16*>(o);
  args.cos_q = static_cast<const float*>(cos_q);
  args.sin_q = static_cast<const float*>(sin_q);
  args.cos_k = static_cast<const float*>(cos_k);
  args.sin_k = static_cast<const float*>(sin_k);
  args.q_sh = q_sh; args.q_sl = q_sl;
  args.k_sh = k_sh; args.k_sl = k_sl;
  args.v_sh = v_sh; args.v_sl = v_sl;
  args.o_sh = o_sh; args.o_sl = o_sl;
  args.lq = lq;
  args.lkv = lkv;
  args.scale_log2 = sm_scale * kLog2e;
  args.scale = sm_scale;
  args.max_logit = static_cast<float*>(max_logit);
  static bool configured[3] = {false, false, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_logit != nullptr && ablate_exp) return static_cast<int>(cudaErrorInvalidValue);
  if (max_logit != nullptr) return launch(qknorm_attention_stats_kernel, configured[1], args, heads, s);
  if (ablate_exp) return launch(qknorm_attention_ablate_kernel, configured[2], args, heads, s);
  return launch(qknorm_attention_kernel, configured[0], args, heads, s);
}
