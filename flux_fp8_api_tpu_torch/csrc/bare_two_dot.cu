// The bare two products of attention, for Hopper (sm_90a): the ceiling that the
// attention kernel (qknorm_attention.cu) is measured against.
//
// Replaces the TPU Pallas kernel ablate_attention.py:_bare_two_dot. Same function:
//   s   = q . k^T                f32 accumulate of bf16 operands, rounded to bf16
//   acc = bf16(s) . v            f32 accumulate
//   out = bf16(acc)
// with no softmax, rope, mask or normalisation. Lq and Lkv must be multiples of 64:
// there is no tail masking.
//
// What bounds it: the same 4 * H * Lq * Lkv * 128 FLOP as the attention kernel on the
// same data, so the tensor cores. One block per (head, 64-row q tile), four warps of
// 16 q rows, a loop over 64-row kv tiles staged into shared memory, mma.sync m16n8k16
// with the QK^T accumulators fed straight into the PV A-fragments. The attention
// kernel runs TMA and wgmma on 128-row tiles and is faster than this one, so this one
// is no ceiling for it until it is built the same way.

#include "tile_mma.cuh"

namespace {

struct BareArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int64_t q_sh, q_sl, k_sh, k_sl, v_sh, v_sl, o_sh, o_sl;  // head / row strides (elements)
  int lq, lkv;
};

__global__ void __launch_bounds__(kThreads)
bare_two_dot_kernel(const BareArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kBlockQ * kLd;
  __nv_bfloat16* sv = sk + kBlockKV * kLd;

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  stage_tile(sq, args.q + head * args.q_sh, args.q_sl, q0, args.lq);
  __syncthreads();
  uint32_t qa[kD / 16][4];
  load_a_fragments(qa, sq, warp, lane);

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const __nv_bfloat16* kh = args.k + head * args.k_sh;
  const __nv_bfloat16* vh = args.v + head * args.v_sh;
  for (int kv0 = 0; kv0 < args.lkv; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile's k/v reads are done
    stage_tile(sk, kh, args.k_sl, kv0, args.lkv);
    stage_tile(sv, vh, args.v_sl, kv0, args.lkv);
    __syncthreads();
    float s[kBlockKV / 8][4];
    qk_tile(s, qa, sk, lane);
    pv_tile(acc, s, sv, lane);  // rounds s to bf16 as it packs the A fragments
  }

  const int row0 = q0 + warp * 16 + g;
  __nv_bfloat16* oh = args.o + head * args.o_sh;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(oh + row0 * args.o_sl + c) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(oh + (row0 + 8) * args.o_sl + c) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; lq and lkv must
// be multiples of 64 (the wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int bare_two_dot_bf16(
    const void* q, const void* k, const void* v, void* o,
    int64_t q_sh, int64_t q_sl, int64_t k_sh, int64_t k_sl,
    int64_t v_sh, int64_t v_sl, int64_t o_sh, int64_t o_sl,
    int heads, int lq, int lkv, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bare_two_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  BareArgs args;
  args.q = static_cast<const __nv_bfloat16*>(q);
  args.k = static_cast<const __nv_bfloat16*>(k);
  args.v = static_cast<const __nv_bfloat16*>(v);
  args.o = static_cast<__nv_bfloat16*>(o);
  args.q_sh = q_sh; args.q_sl = q_sl;
  args.k_sh = k_sh; args.k_sl = k_sl;
  args.v_sh = v_sh; args.v_sl = v_sl;
  args.o_sh = o_sh; args.o_sl = o_sl;
  args.lq = lq;
  args.lkv = lkv;
  dim3 grid(lq / kBlockQ, heads);
  bare_two_dot_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
