// The rope pass in front of the attention kernel, for Hopper (sm_90a): half-split RoPE
// of q and k, each element rotated once per call.
//
// Replaces the rotation inside the TPU Pallas kernel
// flux_fp8_api_tpu/ops/attention_kernel.py:_rope_rotate, called from _attn_kernel on
// every q and k tile: rotated there, each k row is rotated once for every q tile of its
// head (72 times at L = 4608); here once.
// Same arithmetic as the plain version ops/attention_kernel.py:rope_rotate_ref, bit for
// bit: in f32, each product and the sum rounded on their own (no fused multiply-add),
// then one round to bf16:
//   out[j]      = x[j] cos[j]           - x[j + 64] sin[j]          j < 64
//   out[j + 64] = x[j + 64] cos[j + 64] + x[j] sin[j + 64]
//
// What bounds it: it does 3 FLOP per element and moves 4 bytes of x and out per element,
// so it is bound by device memory: about 118 MB at L = 4608 with 24 heads (q, k and the
// f32 tables), 35 us at 3.35 TB/s. Each thread takes 8 channels of the first half with
// the matching 8 of the second half, in 16-byte accesses (the 8 threads of a row cover
// its 256 bytes, so a warp reads and writes four whole rows), for kHeadsPerThread heads:
// the 32 table values it needs are read once into registers and used for every one of
// those heads, since read once per head the tables would be 2 x 4 bytes per element
// against the 4 bytes of x and out. q and k go in one launch: the first blocks take q,
// the rest k; blockIdx.y picks the group of heads. x may be a strided (head, row) view
// with a contiguous last dimension; out is contiguous (H, L, 128).
//
// The backward build (kBackward) is the transpose of the same rotation, for training:
// given the gradient g of out, with the same geometry, tables and roundings,
//   dx[j]      = g[j] cos[j]           + g[j + 64] sin[j + 64]      j < 64
//   dx[j + 64] = g[j + 64] cos[j + 64] - g[j] sin[j]
// which is what autograd computes through rope_rotate_ref: the same two products and
// one sum per element, each rounded on its own, then one round to bf16. It is right
// for any tables, equal halves or not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kChunks = kD / 2 / 8;  // 8-channel chunks per half row
constexpr int kThreads = 256;
constexpr int kHeadsPerThread = 4;

struct Job {
  const __nv_bfloat16* x;
  int64_t sh, sl;  // head / row strides of x (elements)
  __nv_bfloat16* out;
  const float* cos;
  const float* sin;
  int len, heads;
  int64_t items;   // len * kChunks: one (row, chunk) per thread and group of heads
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void load8(float (&f)[8], const float* p) {
  *reinterpret_cast<float4*>(f) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(f + 4) = *reinterpret_cast<const float4*>(p + 4);
}

template <bool kBackward>
__device__ __forceinline__ void rotate(const Job& job, int64_t item, int head0) {
  const int c = static_cast<int>(item % kChunks) * 8;
  const int row = static_cast<int>(item / kChunks);
  const float* cr = job.cos + static_cast<int64_t>(row) * kD;
  const float* sr = job.sin + static_cast<int64_t>(row) * kD;
  float cl[8], sl[8], ch[8], sh[8];
  load8(cl, cr + c);
  load8(sl, sr + c);
  load8(ch, cr + c + kD / 2);
  load8(sh, sr + c + kD / 2);
#pragma unroll
  for (int hh = 0; hh < kHeadsPerThread; ++hh) {
    const int64_t head = head0 + hh;
    if (head >= job.heads) break;
    const __nv_bfloat16* src = job.x + head * job.sh + row * job.sl;
    const uint4 lo = *reinterpret_cast<const uint4*>(src + c);
    const uint4 hi = *reinterpret_cast<const uint4*>(src + c + kD / 2);
    const __nv_bfloat16* xl = reinterpret_cast<const __nv_bfloat16*>(&lo);
    const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(&hi);
    uint4 olo, ohi;
    uint32_t* ol = reinterpret_cast<uint32_t*>(&olo);
    uint32_t* oh = reinterpret_cast<uint32_t*>(&ohi);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float a[2], b[2], rl[2], rh[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        a[u] = __bfloat162float(xl[e + u]);
        b[u] = __bfloat162float(xh[e + u]);
        if (kBackward) {
          rl[u] = __fadd_rn(__fmul_rn(a[u], cl[e + u]), __fmul_rn(b[u], sh[e + u]));
          rh[u] = __fsub_rn(__fmul_rn(b[u], ch[e + u]), __fmul_rn(a[u], sl[e + u]));
        } else {
          rl[u] = __fsub_rn(__fmul_rn(a[u], cl[e + u]), __fmul_rn(b[u], sl[e + u]));
          rh[u] = __fadd_rn(__fmul_rn(b[u], ch[e + u]), __fmul_rn(a[u], sh[e + u]));
        }
      }
      ol[e / 2] = pack_bf16(rl[0], rl[1]);
      oh[e / 2] = pack_bf16(rh[0], rh[1]);
    }
    __nv_bfloat16* dst = job.out + (head * job.len + row) * kD;
    *reinterpret_cast<uint4*>(dst + c) = olo;
    *reinterpret_cast<uint4*>(dst + c + kD / 2) = ohi;
  }
}

template <bool kBackward>
__global__ void __launch_bounds__(kThreads) rope_rotate_kernel(const Job q, const Job k, int q_blocks) {
  const bool is_q = static_cast<int>(blockIdx.x) < q_blocks;
  const int64_t item = static_cast<int64_t>(blockIdx.x - (is_q ? 0 : q_blocks)) * kThreads + threadIdx.x;
  const int head0 = blockIdx.y * kHeadsPerThread;
  if (is_q) {
    if (item < q.items) rotate<kBackward>(q, item, head0);
  } else if (item < k.items) {
    rotate<kBackward>(k, item, head0);
  }
}

Job make_job(const void* x, int64_t sh, int64_t sl, void* out, const void* cos, const void* sin,
             int heads, int len) {
  Job j;
  j.x = static_cast<const __nv_bfloat16*>(x);
  j.sh = sh;
  j.sl = sl;
  j.out = static_cast<__nv_bfloat16*>(out);
  j.cos = static_cast<const float*>(cos);
  j.sin = static_cast<const float*>(sin);
  j.len = len;
  j.heads = heads;
  j.items = static_cast<int64_t>(len) * kChunks;
  return j;
}

template <bool kBackward>
int launch(const void* q, int64_t q_sh, int64_t q_sl, void* q_out, const void* cos_q, const void* sin_q, int lq,
           const void* k, int64_t k_sh, int64_t k_sl, void* k_out, const void* cos_k, const void* sin_k, int lkv,
           int heads, void* stream) {
  const Job qj = make_job(q, q_sh, q_sl, q_out, cos_q, sin_q, heads, lq);
  const Job kj = make_job(k, k_sh, k_sl, k_out, cos_k, sin_k, heads, lkv);
  const int q_blocks = static_cast<int>((qj.items + kThreads - 1) / kThreads);
  const int k_blocks = static_cast<int>((kj.items + kThreads - 1) / kThreads);
  if (q_blocks + k_blocks == 0 || heads == 0) return 0;
  const dim3 grid(q_blocks + k_blocks, (heads + kHeadsPerThread - 1) / kHeadsPerThread);
  rope_rotate_kernel<kBackward><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(qj, kj, q_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes: rotates q (H, lq, 128) with cos_q/sin_q and
// k (H, lkv, 128) with cos_k/sin_k ((L, 128) f32 tables) into the contiguous outputs
// q_out and k_out, in one launch. Strides are in elements. Returns cudaGetLastError()
// after the launch.
extern "C" int rope_rotate_bf16(
    const void* q, int64_t q_sh, int64_t q_sl, void* q_out, const void* cos_q, const void* sin_q, int lq,
    const void* k, int64_t k_sh, int64_t k_sl, void* k_out, const void* cos_k, const void* sin_k, int lkv,
    int heads, void* stream) {
  return launch<false>(q, q_sh, q_sl, q_out, cos_q, sin_q, lq, k, k_sh, k_sl, k_out, cos_k, sin_k, lkv,
                       heads, stream);
}

// The backward build, bound the same way: gq (H, lq, 128) and gk (H, lkv, 128), the
// gradients of the rotated q and k (strided views with a contiguous last dimension
// allowed), into the contiguous dq and dk, with the forward's tables, in one launch.
extern "C" int rope_rotate_backward_bf16(
    const void* gq, int64_t q_sh, int64_t q_sl, void* dq, const void* cos_q, const void* sin_q, int lq,
    const void* gk, int64_t k_sh, int64_t k_sl, void* dk, const void* cos_k, const void* sin_k, int lkv,
    int heads, void* stream) {
  return launch<true>(gq, q_sh, q_sl, dq, cos_q, sin_q, lq, gk, k_sh, k_sl, dk, cos_k, sin_k, lkv,
                      heads, stream);
}
