// Max-free qk-norm attention with fused half-split RoPE, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel flux_fp8_api_tpu/ops/attention_kernel.py:qknorm_attention
// (serving build). Same function:
//   s   = rope(q) . rope(k)^T            f32 accumulate of bf16 operands
//   p   = exp(s * sm_scale - SHIFT)       f32; kv columns >= Lkv masked to 0
//   den = sum_j p                         f32, from the unrounded p
//   acc = bf16(p) . v                     f32 accumulate
//   out = acc / max(den, 1e-30)           rows whose logits all underflow give 0, not NaN
// FLUX RMS-norms q and k per head, so |logit| stays far inside the exp range and no
// running max (and no rescaling of acc) is needed.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;          // head dim
constexpr int kBlockQ = 64;      // q rows per block
constexpr int kBlockKV = 64;     // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;      // padded smem row (272 B): conflict-free ldmatrix
constexpr float kShift = 20.0f;  // ops/attention_kernel.py SHIFT
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemBytes = 3 * kBlockQ * kLd * 2;  // q, k, v tiles in bf16

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
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a * b for one m16n8k16 tile, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Stage a 64 x 128 tile (rows row0.. of one head) into shared memory as bf16, rotating
// it with the half-split rope tables when cos != nullptr. Rows at or past `len` are
// zero. Each thread moves 8 channels of the first half together with the matching 8 of
// the second half, since rotation pairs channel j with j + 64.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* smem, const __nv_bfloat16* src,
                                           int64_t row_stride, int row0, int len,
                                           const float* cos, const float* sin) {
  constexpr int kChunks = kD / 2 / 8;  // 8-channel chunks per half row
  for (int idx = threadIdx.x; idx < kBlockQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
    if (row < len) {
      const __nv_bfloat16* p = src + row * row_stride;
      lo = *reinterpret_cast<const uint4*>(p + c);
      hi = *reinterpret_cast<const uint4*>(p + c + kD / 2);
      if (cos != nullptr) {
        const float* cr = cos + static_cast<int64_t>(row) * kD;
        const float* sr = sin + static_cast<int64_t>(row) * kD;
        const __nv_bfloat16* xl = reinterpret_cast<const __nv_bfloat16*>(&lo);
        const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(&hi);
        float cl[8], sl[8], ch[8], sh[8];
        *reinterpret_cast<float4*>(cl) = *reinterpret_cast<const float4*>(cr + c);
        *reinterpret_cast<float4*>(cl + 4) = *reinterpret_cast<const float4*>(cr + c + 4);
        *reinterpret_cast<float4*>(sl) = *reinterpret_cast<const float4*>(sr + c);
        *reinterpret_cast<float4*>(sl + 4) = *reinterpret_cast<const float4*>(sr + c + 4);
        *reinterpret_cast<float4*>(ch) = *reinterpret_cast<const float4*>(cr + c + kD / 2);
        *reinterpret_cast<float4*>(ch + 4) = *reinterpret_cast<const float4*>(cr + c + kD / 2 + 4);
        *reinterpret_cast<float4*>(sh) = *reinterpret_cast<const float4*>(sr + c + kD / 2);
        *reinterpret_cast<float4*>(sh + 4) = *reinterpret_cast<const float4*>(sr + c + kD / 2 + 4);
        uint4 olo, ohi;
        uint32_t* ol = reinterpret_cast<uint32_t*>(&olo);
        uint32_t* oh = reinterpret_cast<uint32_t*>(&ohi);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float a0 = __bfloat162float(xl[e]), a1 = __bfloat162float(xl[e + 1]);
          const float b0 = __bfloat162float(xh[e]), b1 = __bfloat162float(xh[e + 1]);
          // out[j] = x[j] cos[j] - x[j+64] sin[j];  out[j+64] = x[j+64] cos[j+64] + x[j] sin[j+64]
          ol[e / 2] = pack_bf16(a0 * cl[e] - b0 * sl[e], a1 * cl[e + 1] - b1 * sl[e + 1]);
          oh[e / 2] = pack_bf16(b0 * ch[e] + a0 * sh[e], b1 * ch[e + 1] + a1 * sh[e + 1]);
        }
        lo = olo;
        hi = ohi;
      }
    }
    *reinterpret_cast<uint4*>(smem + r * kLd + c) = lo;
    *reinterpret_cast<uint4*>(smem + r * kLd + c + kD / 2) = hi;
  }
}

__global__ void __launch_bounds__(kThreads)
qknorm_attention_kernel(const Args args) {
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

  // this warp's 16 q rows as A fragments for the 8 k-steps over d
  uint32_t qa[kD / 16][4];
  {
    const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
    const int cofs = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      ldmatrix_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                  smem_u32(sq + r * kLd + kk * 16 + cofs));
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float den0 = 0.f, den1 = 0.f;  // rows g and g + 8 of this warp, partial over t
  const float shift_log2 = kShift * kLog2e;

  for (int kv0 = 0; kv0 < args.lkv; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile's k/v reads are done
    stage_tile(sk, kh, args.k_sl, kv0, args.lkv, args.cos_k, args.sin_k);
    stage_tile(sv, vh, args.v_sl, kv0, args.lkv, nullptr, nullptr);
    __syncthreads();

    // s = q k^T for 16 q rows x 64 kv columns: 8 n-tiles of 8 columns
    float s[kBlockKV / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kBlockKV / 16; ++jp) {
        // two n-tiles: kv rows jp*16 .. +15, d columns kk*16 .. +15
        const int r = jp * 16 + (lane % 8) + (lane / 16) * 8;
        const int c = kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3, smem_u32(sk + r * kLd + c));
        mma_bf16(s[2 * jp], qa[kk], b0, b1);
        mma_bf16(s[2 * jp + 1], qa[kk], b2, b3);
      }
    }

    // p = exp(s * sm_scale - SHIFT), masked past lkv; den from the f32 p
    const bool tail = kv0 + kBlockKV > args.lkv;
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * args.scale_log2 - shift_log2);
        if (tail && kv0 + j * 8 + 2 * t + (e & 1) >= args.lkv) p = 0.f;
        s[j][e] = p;
      }
      den0 += s[j][0] + s[j][1];
      den1 += s[j][2] + s[j][3];
    }

    // acc += bf16(p) v: the score accumulators of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < kD / 16; ++jp) {
        // kv rows kk*16 .. +15 (k), d columns jp*16 .. +15 (two n-tiles), transposed
        const int r = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int c = jp * 16 + (lane / 16) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, smem_u32(sv + r * kLd + c));
        mma_bf16(acc[2 * jp], pa, b0, b1);
        mma_bf16(acc[2 * jp + 1], pa, b2, b3);
      }
    }
  }

  // den: sum the four partials of each row (lanes 4g .. 4g+3)
  den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
  den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 2);
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

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; cos/sin are
// (L, 128) f32 tables or all four null (no rope). Returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.
extern "C" int qknorm_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* cos_q, const void* sin_q, const void* cos_k, const void* sin_k,
    int64_t q_sh, int64_t q_sl, int64_t k_sh, int64_t k_sl,
    int64_t v_sh, int64_t v_sl, int64_t o_sh, int64_t o_sl,
    int heads, int lq, int lkv, float sm_scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        qknorm_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
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
  dim3 grid((lq + kBlockQ - 1) / kBlockQ, heads);
  qknorm_attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
