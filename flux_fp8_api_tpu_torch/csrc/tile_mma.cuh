// Tile shape and warp-level helpers shared by the attention kernels of this directory:
// 64-row tiles of 128-wide bf16 heads in padded shared memory, ldmatrix fragment
// loads and mma.sync m16n8k16 (bf16 operands, f32 accumulators).

#pragma once

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
constexpr int kSmemBytes = 3 * kBlockQ * kLd * 2;  // q, k, v tiles in bf16

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

// This warp's 16 rows of a staged 64 x 128 tile as the A fragments of the 8 k-steps
// over d.
__device__ __forceinline__ void load_a_fragments(uint32_t (&a)[kD / 16][4],
                                                 const __nv_bfloat16* tile, int warp, int lane) {
  const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
  const int cofs = (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldmatrix_x4(a[kk][0], a[kk][1], a[kk][2], a[kk][3], smem_u32(tile + r * kLd + kk * 16 + cofs));
}

// s = q k^T for this warp's 16 q rows x the 64 rows of the staged k tile: 8 n-tiles of
// 8 columns, f32.
__device__ __forceinline__ void qk_tile(float (&s)[kBlockKV / 8][4], const uint32_t (&qa)[kD / 16][4],
                                        const __nv_bfloat16* sk, int lane) {
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
}

// acc += bf16(p) v over the 64 rows of the staged v tile: the score accumulators of
// n-tiles 2kk, 2kk+1 are exactly the A fragment of k-step kk, so p goes from registers
// to the tensor cores without touching shared memory.
__device__ __forceinline__ void pv_tile(float (&acc)[kD / 8][4], const float (&p)[kBlockKV / 8][4],
                                        const __nv_bfloat16* sv, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBlockKV / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
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

}  // namespace
