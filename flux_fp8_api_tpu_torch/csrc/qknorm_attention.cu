// Max-free qk-norm attention for Hopper (sm_90a): TMA-fed, warp-specialised wgmma.
//
// Replaces the TPU Pallas kernel flux_fp8_api_tpu/ops/attention_kernel.py:qknorm_attention
// in its three builds, and the measurement kernel ablate_attention.py:_bare_two_dot as a
// fourth. Same function, on q and k that the rope pass (rope_rotate.cu) has already
// rotated:
//   s   = q . k^T                         f32 accumulate of bf16 operands
//   p   = exp2(s * sm_scale * log2e - SHIFT * log2e)
//                                         f32; kv columns >= Lkv masked to 0
//   den = sum_j p                         f32, from the unrounded p
//   acc = bf16(p) . v                     f32 accumulate
//   out = acc / max(den, 1e-30)           rows whose logits all underflow give 0, not NaN
// FLUX RMS-norms q and k per head, so |logit| stays far inside the exp range: there is
// no running max, so no rescale of acc, which is the whole correction step of an online
// softmax (FlashAttention-3's included).
//
// Builds (one template body, each build its own __global__ kernel):
//   serving  Build::kServing  the function above;
//   stats    Build::kStats    also max |s| * |sm_scale| over the whole call into one f32
//                             (the guard rail's input; masked columns count as 0, a NaN
//                             logit makes the max NaN);
//   ablate   Build::kAblate   p = s * sm_scale - SHIFT with no exp, for measuring the exp's
//                             cost; everything else unchanged. Not a softmax;
//   bare     Build::kBare     the two products alone, the ceiling the others are measured
//                             against (JAX ablate_attention.py:_bare_two_dot):
//                               out = bf16(sum_kv bf16(q . k^T) . v)
//                             no scale, exp, mask, den or division: the f32 S fragments
//                             are packed to bf16 A fragments as they stand. It needs no
//                             mask past Lkv: TMA fills k and v rows past the sequence
//                             with zeros, so those s are exactly 0 and multiply zero v
//                             rows. Same CTA, pipeline and products as the serving build.
//
// What bounds it on the H100: at L = 4608 with 24 heads of 128 a call does
// 4 * 24 * 4608^2 * 128 = 261 GFLOP and moves about 113 MB (q, k, v in, out written), so
// it is bound by the tensor cores (0.264 ms at 989 TFLOP/s), not by memory (~35 us).
// The design feeds the tensor cores the Hopper way:
//   - one CTA per (head, BLOCK_Q-row q tile), BLOCK_Q / 64 + 1 warpgroups. Warpgroup 0
//     is the producer: one thread issues TMA loads of the q tile (once) and of a
//     STAGES-deep ring of BLOCK_KV-row k and v tiles, and gives its registers to the
//     consumers (setmaxnreg 24). The other warpgroups are the consumers, 64 q rows
//     each;
//   - every tile lands in shared memory 128-byte swizzled, as two boxes of 64 head
//     columns (128 bytes each), which is the layout wgmma reads without bank conflicts;
//     q has its own TMA box (BLOCK_Q rows), k and v theirs (BLOCK_KV rows);
//   - S = Q K^T is 8 wgmma.m64nBLOCK_KVk16 from shared memory (both operands K-major),
//     f32 S in registers; O += P V is BLOCK_KV / 16 wgmma.m64n128k16 with P from
//     registers (the f32 S accumulator of columns [16j, 16j + 16) is exactly the A
//     fragment of k-step j) and V from shared memory read MN-major (the transpose bit);
//   - k and v have separate full barriers, so Q K^T starts before V lands; each stage
//     has one empty barrier, which every consumer warp arrives on after its P V.
// The scores never leave registers. The tensor maps are 3-D (head dim, rows, heads)
// with the caller's byte strides, so head-folded strided views of the activations are
// read without a copy, and rows past the sequence (the ragged last kv tile, the last q
// tile) arrive as zeros; p is still masked there, since exp(-SHIFT) != 0, and q rows
// past Lq are never written.
//
// The tile (BLOCK_Q, BLOCK_KV, STAGES) is a compile-time choice: this one source is
// compiled once per tile of ops/attention_kernel.py:TILES, with -D macros naming the
// tile and giving its extern "C" entry points their suffix (qknorm_attention_bf16_64x128x2),
// and ops/attention.py's autotuner picks a tile per shape by measuring them (the Pallas
// kernel takes block_q / block_kv the same way). What a tile trades, with 132 SMs:
//   BLOCK_Q 128: 384 threads, one CTA per SM (registers: 168 at launch, producer 24,
//     consumers 240; 128 * 24 + 256 * 240 = 64512 of 65536), two consumer warpgroups
//     whose softmax and products interleave. 24 heads at L = 1536 make 288 CTAs, 2.18
//     waves, the last 18% full.
//   BLOCK_Q 64: 256 threads, one consumer warpgroup, twice the CTAs, so a ragged last
//     wave costs half as much, but the k and v tiles are read from L2 once per 64 q
//     rows instead of 128. Where two CTAs fit an SM's shared memory (~113 KB each:
//     (64, 64, 2) at 82 KB) they are launched two per SM (128 registers at launch,
//     producer 24, consumer 232: 128 * 24 + 128 * 232 = 32768, half the file), so two
//     consumer warpgroups of two CTAs interleave as (128, *)'s do. (64, 128, 2) at
//     146 KB runs one CTA per SM with one consumer warpgroup, bounded at 255 registers
//     (ptxas gives it 154-158) with no setmaxnreg; bounded to 128, its S and O tiles
//     spilled and it ran 2-3x slower (NVIDIA H100 80GB HBM3, 700 W).
//   BLOCK_KV 64: the S tile is 32 f32 registers per thread instead of 64, and a stage
//     16 KB instead of 32 for each of k and v, at twice the barrier round trips per row.
// Every tile gives the same output, bit for bit: a row's den and O sum the same pairs
// of kv columns, and the same k-steps of wgmma, in the same order whatever the tile cuts
// them into, and a row's arithmetic never depends on the other rows of its CTA (the
// builds at every tile equal (128, 128)'s on the card), and (128, 128, 2) gives the
// single-tile kernel's output bit for bit (chip_smoke.py:SINGLE_TILE_OUTPUTS).
//
// The stats build's max crosses CTAs, which run in no order: each consumer thread keeps
// a running fmaxf of |s| over its unmasked fragments, warps reduce with shuffles, the
// consumer warps through shared memory, and one thread per CTA does an atomicMax on
// the int bits of the (non-negative) float, whose order is the float order. fmaxf drops
// a NaN, so NaN comes in through den instead: an unmasked NaN logit makes p, and so its
// row's den, NaN, and a row whose den is NaN sets the thread's max to NaN before the
// reductions, which keep it (nan_max). A NaN has larger bits than +inf, so it also wins
// the atomicMax.
//
// The serving and stats builds must give the same output bit for bit, so the softmax
// and epilogue arithmetic is written with explicit rounding intrinsics: no contraction
// choice of the compiler can differ between the two instantiations.

#include <cuda.h>  // CUtensorMap and the driver's cuTensorMapEncodeTiled (via the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The tile this compilation builds (ops/attention_kernel.py passes all four).
#ifndef FLUX_BLOCK_Q
#define FLUX_BLOCK_Q 128
#endif
#ifndef FLUX_BLOCK_KV
#define FLUX_BLOCK_KV 128
#endif
#ifndef FLUX_STAGES
#define FLUX_STAGES 2
#endif
#ifndef FLUX_TILE_SUFFIX
#define FLUX_TILE_SUFFIX _128x128x2
#endif
#define FLUX_CAT_(a, b) a##b
#define FLUX_CAT(a, b) FLUX_CAT_(a, b)
#define FLUX_TILED(name) FLUX_CAT(name, FLUX_TILE_SUFFIX)

namespace {

constexpr float kShift = 20.0f;  // ops/attention_kernel.py SHIFT
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kD = 128;       // head dim
constexpr int kBoxCols = 64;  // head columns per TMA box: 128 bytes, the swizzle span

template <int kBlockQ, int kBlockKV, int kStages>
struct alignas(1024) Smem {
  __nv_bfloat16 q[kBlockQ * kD];               // box 0 (columns 0..63), then box 1
  __nv_bfloat16 k[kStages][kBlockKV * kD];
  __nv_bfloat16 v[kStages][kBlockKV * kD];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
  float warp_max[kBlockQ / 64 * 4];            // stats build
};

// One tile: q rows per CTA, kv rows per stage, ring depth, and what follows from them.
template <int kBlockQ_, int kBlockKV_, int kStages_>
struct Tile {
  static constexpr int kBlockQ = kBlockQ_;
  static constexpr int kBlockKV = kBlockKV_;
  static constexpr int kStages = kStages_;
  static constexpr int kConsumers = kBlockQ / 64;           // consumer warpgroups, 64 q rows each
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kQBoxBytes = kBlockQ * kBoxCols * 2;   // one box of the q tile
  static constexpr int kKVBoxBytes = kBlockKV * kBoxCols * 2; // one box of a k or v tile
  static constexpr int kSmemBytes = sizeof(Smem<kBlockQ, kBlockKV, kStages>) + 1024;  // + room to align to 1024
  // CTAs per SM in the launch bounds: two where one consumer warpgroup's CTA leaves room
  // for a second in the SM's 228 KB (each CTA also takes 1 KB the runtime reserves)
  static constexpr int kCtasPerSm = (kConsumers == 1 && 2 * (kSmemBytes + 1024) <= 233472) ? 2 : 1;
  // Registers: ptxas fits every kernel in the launch bounds' share (168 a thread at 384
  // threads, 128 at two CTAs of 256). Where that share is below what a consumer asks
  // for, the producer gives its registers to the consumers with setmaxnreg, and the
  // pool at launch must hold what they ask for, or the consumers' inc never returns
  // (launch() checks it on the card). One consumer alone on an SM has 255 already.
  static constexpr bool kSetMaxNReg = kConsumers > 1 || kCtasPerSm > 1;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 1 ? 232 : 240;
  static constexpr int kPoolRegs = kSetMaxNReg ? kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers : 0;
  static_assert(kBlockQ == 64 || kBlockQ == 128, "BLOCK_Q is 64 per consumer warpgroup, one or two of them");
  static_assert(kBlockKV == 64 || kBlockKV == 128, "the S tile is one wgmma of n = BLOCK_KV");
  static_assert(kStages >= 2, "the ring needs a stage to load while one is read");
  static_assert(kPoolRegs <= 65536 / kCtasPerSm, "setmaxnreg asks for more registers than launch holds");
  static_assert(kSmemBytes <= 232448, "more shared memory than a CTA can have");
};

using TileT = Tile<FLUX_BLOCK_Q, FLUX_BLOCK_KV, FLUX_STAGES>;

struct Args {
  __nv_bfloat16* o;
  int64_t o_sh, o_sl;  // head / row strides of the output (elements)
  int lq, lkv;
  float scale_log2;    // sm_scale * log2(e)
  float scale;         // sm_scale (ablate and stats builds)
  float* max_logit;    // stats build: zeroed f32 scalar on the device
};

// ---------------------------------------------------------------- PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait that has not
// ended after 2^28 tries (seconds; a tile takes microseconds) is a fault in the
// pipeline: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

// One TMA box (kBoxCols columns x the map's box rows x 1 head) at element coordinates
// (col, row, head).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(col), "r"(row), "r"(head)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (layout type 1).
// lbo/sbo in bytes: K-major operands use sbo = 1024 (the next 8 rows) and no lbo;
// MN-major ones lbo = the next 64 MN columns, sbo = the next 8 K rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of accumulator registers across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define D32_OPERANDS(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define D64_OPERANDS(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),            \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),            \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),            \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
      "+f"(d[62]), "+f"(d[63])

// d (+)= A B for a 64 x N x 16 step (N = 2 * the registers of d: 128 or 64, the S tile
// of BLOCK_KV = N), A and B from shared memory, both K-major. accumulate = 0 overwrites d.
template <int R>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t a, uint64_t b, int accumulate) {
  static_assert(R == 64 || R == 32, "an S tile of 128 or 64 kv columns");
  if constexpr (R == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : D64_OPERANDS(d)
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : D32_OPERANDS(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d += A B for a 64 x 128 x 16 step, A from registers (bf16 pairs), B from shared
// memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef D32
#undef D32_OPERANDS
#undef D64
#undef D64_OPERANDS

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// max that keeps a NaN from either side (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

// ---------------------------------------------------------------- the body

enum class Build { kServing, kStats, kAblate, kBare };

template <class T, Build kBuild>
__device__ __forceinline__ void attention(const CUtensorMap* qm, const CUtensorMap* km,
                                          const CUtensorMap* vm, const Args& args) {
  constexpr bool kTrackMax = kBuild == Build::kStats;
  constexpr bool kAblateExp = kBuild == Build::kAblate;
  constexpr bool kBare = kBuild == Build::kBare;
  constexpr int kBlockQ = T::kBlockQ, kBlockKV = T::kBlockKV, kStages = T::kStages;
  constexpr int kConsumers = T::kConsumers;
  using SmemT = Smem<kBlockQ, kBlockKV, kStages>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  SmemT& sm = *reinterpret_cast<SmemT*>(smem_raw + ((1024 - (raw & 1023)) & 1023));

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tiles = (args.lkv + kBlockKV - 1) / kBlockKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    if constexpr (T::kSetMaxNReg) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(T::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, 2 * T::kQBoxBytes);
      tma_load(sm.q, qm, &sm.q_full, 0, q0, head);
      tma_load(sm.q + kBlockQ * kBoxCols, qm, &sm.q_full, kBoxCols, q0, head);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % kStages;
        // the stage's previous tile (use i / kStages - 1) must be released first
        if (i >= kStages) mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        const int kv0 = i * kBlockKV;
        mbar_expect_tx(&sm.k_full[s], 2 * T::kKVBoxBytes);
        tma_load(sm.k[s], km, &sm.k_full[s], 0, kv0, head);
        tma_load(sm.k[s] + kBlockKV * kBoxCols, km, &sm.k_full[s], kBoxCols, kv0, head);
        mbar_expect_tx(&sm.v_full[s], 2 * T::kKVBoxBytes);
        tma_load(sm.v[s], vm, &sm.v_full[s], 0, kv0, head);
        tma_load(sm.v[s] + kBlockKV * kBoxCols, vm, &sm.v_full[s], kBoxCols, kv0, head);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    if constexpr (T::kSetMaxNReg) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(T::kConsumerRegs) : "memory");
    const int cw = wg - 1;  // q rows cw * 64 .. + 63 of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;  // column pair within an 8-column chunk

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float den0 = 0.f, den1 = 0.f;  // rows g and g + 8 of this warp, partial over t
    float amax = 0.f;              // stats build: max |s| over this thread's fragments
    const float shift_log2 = kShift * kLog2e;

    // A operand rows of this warpgroup: 64 rows x 128 B = 8 KB into each q box
    const uint32_t q_addr = smem_u32(sm.q) + cw * 64 * 128;
    mbar_wait(&sm.q_full, 0);

    for (int i = 0; i < tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int kv0 = i * kBlockKV;
      const uint32_t k_addr = smem_u32(sm.k[s]);
      const uint32_t v_addr = smem_u32(sm.v[s]);

      // S = Q K^T: k-step kk covers head columns 16kk .. +15, 32 bytes into box kk / 4
      float sacc[kBlockKV / 2];
      mbar_wait(&sm.k_full[s], parity);
      wgmma_fence();
      fence_regs(sacc);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(sacc, desc_sw128(q_addr + (kk / 4) * T::kQBoxBytes + col, 16, 1024),
                 desc_sw128(k_addr + (kk / 4) * T::kKVBoxBytes + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // p = exp2(s * scale * log2e - SHIFT * log2e), masked past lkv; den from the f32 p.
      // sacc[4j + e]: row g + 8 * (e / 2), column kv0 + 8j + 2t + (e % 2).
      // The bare build keeps p = s.
      if constexpr (!kBare) {
        const bool tail = kv0 + kBlockKV > args.lkv;
#pragma unroll
        for (int j = 0; j < kBlockKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p;
            if constexpr (kAblateExp) {
              p = __fmaf_rn(sacc[4 * j + e], args.scale, -kShift);
            } else {
              p = exp2f(__fmaf_rn(sacc[4 * j + e], args.scale_log2, -shift_log2));
            }
            if (tail && kv0 + j * 8 + 2 * t + (e & 1) >= args.lkv) {
              p = 0.f;
            } else if constexpr (kTrackMax) {
              amax = fmaxf(amax, fabsf(sacc[4 * j + e]));
            }
            sacc[4 * j + e] = p;
          }
          den0 = __fadd_rn(den0, __fadd_rn(sacc[4 * j], sacc[4 * j + 1]));
          den1 = __fadd_rn(den1, __fadd_rn(sacc[4 * j + 2], sacc[4 * j + 3]));
        }
      }

      // O += bf16(P) V: k-step j covers kv rows 16j .. +15 (2 KB into each v box); the
      // 64 MN columns of box 1 are one box on (lbo), the next 8 kv rows 1 KB on (sbo)
      uint32_t pa[kBlockKV / 16][4];
#pragma unroll
      for (int j = 0; j < kBlockKV / 16; ++j) {
        pa[j][0] = pack_bf16(sacc[8 * j + 0], sacc[8 * j + 1]);
        pa[j][1] = pack_bf16(sacc[8 * j + 2], sacc[8 * j + 3]);
        pa[j][2] = pack_bf16(sacc[8 * j + 4], sacc[8 * j + 5]);
        pa[j][3] = pack_bf16(sacc[8 * j + 6], sacc[8 * j + 7]);
      }
      mbar_wait(&sm.v_full[s], parity);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < kBlockKV / 16; ++j)
        wgmma_rs(acc, pa[j], desc_sw128(v_addr + j * 16 * 128, T::kKVBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;
    const int row1 = row0 + 8;
    __nv_bfloat16* oh = args.o + head * args.o_sh;
    if constexpr (kBare) {  // out = bf16(acc), rows past lq not written
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int c = j * 8 + 2 * t;
        if (row0 < args.lq)
          *reinterpret_cast<uint32_t*>(oh + row0 * args.o_sl + c) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (row1 < args.lq)
          *reinterpret_cast<uint32_t*>(oh + row1 * args.o_sl + c) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else {
      // den: sum the four partials of each row (lanes 4g .. 4g+3)
      den0 = __fadd_rn(den0, __shfl_xor_sync(0xffffffffu, den0, 1));
      den0 = __fadd_rn(den0, __shfl_xor_sync(0xffffffffu, den0, 2));
      den1 = __fadd_rn(den1, __shfl_xor_sync(0xffffffffu, den1, 1));
      den1 = __fadd_rn(den1, __shfl_xor_sync(0xffffffffu, den1, 2));

      if constexpr (kTrackMax) {
        if (den0 != den0 || den1 != den1) amax = __int_as_float(0x7fc00000);  // a NaN logit
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        if (lane == 0) sm.warp_max[cw * 4 + warp] = amax;
        asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 128) : "memory");  // consumers only
        if (threadIdx.x == 128) {
          float m = sm.warp_max[0];
#pragma unroll
          for (int w = 1; w < kConsumers * 4; ++w) m = nan_max(m, sm.warp_max[w]);
          // max(x_i) * c == max(x_i * c) for c >= 0, so scaling once per CTA is exact
          atomicMax(reinterpret_cast<int*>(args.max_logit), __float_as_int(m * fabsf(args.scale)));
        }
      }

      const float inv0 = __frcp_rn(fmaxf(den0, 1e-30f));
      const float inv1 = __frcp_rn(fmaxf(den1, 1e-30f));
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int c = j * 8 + 2 * t;
        if (row0 < args.lq)
          *reinterpret_cast<uint32_t*>(oh + row0 * args.o_sl + c) =
              pack_bf16(__fmul_rn(acc[4 * j], inv0), __fmul_rn(acc[4 * j + 1], inv0));
        if (row1 < args.lq)
          *reinterpret_cast<uint32_t*>(oh + row1 * args.o_sl + c) =
              pack_bf16(__fmul_rn(acc[4 * j + 2], inv1), __fmul_rn(acc[4 * j + 3], inv1));
      }
    }
  }
}

__global__ void __launch_bounds__(TileT::kThreads, TileT::kCtasPerSm)
    qknorm_attention_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm, const Args args) {
  attention<TileT, Build::kServing>(&qm, &km, &vm, args);
}

__global__ void __launch_bounds__(TileT::kThreads, TileT::kCtasPerSm)
    qknorm_attention_stats_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                                  const __grid_constant__ CUtensorMap vm, const Args args) {
  attention<TileT, Build::kStats>(&qm, &km, &vm, args);
}

__global__ void __launch_bounds__(TileT::kThreads, TileT::kCtasPerSm)
    qknorm_attention_ablate_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                                   const __grid_constant__ CUtensorMap vm, const Args args) {
  attention<TileT, Build::kAblate>(&qm, &km, &vm, args);
}

__global__ void __launch_bounds__(TileT::kThreads, TileT::kCtasPerSm)
    bare_two_dot_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                        const __grid_constant__ CUtensorMap vm, const Args args) {
  attention<TileT, Build::kBare>(&qm, &km, &vm, args);
}

// ---------------------------------------------------------------- host side

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library needs no
// -lcuda at link time.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// params: dims (head dim, rows, heads), byte strides (rows, heads), box (columns, rows,
// heads), as ops/attention_kernel.py:tma_params computes them. The box must be the one
// the kernel's shared-memory layout is built for: `rows` rows (BLOCK_Q for q, BLOCK_KV
// for k and v) of 64 columns of one head.
bool encode_map(CUtensorMap* map, const void* base, const int64_t* params, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(params[0]), static_cast<cuuint64_t>(params[1]),
                              static_cast<cuuint64_t>(params[2])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(params[3]), static_cast<cuuint64_t>(params[4])};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(params[5]), static_cast<cuuint32_t>(params[6]),
                             static_cast<cuuint32_t>(params[7])};
  const cuuint32_t unit[3] = {1, 1, 1};
  EncodeTiled encode = encoder();
  if (encode == nullptr || dims[0] != kD || box[0] != kBoxCols || box[1] != static_cast<cuuint32_t>(rows) ||
      box[2] != 1)
    return false;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_maps(CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm, const void* q, const void* k, const void* v,
                 const int64_t* q_map, const int64_t* k_map, const int64_t* v_map) {
  return encode_map(qm, q, q_map, TileT::kBlockQ) && encode_map(km, k, k_map, TileT::kBlockKV) &&
         encode_map(vm, v, v_map, TileT::kBlockKV);
}

using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const Args);

// Configures a kernel once (its dynamic shared memory; a check that the registers it was
// given at launch hold what setmaxnreg will ask for, so a wrong launch bound is refused
// here instead of hanging the consumers), then launches it on `stream`.
int launch(Kernel kernel, bool& configured, const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, const Args& args, int heads, cudaStream_t stream) {
  if (!configured) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * TileT::kThreads < TileT::kPoolRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TileT::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((args.lq + TileT::kBlockQ - 1) / TileT::kBlockQ, heads);
  kernel<<<grid, TileT::kThreads, TileT::kSmemBytes, stream>>>(qm, km, vm, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points of this tile, bound with ctypes; each name carries the tile's
// suffix (qknorm_attention_bf16_128x128x2). Pointers are device pointers. q_map, k_map
// and v_map are 8 int64 each: the TMA parameters of ops/attention_kernel.py:tma_params,
// q's with BLOCK_Q box rows, k's and v's with BLOCK_KV. o is written at (head, row)
// strides o_sh, o_sl (elements). A non-null max_logit selects the stats build (it must
// point at a zeroed f32 on the device, written on the same stream); ablate_exp != 0
// selects the ablate build; the two do not combine. Returns 0, a cudaError_t of the
// launch, or cudaErrorInvalidValue where a tensor map cannot be encoded.
extern "C" int FLUX_TILED(qknorm_attention_bf16)(
    const void* q, const void* k, const void* v, void* o,
    const int64_t* q_map, const int64_t* k_map, const int64_t* v_map,
    int64_t o_sh, int64_t o_sl, int heads, int lq, int lkv, float sm_scale,
    void* max_logit, int ablate_exp, void* stream) {
  if (max_logit != nullptr && ablate_exp) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!encode_maps(&qm, &km, &vm, q, k, v, q_map, k_map, v_map)) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.o = static_cast<__nv_bfloat16*>(o);
  args.o_sh = o_sh;
  args.o_sl = o_sl;
  args.lq = lq;
  args.lkv = lkv;
  args.scale_log2 = sm_scale * kLog2e;
  args.scale = sm_scale;
  args.max_logit = static_cast<float*>(max_logit);
  static bool configured[3] = {false, false, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_logit != nullptr) return launch(qknorm_attention_stats_kernel, configured[1], qm, km, vm, args, heads, s);
  if (ablate_exp) return launch(qknorm_attention_ablate_kernel, configured[2], qm, km, vm, args, heads, s);
  return launch(qknorm_attention_kernel, configured[0], qm, km, vm, args, heads, s);
}

// The bare build (the ablation's ceiling) of this tile: o = bf16(bf16(q k^T) v) per
// head, written at (head, row) strides o_sh, o_sl (elements). Maps and return value as
// above.
extern "C" int FLUX_TILED(bare_two_dot_bf16)(
    const void* q, const void* k, const void* v, void* o,
    const int64_t* q_map, const int64_t* k_map, const int64_t* v_map,
    int64_t o_sh, int64_t o_sl, int heads, int lq, int lkv, void* stream) {
  CUtensorMap qm, km, vm;
  if (!encode_maps(&qm, &km, &vm, q, k, v, q_map, k_map, v_map)) return static_cast<int>(cudaErrorInvalidValue);
  Args args = {};
  args.o = static_cast<__nv_bfloat16*>(o);
  args.o_sh = o_sh;
  args.o_sl = o_sl;
  args.lq = lq;
  args.lkv = lkv;
  static bool configured = false;
  return launch(bare_two_dot_kernel, configured, qm, km, vm, args, heads, static_cast<cudaStream_t>(stream));
}
