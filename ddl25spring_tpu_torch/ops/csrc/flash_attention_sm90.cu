// Flash attention for Hopper on the tensor cores: the bf16 forward, dq and dk/dv.
//
// Replaces, for bfloat16 inputs, the three Pallas TPU kernels of
// ddl25spring_tpu/ops/flash_attention.py:
//   flash_fwd_wgmma  <- _fwd_kernel  (launched by _fwd)
//   flash_dq_wgmma   <- _dq_kernel   (launched by _bwd_pallas)
//   flash_dkv_wgmma  <- _dkv_kernel  (launched by _bwd_pallas)
// float32 inputs, and bf16 shapes these kernels do not take, go to the scalar
// kernels of flash_attention.cu; the wrapper (ops/flash_attention.py) picks.
//
// Layout as in flash_attention.cu: q, k, v, o, do, dq, dk, dv are [BH, L, hd]
// bf16, contiguous and 16-byte aligned, hd a multiple of 8 up to 128 (TMA's
// 16-byte stride rule); lse and delta are [BH, Lq] float32.  Causal needs
// Lq == Lk.
//
// What bounds them at the LLaMA path's shape, [18, 256, 48] bf16 causal.  Each
// kernel moves 1.8-2.7 MB, under a microsecond at 3.35 TB/s, and its 0.11-0.23
// GFLOP take a quarter of a microsecond on the tensor cores: bound by bytes
// on paper.  In practice the launch latency and the serial walk of the
// heaviest block bound them: the last Q tile of the forward and of dq (the
// first KV tile of dk/dv) walks four 64-row tiles, each a chain of dependent
// wgmma groups and elementwise work, with one warp per SM sub-partition to
// hide latency.
//
// What the design does about that.
// - Products on the tensor cores: wgmma.mma_async, bf16 in, fp32 accumulate,
//   64-row tiles.  Score-shaped products (s, and dp in the backward) take
//   both operands K-major from shared memory; the second product of each
//   pair takes the probabilities (or ds) from registers, rounded to bf16 as
//   the TPU kernels round them, with the other operand read through the
//   transposed-B descriptor from the tile already in shared memory.
// - Two warpgroups (256 threads) per block split the walk: each takes every
//   other tile with its own accumulators, and they merge at the end (the
//   forward by the log-sum-exp rule, dq and dk/dv by a sum).  That halves
//   the heaviest block's serial walk and gives each SM sub-partition a second
//   warp to issue while the other waits.  No atomics: results are
//   deterministic.
// - Each warpgroup's walked tiles arrive by TMA into its own 2-stage ring of
//   bf16 tiles (128-byte swizzle, zero fill past hd and past L) completing
//   on mbarriers: the next tile is in flight while this one computes, and no
//   thread spends registers or instructions on the copy.  The block's own
//   tiles (q; q and do; k and v) stay resident.  Shared memory is ~75 KB
//   (forward) and ~83 KB (dq, dk/dv) per block at hd <= 64 for two
//   warpgroups, against 66.5 to ~100 KB of fp32 tiles for one block of the
//   scalar kernels.
// - Only the diagonal tile of a causal walk and the ragged last tile compute
//   a mask; every other tile takes the unmasked path.
// - The heaviest causal tiles launch first, so the longest walks start first.
// - The tensor maps are encoded on the host per launch, through the driver
//   entry point that the runtime hands out (no -lcuda); the shared-memory
//   attribute is set once per instantiation and device.

#include <cuda.h>  // CUtensorMap and its enums; the function comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem_optin.cuh"

namespace {

constexpr int TILE = 64;                 // rows of every tile
constexpr int NT = 128;                  // one warpgroup
constexpr int BOX = TILE * 64 * 2;       // bytes of one [64 rows][64 cols] bf16 TMA box
constexpr float NEG_INF = -1e30f;        // the mask value of the reference kernels
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ----------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also tells the barrier how many bytes the TMA will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Row tile `row` of batch bh of two [BH, L, hd] maps into tiles a and b (NB
// 64-column boxes each), both completing on bar.
template <int NB>
__device__ __forceinline__ void load_pair(uint8_t* a, const CUtensorMap* ma, uint8_t* b,
                                          const CUtensorMap* mb, uint64_t* bar, int row, int bh) {
  mbar_expect_tx(bar, 2 * NB * BOX);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    tma_load_3d(a + c * BOX, ma, bar, 64 * c, row, bh);
    tma_load_3d(b + c * BOX, mb, bar, 64 * c, row, bh);
  }
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a tile in shared memory under the 128-byte swizzle:
// start address, leading and stride byte offsets (all >> 4), layout 1 (B128).
// A 64-column bf16 box is 64 rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// k-step kk (16 columns) of a K-major tile: boxes of 64 columns, 32 bytes a step.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * BOX + (kk & 3) * 32, 16, 1024);
}

// k-step kk (16 rows) of box c of a tile read as the transposed (MN-major) B
// operand: its rows are the contraction, its columns the output's.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int c, int kk) {
  return desc_sw128(tile + c * BOX + kk * 16 * 128, 1024, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of a 64x64 product (thread layout of wgmma's D: columns
// 8i + 2(lane % 4) + {0, 1} of rows g and g + 8) read as the A operand of the
// next product, one k-step (16 columns) per entry, rounded to bf16.
__device__ __forceinline__ void to_a_operand(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// ------------------------------------------------------------ wgmma products
// D (+)= A B, M = 64, K = 16, bf16 in, fp32 accumulate (N/2 registers a
// thread).  Inline PTX names every accumulator register, so each shape is
// spelled out.

// D[64xN] += A[64x16] B[16xN]: A from registers (4 x bf16x2 a thread), B the
// transposed (MN-major) tile in shared memory (imm-trans-b = 1).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

// D[64x64] (+)= A[64x16] B[64x16]^T, A and B K-major in shared memory;
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return (uint8_t*)(((uintptr_t)p + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a thread's share of a [64, 16 * ncol] accumulator (rows row0 and
// row0 + 8, columns col0 + 8i + 2(lane % 4)) as bf16 rows of a [L, hd] slab.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], __nv_bfloat16* slab,
                                           int row0, int col0, int L, int hd, float mul0,
                                           float mul1) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= L) continue;
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int col = col0 + 8 * i + cq;  // even; hd is a multiple of 8, so col + 1 < hd too
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(slab + (size_t)row * hd + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h] * mul, acc[4 * i + 2 * h + 1] * mul);
    }
  }
}

// Named barrier of one warpgroup (barrier 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(NT) : "memory");
}

// ------------------------------------------------------------------ forward
// One online-softmax step on a 64x64 score tile, in place: s comes in as
// this thread's q k^T and leaves as p = exp(scale s - m_new) (masked: 0);
// the running max m (log2 units) and sum l are updated, and corr is the
// factor that brings o to the new max.  Only the diagonal tile of a causal
// walk and the ragged last KV tile are MASKED.
template <bool MASKED>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int row0, int k0, int Lk,
                                             int causal, float sl2) {
  const int cq = 2 * (threadIdx.x & 3);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * sl2;
    if (MASKED) {
      const int row = row0 + 8 * ((i >> 1) & 1), col = k0 + 8 * (i >> 2) + cq + (i & 1);
      if (col >= Lk || (causal && col > row)) x = NEG_INF;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    corr[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = (MASKED && s[i] == NEG_INF) ? 0.f : exp2f(s[i] - mx[h]);  // masked adds nothing
    ls[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(ls[h]);
}

// o = softmax(scale q k^T) v and lse = m + log l by the online recurrence.
// Grid (BH, ceil(Lq / 64)); block y = 0 takes the last (heaviest causal) Q
// tile.  NW warpgroups split the tile's KV walk (warpgroup w takes KV tiles
// w, w + NW, ...), each with its own 2-stage K/V ring and its own running
// max, sum and o; warpgroup 0 merges them at the end.  Thread (warp, lane) of
// a warpgroup owns rows 16 warp + lane/4 and 16 warp + lane/4 + 8 of the Q
// tile: its 2 x 16 scores of each KV tile, their max and sum, its share of o.
template <int HDP, int NW>  // hd rounded up to 16; warpgroups per block
__global__ void __launch_bounds__(NW * NT)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int Lq, int Lk, int hd, float scale, int causal) {
  constexpr int NB = HDP > 64 ? 2 : 1;     // 64-column boxes per tile
  constexpr int KS = HDP / 16;             // k-steps of q k^T
  constexpr int N0 = HDP > 64 ? 64 : HDP;  // output columns in box 0
  constexpr int N1 = HDP - N0;             // and in box 1
  constexpr int A1 = N1 > 0 ? N1 / 2 : 2;  // registers of the box-1 accumulator
  constexpr int TB = NB * BOX;             // bytes of one tile
  constexpr int RB = 4 * TB;               // one warpgroup's ring: K and V, 2 stages each
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* rings = sQ + TB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(rings + NW * RB);  // q, then 2 per warpgroup

  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT, warp = wt >> 5, lane = tid & 31;
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const int kv_end = causal ? min(Lk, q0 + TILE) : Lk;
  const int nkv = (kv_end + TILE - 1) / TILE;
  const int mine = nkv > wg ? (nkv - wg + NW - 1) / NW : 0;  // KV tiles this warpgroup walks
  uint8_t* sK = rings + wg * RB;  // 2 stages
  uint8_t* sV = sK + 2 * TB;      // 2 stages
  uint64_t* sbar = bar + 1 + 2 * wg;

  const CUtensorMap *mk = &tk, *mv = &tv;
  auto load_kv = [=](int n) {  // the n-th KV tile of this warpgroup's walk
    const int st = n & 1;
    load_pair<NB>(sK + st * TB, mk, sV + st * TB, mv, &sbar[st], (wg + n * NW) * TILE, bh);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + 2 * NW; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wt == 0) {
    if (wg == 0) {
      mbar_expect_tx(&bar[0], TB);
#pragma unroll
      for (int c = 0; c < NB; ++c) tma_load_3d(sQ + c * BOX, &tq, &bar[0], 64 * c, q0, bh);
    }
    if (mine > 0) load_kv(0);
    if (mine > 1) load_kv(1);
  }

  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const float sl2 = scale * LOG2E;  // scores in log2 units: exp2 of them is exp of scale * qk
  float acc0[N0 / 2], acc1[A1];
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < A1; ++i) acc1[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(sQ);
  if (mine > 0) mbar_wait(&bar[0], 0);

  for (int n = 0; n < mine; ++n) {
    const int st = n & 1, k0 = (wg + n * NW) * TILE;
    const uint32_t ka = smem_u32(sK + st * TB), va = smem_u32(sV + st * TB);
    mbar_wait(&sbar[st], (n >> 1) & 1);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, desc_k(qa, kk), desc_k(ka, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    pin(s);

    float corr[2];
    if ((causal && k0 == q0) || k0 + TILE > Lk)
      softmax_step<true>(s, m, l, corr, row0, k0, Lk, causal, sl2);
    else
      softmax_step<false>(s, m, l, corr, row0, k0, Lk, causal, sl2);
#pragma unroll
    for (int i = 0; i < N0 / 2; ++i) acc0[i] *= corr[(i >> 1) & 1];
    if constexpr (N1 > 0) {
#pragma unroll
      for (int i = 0; i < N1 / 2; ++i) acc1[i] *= corr[(i >> 1) & 1];
    }

    // o += p v with p rounded to bf16, as the TPU kernel rounds it to v's type
    uint32_t pa[4][4];
    to_a_operand(s, pa);
    pin(acc0);
    pin(acc1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<N0>(acc0, pa[kk], desc_mn(va, 0, kk));
      if constexpr (N1 > 0) wgmma_rs<N1>(acc1, pa[kk], desc_mn(va, 1, kk));
    }
    wg_commit();
    wg_wait_all();
    pin(acc0);
    pin(acc1);

    wg_sync(wg);  // every warp of this warpgroup is done reading the stage
    if (wt == 0 && n + 2 < mine) load_kv(n + 2);
  }

  // merge: warpgroups 1.. leave (o, m, l) in their own idle rings, warpgroup
  // 0 rescales everything to the common max
  constexpr int NA = N0 / 2 + A1;  // registers of o a thread holds
  if constexpr (NW > 1) {
    if (wg > 0) {
      float* buf = reinterpret_cast<float*>(rings + wg * RB);
#pragma unroll
      for (int i = 0; i < N0 / 2; ++i) buf[i * NT + wt] = acc0[i];
#pragma unroll
      for (int i = 0; i < A1; ++i) buf[(N0 / 2 + i) * NT + wt] = acc1[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        buf[(NA + h) * NT + wt] = m[h];
        buf[(NA + 2 + h) * NT + wt] = l[h];
      }
    }
    __syncthreads();
    if (wg > 0) return;
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float* buf = reinterpret_cast<const float*>(rings + w * RB);
      float a[2], b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mw = buf[(NA + h) * NT + wt], lw = buf[(NA + 2 + h) * NT + wt];
        const float mn = fmaxf(m[h], mw);
        a[h] = exp2f(m[h] - mn);
        b[h] = exp2f(mw - mn);  // 0 for a warpgroup that walked no tile
        l[h] = l[h] * a[h] + lw * b[h];
        m[h] = mn;
      }
#pragma unroll
      for (int i = 0; i < N0 / 2; ++i)
        acc0[i] = acc0[i] * a[(i >> 1) & 1] + buf[i * NT + wt] * b[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < A1; ++i)
        acc1[i] = acc1[i] * a[(i >> 1) & 1] + buf[(N0 / 2 + i) * NT + wt] * b[(i >> 1) & 1];
    }
  }

  __nv_bfloat16* ob = o + (size_t)bh * Lq * hd;
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  store_rows<N0>(acc0, ob, row0, 0, Lq, hd, inv0, inv1);
  if constexpr (N1 > 0) store_rows<N1>(acc1, ob, row0, 64, Lq, hd, inv0, inv1);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < Lq) lse[(size_t)bh * Lq + row] = (m[h] + log2f(l[h])) * LN2;
    }
  }
}

// ------------------------------------------------------------------------ dq
// dq = sum_j ds k with ds = scale p (dp - delta), dp = do v^T and
// p = exp(scale q k^T - lse), walking the KV tiles up to the diagonal (causal).
// Shaped like the forward: grid (BH, ceil(Lq / 64)), block y = 0 takes the
// last (heaviest causal) Q tile, whose Q and do tiles stay resident; NW
// warpgroups split the KV walk, each with its own 2-stage K/V ring and its own
// partial dq, and warpgroup 0 adds them up at the end.  Thread (warp, lane)
// owns rows 16 warp + lane/4 and + 8 of the Q tile, as in the forward.
// s (the scores) comes in as q k^T and dp as do v^T; dp leaves as ds
// (masked: 0).  Only the diagonal tile of a causal walk and the ragged last
// KV tile are MASKED.
template <bool MASKED>
__device__ __forceinline__ void dq_step(const float (&s)[32], float (&dp)[32],
                                        const float (&lv)[2], const float (&dl)[2], int row0,
                                        int k0, int Lk, int causal, float sl2, float scale) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float p = exp2f(s[i] * sl2 - lv[h]);
    if (MASKED) {
      const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
      if (col >= Lk || (causal && col > row0 + 8 * h)) p = 0.f;
    }
    dp[i] = p * (dp[i] - dl[h]) * scale;
  }
}

template <int HDP, int NW>
__global__ void __launch_bounds__(NW * NT)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int hd, float scale, int causal) {
  constexpr int NB = HDP > 64 ? 2 : 1;
  constexpr int KS = HDP / 16;
  constexpr int N0 = HDP > 64 ? 64 : HDP;
  constexpr int N1 = HDP - N0;
  constexpr int A1 = N1 > 0 ? N1 / 2 : 2;
  constexpr int TB = NB * BOX;
  constexpr int RB = 4 * TB;  // one warpgroup's ring: K and V, 2 stages each
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sO = sQ + TB;  // do
  uint8_t* rings = sO + TB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(rings + NW * RB);  // q/do, then 2 per warpgroup

  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT, warp = wt >> 5, lane = tid & 31;
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const int kv_end = causal ? min(Lk, q0 + TILE) : Lk;
  const int nkv = (kv_end + TILE - 1) / TILE;
  const int mine = nkv > wg ? (nkv - wg + NW - 1) / NW : 0;
  uint8_t* sK = rings + wg * RB;  // 2 stages
  uint8_t* sV = sK + 2 * TB;      // 2 stages
  uint64_t* sbar = bar + 1 + 2 * wg;

  const CUtensorMap *mk = &tk, *mv = &tv;
  auto load_kv = [=](int n) {  // the n-th KV tile of this warpgroup's walk
    const int st = n & 1;
    load_pair<NB>(sK + st * TB, mk, sV + st * TB, mv, &sbar[st], (wg + n * NW) * TILE, bh);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + 2 * NW; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wt == 0) {
    if (wg == 0) load_pair<NB>(sQ, &tq, sO, &tdo, &bar[0], q0, bh);
    if (mine > 0) load_kv(0);
    if (mine > 1) load_kv(1);
  }

  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const float sl2 = scale * LOG2E;
  // lse (in log2 units) and delta of this thread's two rows, by plain loads
  // (a TMA box over the [BH * Lq] vectors would start unaligned for some Lq)
  float lv[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lv[h] = row < Lq ? lse[(size_t)bh * Lq + row] * LOG2E : 0.f;
    dl[h] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.f;
  }
  float acc0[N0 / 2], acc1[A1];
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < A1; ++i) acc1[i] = 0.f;
  const uint32_t qa = smem_u32(sQ), oa = smem_u32(sO);
  if (mine > 0) mbar_wait(&bar[0], 0);

  for (int n = 0; n < mine; ++n) {
    const int st = n & 1, k0 = (wg + n * NW) * TILE;
    const uint32_t ka = smem_u32(sK + st * TB), va = smem_u32(sV + st * TB);
    mbar_wait(&sbar[st], (n >> 1) & 1);

    // s = q k^T and dp = do v^T, one commit group
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, desc_k(qa, kk), desc_k(ka, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(dp, desc_k(oa, kk), desc_k(va, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(dp);

    if ((causal && k0 == q0) || k0 + TILE > Lk)
      dq_step<true>(s, dp, lv, dl, row0, k0, Lk, causal, sl2, scale);
    else
      dq_step<false>(s, dp, lv, dl, row0, k0, Lk, causal, sl2, scale);

    // dq += ds k, ds rounded to bf16 as the TPU kernel rounds it to k's type;
    // k read through the transposed-B descriptor, as the forward reads v
    uint32_t da[4][4];
    to_a_operand(dp, da);
    pin(acc0);
    pin(acc1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<N0>(acc0, da[kk], desc_mn(ka, 0, kk));
      if constexpr (N1 > 0) wgmma_rs<N1>(acc1, da[kk], desc_mn(ka, 1, kk));
    }
    wg_commit();
    wg_wait_all();
    pin(acc0);
    pin(acc1);

    wg_sync(wg);  // every warp of this warpgroup is done reading the stage
    if (wt == 0 && n + 2 < mine) load_kv(n + 2);
  }

  // warpgroups 1.. leave their partial dq in their own idle rings; warpgroup
  // 0 adds them to its own and stores
  if constexpr (NW > 1) {
    if (wg > 0) {
      float* buf = reinterpret_cast<float*>(rings + wg * RB);
#pragma unroll
      for (int i = 0; i < N0 / 2; ++i) buf[i * NT + wt] = acc0[i];
#pragma unroll
      for (int i = 0; i < A1; ++i) buf[(N0 / 2 + i) * NT + wt] = acc1[i];
    }
    __syncthreads();
    if (wg > 0) return;
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float* buf = reinterpret_cast<const float*>(rings + w * RB);
#pragma unroll
      for (int i = 0; i < N0 / 2; ++i) acc0[i] += buf[i * NT + wt];
#pragma unroll
      for (int i = 0; i < A1; ++i) acc1[i] += buf[(N0 / 2 + i) * NT + wt];
    }
  }

  __nv_bfloat16* dqb = dq + (size_t)bh * Lq * hd;
  store_rows<N0>(acc0, dqb, row0, 0, Lq, hd, 1.f, 1.f);
  if constexpr (N1 > 0) store_rows<N1>(acc1, dqb, row0, 64, Lq, hd, 1.f, 1.f);
}

// --------------------------------------------------------------------- dk/dv
// dv = sum_i p^T do and dk = sum_i scale (p (dp - delta))^T q with
// p = exp(scale q k^T - lse), walking the Q tiles from the diagonal (causal).
// Grid (BH, ceil(Lk / 64)); causal KV tile 0 walks every Q tile, so the
// heaviest blocks are the first.  NW warpgroups split the Q walk (warpgroup
// w takes the walk's tiles w, w + NW, ...), each with its own 2-stage ring of
// Q and do and its own partial dk and dv; warpgroup 0 adds them up at the
// end.  Everything is computed transposed (KV rows as M): thread (warp,
// lane) owns KV rows 16 warp + lane/4 (+ 8) of s^T, dp^T and of its dk and dv
// shares; its score columns are query positions.
template <bool MASKED>
__device__ __forceinline__ void dkv_step(float (&s)[32], float (&dp)[32], const float (&lv)[16],
                                         const float (&dl)[16], int krow0, int q0, int Lq,
                                         int Lk, int causal, float sl2, float scale) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int c = 2 * (r >> 2) + (r & 1);  // this element's query column, 0..15
    float p = exp2f(s[r] * sl2 - lv[c]);
    if (MASKED) {
      const int qpos = q0 + 8 * (r >> 2) + cq + (r & 1), kpos = krow0 + 8 * ((r >> 1) & 1);
      if (qpos >= Lq || kpos >= Lk || (causal && kpos > qpos)) p = 0.f;
    }
    s[r] = p;
    dp[r] = p * (dp[r] - dl[c]) * scale;  // ds, from the unrounded p
  }
}

template <int HDP, int NW>
__global__ void __launch_bounds__(NW * NT)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Lq, int Lk,
                int hd, float scale, int causal) {
  constexpr int NB = HDP > 64 ? 2 : 1;
  constexpr int KS = HDP / 16;
  constexpr int N0 = HDP > 64 ? 64 : HDP;
  constexpr int N1 = HDP - N0;
  constexpr int A1 = N1 > 0 ? N1 / 2 : 2;
  constexpr int TB = NB * BOX;
  constexpr int RB = 4 * TB;  // one warpgroup's ring: Q and do, 2 stages each
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + TB;
  uint8_t* rings = sV + TB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(rings + NW * RB);  // k/v, then 2 per warpgroup

  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT, warp = wt >> 5, lane = tid & 31;
  const int bh = blockIdx.x, k0 = blockIdx.y * TILE;
  const int qt0 = causal ? blockIdx.y : 0;     // first Q tile that reaches this KV tile
  const int nq = (Lq + TILE - 1) / TILE - qt0;  // Q tiles walked by the block
  const int mine = nq > wg ? (nq - wg + NW - 1) / NW : 0;
  uint8_t* sQ = rings + wg * RB;  // 2 stages
  uint8_t* sO = sQ + 2 * TB;      // 2 stages of do
  uint64_t* sbar = bar + 1 + 2 * wg;

  const CUtensorMap *mq = &tq, *mo = &tdo;
  auto load_q = [=](int n) {  // the n-th Q tile of this warpgroup's walk
    const int st = n & 1;
    load_pair<NB>(sQ + st * TB, mq, sO + st * TB, mo, &sbar[st], (qt0 + wg + n * NW) * TILE, bh);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + 2 * NW; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wt == 0) {
    if (wg == 0) load_pair<NB>(sK, &tk, sV, &tv, &bar[0], k0, bh);
    if (mine > 0) load_q(0);
    if (mine > 1) load_q(1);
  }

  const int krow0 = k0 + warp * 16 + (lane >> 2);  // and krow0 + 8
  const int cq = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  float dk0[N0 / 2], dv0[N0 / 2], dk1[A1], dv1[A1];
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) dk0[i] = dv0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < A1; ++i) dk1[i] = dv1[i] = 0.f;
  const uint32_t ka = smem_u32(sK), va = smem_u32(sV);
  const float* lse_b = lse + (size_t)bh * Lq;
  const float* delta_b = delta + (size_t)bh * Lq;
  if (mine > 0) mbar_wait(&bar[0], 0);

  for (int n = 0; n < mine; ++n) {
    const int st = n & 1, q0 = (qt0 + wg + n * NW) * TILE;
    const uint32_t qa = smem_u32(sQ + st * TB), oa = smem_u32(sO + st * TB);
    mbar_wait(&sbar[st], (n >> 1) & 1);

    // s^T = k q^T and dp^T = v do^T, one commit group
    float s[32], dp[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, desc_k(ka, kk), desc_k(qa, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(dp, desc_k(va, kk), desc_k(oa, kk), kk > 0);
    wg_commit();
    // while the tensor cores work: lse (in log2 units) and delta of this
    // thread's 16 query columns, straight from global memory.  (A TMA box
    // of a [BH * Lq] vector must start 16-byte aligned, which a row offset
    // bh * Lq + q0 is not for every Lq.)
    float lv[16], dl[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int qpos = q0 + 8 * (c >> 1) + cq + (c & 1);
      lv[c] = qpos < Lq ? lse_b[qpos] * LOG2E : 0.f;
      dl[c] = qpos < Lq ? delta_b[qpos] : 0.f;
    }
    wg_wait_all();
    pin(s);
    pin(dp);

    if ((causal && q0 == k0) || q0 + TILE > Lq || k0 + TILE > Lk)
      dkv_step<true>(s, dp, lv, dl, krow0, q0, Lq, Lk, causal, sl2, scale);
    else
      dkv_step<false>(s, dp, lv, dl, krow0, q0, Lq, Lk, causal, sl2, scale);

    // dv += p^T do and dk += ds^T q, p and ds rounded to bf16 as the TPU
    // kernel rounds them to the input type
    uint32_t pa[4][4], da[4][4];
    to_a_operand(s, pa);
    to_a_operand(dp, da);
    pin(dv0);
    pin(dk0);
    pin(dv1);
    pin(dk1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<N0>(dv0, pa[kk], desc_mn(oa, 0, kk));
      wgmma_rs<N0>(dk0, da[kk], desc_mn(qa, 0, kk));
      if constexpr (N1 > 0) {
        wgmma_rs<N1>(dv1, pa[kk], desc_mn(oa, 1, kk));
        wgmma_rs<N1>(dk1, da[kk], desc_mn(qa, 1, kk));
      }
    }
    wg_commit();
    wg_wait_all();
    pin(dv0);
    pin(dk0);
    pin(dv1);
    pin(dk1);

    wg_sync(wg);  // every warp of this warpgroup is done reading the stage
    if (wt == 0 && n + 2 < mine) load_q(n + 2);
  }

  // warpgroups 1.. leave their partial dk, dv in their own idle rings;
  // warpgroup 0 adds them to its own and stores
  if constexpr (NW > 1) {
    if (wg > 0) {
      float* buf = reinterpret_cast<float*>(rings + wg * RB);
#pragma unroll
      for (int i = 0; i < N0 / 2; ++i) {
        buf[i * NT + wt] = dk0[i];
        buf[(N0 / 2 + i) * NT + wt] = dv0[i];
      }
      if constexpr (N1 > 0) {
#pragma unroll
        for (int i = 0; i < N1 / 2; ++i) {
          buf[(N0 + i) * NT + wt] = dk1[i];
          buf[(N0 + N1 / 2 + i) * NT + wt] = dv1[i];
        }
      }
    }
    __syncthreads();
    if (wg > 0) return;
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float* buf = reinterpret_cast<const float*>(rings + w * RB);
#pragma unroll
      for (int i = 0; i < N0 / 2; ++i) {
        dk0[i] += buf[i * NT + wt];
        dv0[i] += buf[(N0 / 2 + i) * NT + wt];
      }
      if constexpr (N1 > 0) {
#pragma unroll
        for (int i = 0; i < N1 / 2; ++i) {
          dk1[i] += buf[(N0 + i) * NT + wt];
          dv1[i] += buf[(N0 + N1 / 2 + i) * NT + wt];
        }
      }
    }
  }

  const size_t off = (size_t)bh * Lk * hd;
  store_rows<N0>(dk0, dk + off, krow0, 0, Lk, hd, 1.f, 1.f);
  store_rows<N0>(dv0, dv + off, krow0, 0, Lk, hd, 1.f, 1.f);
  if constexpr (N1 > 0) {
    store_rows<N1>(dk1, dk + off, krow0, 64, Lk, hd, 1.f, 1.f);
    store_rows<N1>(dv1, dv + off, krow0, 64, Lk, hd, 1.f, 1.f);
  }
}

// --------------------------------------------------------------------- host

constexpr int ERR_NO_ENCODER = 9999;   // the driver does not offer cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 10000;      // + the CUresult of a failed encode

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// [BH, L, hd] bf16 read in [1, 64, 64] boxes, 128-byte swizzle, zero fill
// past hd and past L.
int map_tiles(CUtensorMap* map, const void* ptr, int bh, int L, int hd) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)L, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)L * hd * 2};
  const cuuint32_t box[3] = {64, TILE, 1}, step[3] = {1, 1, 1};
  const CUresult r = encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                               dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// Warpgroups per block, each walking every NW-th tile of the block's walk.
// Two halve the heaviest block's serial walk and give each SM sub-partition a
// second warp to issue while the first waits; one was slower on the H100, and
// four hit the 128-register cap of a 512-thread block and spilled.
constexpr int FWD_NW = 2, DQ_NW = 2, DKV_NW = 2;

constexpr size_t tile_bytes(int hdp) { return (hdp > 64 ? 2 : 1) * (size_t)BOX; }
// 1024 for the alignment, the resident tiles, nw rings of 4 tiles, the mbarriers
constexpr size_t smem_bytes(int hdp, int resident, int nw) {
  return 1024 + (resident + 4 * nw) * tile_bytes(hdp) + (1 + 2 * nw) * 8;
}
constexpr size_t fwd_smem(int hdp) { return smem_bytes(hdp, 1, FWD_NW); }  // q
constexpr size_t dq_smem(int hdp) { return smem_bytes(hdp, 2, DQ_NW); }    // q, do
constexpr size_t dkv_smem(int hdp) { return smem_bytes(hdp, 2, DKV_NW); }  // k, v

template <int HDP>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int Lq, int Lk,
        int hd, float scale, int causal, int device, cudaStream_t st) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_fwd_wgmma<HDP, FWD_NW>;
  cudaError_t e = ddl::allow_smem(opted, kern, fwd_smem(HDP), device);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  int r;
  if ((r = map_tiles(&tq, q, bh, Lq, hd)) || (r = map_tiles(&tk, k, bh, Lk, hd)) ||
      (r = map_tiles(&tv, v, bh, Lk, hd)))
    return r;
  kern<<<dim3(bh, (Lq + TILE - 1) / TILE), FWD_NW * NT, fwd_smem(HDP), st>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (float*)lse, Lq, Lk, hd, scale, causal);
  return (int)cudaGetLastError();
}

template <int HDP>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dq_, int bh, int Lq, int Lk, int hd, float scale, int causal,
       int device, cudaStream_t st) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_dq_wgmma<HDP, DQ_NW>;
  cudaError_t e = ddl::allow_smem(opted, kern, dq_smem(HDP), device);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  int r;
  if ((r = map_tiles(&tq, q, bh, Lq, hd)) || (r = map_tiles(&tk, k, bh, Lk, hd)) ||
      (r = map_tiles(&tv, v, bh, Lk, hd)) || (r = map_tiles(&tdo, dout, bh, Lq, hd)))
    return r;
  kern<<<dim3(bh, (Lq + TILE - 1) / TILE), DQ_NW * NT, dq_smem(HDP), st>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq_, Lq, Lk, hd,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int HDP>
int dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dk_, void* dv_, int bh, int Lq, int Lk, int hd, float scale,
        int causal, int device, cudaStream_t st) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_dkv_wgmma<HDP, DKV_NW>;
  cudaError_t e = ddl::allow_smem(opted, kern, dkv_smem(HDP), device);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  int r;
  if ((r = map_tiles(&tq, q, bh, Lq, hd)) || (r = map_tiles(&tk, k, bh, Lk, hd)) ||
      (r = map_tiles(&tv, v, bh, Lk, hd)) || (r = map_tiles(&tdo, dout, bh, Lq, hd)))
    return r;
  kern<<<dim3(bh, (Lk + TILE - 1) / TILE), DKV_NW * NT, dkv_smem(HDP), st>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk_,
      (__nv_bfloat16*)dv_, Lq, Lk, hd, scale, causal);
  return (int)cudaGetLastError();
}

// What the kernels take: hd a multiple of 8 up to 128, causal only square,
// grids CUDA can launch, tensors TMA can address.
int refuse(int bh, int Lq, int Lk, int hd, int causal, int device) {
  if (hd < 8 || hd > 128 || hd % 8 || Lq < 1 || Lk < 1 || bh < 1 || (causal && Lq != Lk) ||
      (Lq + TILE - 1) / TILE > 65535 || (Lk + TILE - 1) / TILE > 65535 ||
      (size_t)bh * Lq > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  if (!encoder()) return ERR_NO_ENCODER;
  return (int)cudaSetDevice(device);
}

#define DISPATCH_HD(hd, FN, ...)                      \
  switch (((hd) + 15) / 16) {                         \
    case 1: return FN<16>(__VA_ARGS__);               \
    case 2: return FN<32>(__VA_ARGS__);               \
    case 3: return FN<48>(__VA_ARGS__);               \
    case 4: return FN<64>(__VA_ARGS__);               \
    case 5: return FN<80>(__VA_ARGS__);               \
    case 6: return FN<96>(__VA_ARGS__);               \
    case 7: return FN<112>(__VA_ARGS__);              \
    case 8: return FN<128>(__VA_ARGS__);              \
    default: return (int)cudaErrorInvalidValue;       \
  }

}  // namespace

// Plain C interface, loaded with ctypes; bfloat16 operands only.  Each entry
// launches one kernel on `stream` of `device` and returns 0 when the launch
// was accepted, else an error code for ddl_flash_sm90_error_string.
extern "C" {

int ddl_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int Lq, int Lk, int hd, float scale, int causal, int device,
                       void* stream) {
  if (int r = refuse(bh, Lq, Lk, hd, causal, device)) return r;
  DISPATCH_HD(hd, fwd, q, k, v, o, lse, bh, Lq, Lk, hd, scale, causal, device,
              (cudaStream_t)stream);
}

int ddl_flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq_, int bh, int Lq, int Lk,
                      int hd, float scale, int causal, int device, void* stream) {
  if (int r = refuse(bh, Lq, Lk, hd, causal, device)) return r;
  DISPATCH_HD(hd, dq, q, k, v, dout, lse, delta, dq_, bh, Lq, Lk, hd, scale, causal, device,
              (cudaStream_t)stream);
}

int ddl_flash_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk_, void* dv_, int bh, int Lq,
                       int Lk, int hd, float scale, int causal, int device, void* stream) {
  if (int r = refuse(bh, Lq, Lk, hd, causal, device)) return r;
  DISPATCH_HD(hd, dkv, q, k, v, dout, lse, delta, dk_, dv_, bh, Lq, Lk, hd, scale, causal,
              device, (cudaStream_t)stream);
}

const char* ddl_flash_sm90_error_string(int code) {
  if (code == ERR_NO_ENCODER) return "the CUDA driver offers no cuTensorMapEncodeTiled";
  if (code >= ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
