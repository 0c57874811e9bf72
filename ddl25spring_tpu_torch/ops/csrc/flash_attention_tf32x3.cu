// Flash attention for Hopper in float32 on the tensor cores: the forward, dq
// and dk/dv as 3xTF32 products.
//
// Replaces, for float32 inputs, the three Pallas TPU kernels of
// ddl25spring_tpu/ops/flash_attention.py:
//   flash_fwd_tf32x3  <- _fwd_kernel  (launched by _fwd)
//   flash_dq_tf32x3   <- _dq_kernel   (launched by _bwd_pallas)
//   flash_dkv_tf32x3  <- _dkv_kernel  (launched by _bwd_pallas)
// float32 operands these kernels do not take (head_dim not a multiple of 4, a
// pointer not 16-byte aligned) go to the scalar kernels of
// flash_attention.cu; the wrapper (ops/flash_attention.py) picks.
//
// Layout as in flash_attention.cu: q, k, v, o, do, dq, dk, dv are [BH, L, hd]
// float32, contiguous and 16-byte aligned, hd a multiple of 4 up to 128
// (cp.async moves 16-byte pieces of a row); lse and delta are [BH, Lq] float32,
// read and written 4 bytes at a time.  Causal needs Lq == Lk; non-causal takes
// Lk != Lq (the flash ring's lse path).
//
// Precision.  One TF32 product keeps 10 mantissa bits of each operand, a
// relative error of 2^-11 a term: at head_dim 48 a score is ~1e-2 off, past
// the float32 tolerance of 1e-4.  The 3xTF32 split takes x = hi + lo with
// hi = tf32(x) (cvt.rna) and lo = tf32(x - hi) (the residual in fp32), and a
// product as lo hi' + hi lo' + hi hi' accumulated in fp32: what it drops (lo
// lo', lo's own rounding) is ~2^-22 of a term, the size of fp32's own
// summation error (tests/test_torch_flash_attention.py::test_tf32x3_split).
//
// What bounds them at the LLaMA path's shape, [18, 256, 48] fp32 causal.  The
// forward moves 3.56 MB (1.06 us at 3.35 TB/s), dq 4.46 MB (1.33 us) and dk/dv
// 5.35 MB (1.60 us); their products, three TF32 ones each, take 0.69, 1.03 and
// 1.38 us at 495 TFLOP/s: bound by bytes on paper.  In practice the heaviest
// block bounds them: the last Q rows of the forward and dq (the first KV rows
// of dk/dv) walk all four 64-row tiles, each a chain of mma.sync products and
// the split's and softmax's elementwise work on one SM, while the grid is too
// small to fill the card (72 blocks of 64 rows for 132 SMs).
//
// What the design does about that.
// - mma.sync.m16n8k8 in TF32 (not wgmma), fragments loaded from fp32 tiles
//   in shared memory.  wgmma transposes only 16-bit operands, so the second
//   products (o += p v, dq += ds k, dv += p^T do, dk += ds^T q) would need v,
//   k, do and q staged again transposed, and each lo part a tile of its own;
//   with mma.sync a layout is indexing.
// - Each value is split once where it is staged and feeds the three products
//   with its hi and lo: the block's own tiles (q; q and do; k and v) once for
//   the whole walk, in shared memory (hi in place, lo in a tile beside it);
//   a walked tile's values in registers as a fragment is loaded, once for
//   each product that reads them (a lo tile for every stage of the ring would
//   not fit beside it at hd 128).
// - The second product of each pair takes p (or ds) from the accumulators of
//   the first: the A fragment's k index is permuted (its k = t and t + 4 are
//   the C fragment's columns 2t and 2t + 1) and the B fragment is read in the
//   same order, so no shuffle and no trip through shared memory.
// - A block owns 32 rows (OWN, FOWN), not 64: 144 blocks at the LLaMA shape,
//   and the heaviest block does half the work of a 64-row one.  Its 8 warps
//   take 16 own rows each times a quarter (SPAN = 16 rows) of each walked
//   tile.  dq (dk, dv) keeps a partial sum a warp; the forward keeps an online
//   softmax state a warp (running max, row sums, unnormalised o) and skips a
//   quarter that lies wholly above the diagonal or past Lk.  The quarters are
//   merged through shared memory at the end in a fixed order (the forward's
//   states rescaled to their common max): no atomics, results are
//   deterministic.  (On the H100, 64-row blocks were 1.5x slower at this
//   shape and 1.1x faster when every block walks every tile, non-causal; the
//   forward's 64 rows of 4 warps, each over the whole tile, 1.8x slower.)
// - The walked tiles arrive by cp.async (16 bytes a thread, zero fill past hd
//   and past L) into a 2-stage ring while the current tile computes; the
//   block's own tiles stay resident.  ~83 KB of shared memory a block at hd
//   48, ~203 KB at hd 128 (the forward ~66 and ~169 KB).
// - Shared-memory rows have a pitch of HDP + 4 floats, 4 times an odd number:
//   both fragment patterns, (row g, column t) of the first products and (row
//   2t, column g) of the second products' B, fall on 32 distinct banks.
// - Only the diagonal tile of a causal walk and ragged tiles compute a mask.
// - The heaviest causal tiles launch first.
// - The shared-memory attribute is set once per instantiation and device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "smem_optin.cuh"

namespace {

constexpr int TILE = 64;                 // rows of a walked tile
constexpr int OWN = 32;                  // rows of the block's own tile
constexpr int NW = 8;                    // warps a block
constexpr int NT = 32 * NW;
constexpr int WM = OWN / 16;             // warps along the own tile, 16 rows each
constexpr int WN = NW / WM;              // warps along each walked tile
constexpr int SPAN = TILE / WN;          // walked rows a warp takes
constexpr int NJ = SPAN / 8;             // its 8-row pieces
static_assert(WM * WN == NW && NJ * 8 * WN == TILE, "warps must tile the block");
// the forward's block, the same shape by default (tools/tf32x3_configs.py
// times others)
constexpr int FOWN = 32;
constexpr int FNW = 8;
constexpr int FNT = 32 * FNW;
constexpr int FWM = FOWN / 16;
constexpr int FWN = FNW / FWM;
constexpr int FSPAN = TILE / FWN;
constexpr int FNJ = FSPAN / 8;
static_assert(FWM * FWN == FNW && FNJ * 8 * FWN == TILE, "warps must tile the block");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;        // the mask value of the reference kernels

// ------------------------------------------------------------------ copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros where !ok (nothing read)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// every committed group but the newest N has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a [L, hd] slab into dst[ROWS][HDP + 4], zero
// past L and past hd (up to HDP); the pitch's last 4 columns are never read.
template <int HDP, int ROWS, int THREADS = NT>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int row0, int L, int hd) {
  constexpr int C4 = HDP / 4, P = HDP + 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int r = i / C4, c = 4 * (i % C4), row = row0 + r;
    const bool ok = row < L && c < hd;
    cp16(dst + r * P + c, ok ? src + (size_t)row * hd + c : src, ok);
  }
}

// ------------------------------------------------------ 3xTF32 fragments

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A staged [ROWS][HDP + 4] tile split once, in place: hi where it was, lo
// into a tile of its own.
template <int HDP, int ROWS, int THREADS = NT>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  constexpr int P = HDP + 4;
  for (int i = threadIdx.x; i < ROWS * HDP; i += THREADS) {
    const int at = (i / HDP) * P + i % HDP;
    uint32_t h, l;
    split(hi[at], h, l);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// d += a b as lo hi' + hi lo' + hi hi', the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi[0], b.hi[1]);
  mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

// Lane (g, t) = (lane / 4, lane % 4).  A fragment (16 x 8, row major) of
// tile rows m0.., columns k0.., from a tile split_tile split (hi in place, lo
// beside it): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
template <int P>
__device__ __forceinline__ FragA load_a(const float* hi, const float* lo, int m0, int k0) {
  const int lane = threadIdx.x & 31, off = (m0 + (lane >> 2)) * P + k0 + (lane & 3);
  const int at[4] = {off, off + 8 * P, off + 4, off + 8 * P + 4};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(hi[at[i]]);
    f.lo[i] = __float_as_uint(lo[at[i]]);
  }
  return f;
}

// B fragment (8 x 8) whose element (k, n) is tile row n0 + n, column k0 + k
// (the first products: k^T, v^T, q^T, do^T): b0 (k = t, n = g), b1 (t + 4, g).
template <int P>
__device__ __forceinline__ FragB load_b_rows(const float* s, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = s + (n0 + (lane >> 2)) * P + k0 + (lane & 3);
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// B fragment whose element (k, n) is tile row k0 + k, column n0 + n, the k
// index permuted as in a_from_c (the second products: k, do, q): b0 at row
// k0 + 2t, b1 at row k0 + 2t + 1, column n0 + g.
template <int P>
__device__ __forceinline__ FragB load_b_cols(const float* s, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = s + (k0 + 2 * (lane & 3)) * P + n0 + (lane >> 2);
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[P], f.hi[1], f.lo[1]);
  return f;
}

// A fragment from the accumulators of a 16 x 8 product (c0 (g, 2t), c1
// (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)), k index permuted: the
// fragment's k = t is column 2t and its k = t + 4 column 2t + 1.
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// Thread (g, t) of a warp holds accumulator rows m0 + g and m0 + g + 8,
// columns 8j + 2t and + 1 of acc[j]: store them as float2 rows of a [L, hd]
// slab, rows past L and columns past hd left alone.
template <int KS>
__device__ __forceinline__ void store_acc(const float (&acc)[KS][4], float* slab, int row0, int L,
                                          int hd) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < L)
        *reinterpret_cast<float2*>(slab + (size_t)row * hd + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// Warp (wm, wn) = (warp % WM, warp / WM).  The warps with wn > 0 leave
// their partial sums in buf, and each warp with wn = 0 adds those of its rows
// in the order wn = 1, 2, ...: no atomics, the same bits every call.  buf
// is free again on return.  Returns whether this warp holds the sum.
template <int KS>
__device__ __forceinline__ bool merge_partials(float (&acc)[KS][4], float* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp % WM, wn = warp / WM;
  auto at = [&](int w, int j, int e) {
    return buf + (((w - 1) * WM + wm) * KS + j) * 128 + e * 32 + lane;
  };
  if (wn > 0) {
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) *at(wn, j, e) = acc[j][e];
  }
  __syncthreads();
  if (wn == 0) {
    for (int w = 1; w < WN; ++w)
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += *at(w, j, e);
  }
  __syncthreads();
  return wn == 0;
}

// Warp (wm, wn) = (warp % FWM, warp / FWM) of the forward holds an online
// softmax state of its rows over its quarters of the walked tiles: m (the
// running max, log2 units), l (the row sums, added over the quad) and acc
// (the unnormalised o).  The warps with wn > 0 leave theirs in buf, and each
// warp with wn = 0 merges those of its rows into its own: m the largest of
// the maxima, l and acc the sums of the states scaled by exp2(m_w - m), in
// the order wn = 0, 1, ...: no atomics, the same bits every call.  A state
// that saw no key (m = NEG_INF, l = acc = 0) weighs 0.  Returns whether this
// warp holds the merged state.
template <int KS>
__device__ __forceinline__ bool merge_states(float (&acc)[KS][4], float (&m)[2], float (&l)[2],
                                             float* buf) {
  constexpr int W = 4 * KS + 4;  // floats a thread leaves: acc, m, l
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp % FWM, wn = warp / FWM;
  auto at = [&](int w, int i) { return buf + (((w - 1) * FWM + wm) * W + i) * 32 + lane; };
  if (wn > 0) {
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) *at(wn, 4 * j + e) = acc[j][e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *at(wn, 4 * KS + h) = m[h];
      *at(wn, 4 * KS + 2 + h) = l[h];
    }
  }
  __syncthreads();
  if (wn > 0) return false;
  float mt[2] = {m[0], m[1]};
  for (int w = 1; w < FWN; ++w)
#pragma unroll
    for (int h = 0; h < 2; ++h) mt[h] = fmaxf(mt[h], *at(w, 4 * KS + h));
  for (int w = 0; w < FWN; ++w) {
    float c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h] = exp2f((w ? *at(w, 4 * KS + h) : m[h]) - mt[h]);
      l[h] = w ? l[h] + c[h] * *at(w, 4 * KS + 2 + h) : c[h] * l[h];
    }
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = w ? acc[j][e] + c[e >> 1] * *at(w, 4 * j + e) : c[e >> 1] * acc[j][e];
  }
  m[0] = mt[0];
  m[1] = mt[1];
  return true;
}

// ------------------------------------------------------------------- forward
// o = softmax(scale q k^T) v and lse = m + log l by the online softmax,
// walking the 64-row KV tiles up to the diagonal (causal).  Grid (BH,
// ceil(Lq / FOWN)); block y = 0 takes the last (heaviest causal) Q tile.  q
// stays resident, split once.  Warp (wm, wn) takes Q rows 16 wm of the
// block's tile and KV rows FSPAN wn of each walked tile: its s and p are 16 x
// FSPAN, its state (merge_states) one over its KV rows.  A quarter wholly
// above the diagonal or past Lk is skipped; in one that crosses either, the
// masked scores are left out of the max and their p is 0.
template <int HDP>
__global__ void __launch_bounds__(FNT, 1)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int Lq, int Lk, int hd, float scale, int causal) {
  constexpr int P = HDP + 4, TF = TILE * P, KS = HDP / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;            // hi after the split, lo in sQl
  float* sQl = sQ + FOWN * P;
  float* ring = sQl + FOWN * P;  // stage s: k at ring + 2 s TF, v after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % FWM), n0 = FSPAN * (warp / FWM);
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * FOWN, r0 = q0 + m0;
  const int kv_end = causal ? min(Lk, q0 + FOWN) : Lk;
  const int nkv = (kv_end + TILE - 1) / TILE;
  const size_t qoff = (size_t)bh * Lq * hd, koff = (size_t)bh * Lk * hd;
  const float *kb = k + koff, *vb = v + koff;

  auto stage_kv = [&](int n) {
    float* s = ring + 2 * (n & 1) * TF;
    stage_tile<HDP, TILE, FNT>(s, kb, n * TILE, Lk, hd);
    stage_tile<HDP, TILE, FNT>(s + TF, vb, n * TILE, Lk, hd);
  };
  stage_tile<HDP, FOWN, FNT>(sQ, q + qoff, q0, Lq, hd);
  cp_commit();
  stage_kv(0);
  cp_commit();
  if (nkv > 1) stage_kv(1);
  cp_commit();
  cp_wait<2>();  // the block's own tile, split once for the whole walk
  __syncthreads();
  split_tile<HDP, FOWN, FNT>(sQ, sQl);

  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n = 0; n < nkv; ++n) {
    cp_wait<1>();
    __syncthreads();
    const float* sK = ring + 2 * (n & 1) * TF;
    const float* sV = sK + TF;
    const int c0 = n * TILE + n0;  // this warp's first key

    if (c0 < Lk && !(causal && c0 > r0 + 15)) {
      // s = q k^T over this warp's 16 x FSPAN, scaled to log2 units
      float s[FNJ][4];
#pragma unroll
      for (int j = 0; j < FNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const FragA aq = load_a<P>(sQ, sQl, m0, 8 * kk);
#pragma unroll
        for (int j = 0; j < FNJ; ++j) mma3(s[j], aq, load_b_rows<P>(sK, n0 + 8 * j, 8 * kk));
      }

      // the new running max of each row; masked scores take no part
      const bool masked = c0 + FSPAN > Lk || (causal && c0 + FSPAN - 1 > r0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < FNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = s[j][e] * sl2;
          if (masked) {
            const int col = c0 + 8 * j + 2 * t + (e & 1), row = r0 + g + 8 * h;
            if (col >= Lk || (causal && col > row)) x = NEG_INF;
          }
          s[j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }

      // p into s (0 where masked), this thread's share of the row sums
#pragma unroll
      for (int j = 0; j < FNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[j][e] == NEG_INF ? 0.f : exp2f(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          l[e >> 1] += p;
        }

      // o = o corr + p v over this warp's FSPAN KV rows
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
#pragma unroll
      for (int kk = 0; kk < FNJ; ++kk) {
        const FragA ap = a_from_c(s[kk]);
#pragma unroll
        for (int j = 0; j < KS; ++j) mma3(acc[j], ap, load_b_cols<P>(sV, n0 + 8 * kk, 8 * j));
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (n + 2 < nkv) stage_kv(n + 2);
    cp_commit();
  }

  cp_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (!merge_states<KS>(acc, m, l, ring)) return;
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
  store_acc<KS>(acc, o + qoff, r0, Lq, hd);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row < Lq) lse[(size_t)bh * Lq + row] = m[h] * LN2 + logf(l[h]);
    }
}

// ------------------------------------------------------------------------ dq
// dq = sum_j ds k with ds = scale p (dp - delta), dp = do v^T and
// p = exp(scale q k^T - lse), walking the 64-row KV tiles up to the diagonal
// (causal).  Grid (BH, ceil(Lq / OWN)); block y = 0 takes the last (heaviest
// causal) Q tile, whose q and do stay resident.  Warp (wm, wn) takes Q rows
// 16 wm of the block's tile and KV rows SPAN wn of each walked tile: its s and
// dp are 16 x SPAN, its dq a partial sum over its KV rows.
template <int HDP>
__global__ void __launch_bounds__(NT, 1)
flash_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int Lq, int Lk, int hd, float scale, int causal) {
  constexpr int P = HDP + 4, TF = TILE * P, KS = HDP / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;            // hi after the split, lo in sQl
  float* sQl = sQ + OWN * P;
  float* sO = sQl + OWN * P;   // do
  float* sOl = sO + OWN * P;
  float* ring = sOl + OWN * P;  // stage s: k at ring + 2 s TF, v after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM), n0 = SPAN * (warp / WM);
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * OWN;
  const int kv_end = causal ? min(Lk, q0 + OWN) : Lk;
  const int nkv = (kv_end + TILE - 1) / TILE;
  const size_t qoff = (size_t)bh * Lq * hd, koff = (size_t)bh * Lk * hd;
  const float *kb = k + koff, *vb = v + koff;

  auto stage_kv = [&](int n) {
    float* s = ring + 2 * (n & 1) * TF;
    stage_tile<HDP, TILE>(s, kb, n * TILE, Lk, hd);
    stage_tile<HDP, TILE>(s + TF, vb, n * TILE, Lk, hd);
  };
  stage_tile<HDP, OWN>(sQ, q + qoff, q0, Lq, hd);
  stage_tile<HDP, OWN>(sO, dout + qoff, q0, Lq, hd);
  cp_commit();
  stage_kv(0);
  cp_commit();
  if (nkv > 1) stage_kv(1);
  cp_commit();
  cp_wait<2>();  // the block's own tiles, split once for the whole walk
  __syncthreads();
  split_tile<HDP, OWN>(sQ, sQl);
  split_tile<HDP, OWN>(sO, sOl);

  // lse (in log2 units) and delta of this thread's two rows
  float lv[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    lv[h] = row < Lq ? lse[(size_t)bh * Lq + row] * LOG2E : 0.f;
    dl[h] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n = 0; n < nkv; ++n) {
    cp_wait<1>();
    __syncthreads();
    const float* sK = ring + 2 * (n & 1) * TF;
    const float* sV = sK + TF;
    const int k0 = n * TILE;

    // s = q k^T and dp = do v^T over this warp's 16 x SPAN
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA aq = load_a<P>(sQ, sQl, m0, 8 * kk);
      const FragA ao = load_a<P>(sO, sOl, m0, 8 * kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma3(s[j], aq, load_b_rows<P>(sK, n0 + 8 * j, 8 * kk));
        mma3(dp[j], ao, load_b_rows<P>(sV, n0 + 8 * j, 8 * kk));
      }
    }

    // ds into dp; only the diagonal tile (causal) and a ragged tile mask
    const bool masked = (causal && k0 + TILE > q0) || k0 + TILE > Lk;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(s[j][e] * sl2 - lv[h]);
        if (masked) {
          const int col = k0 + n0 + 8 * j + 2 * t + (e & 1), row = q0 + m0 + g + 8 * h;
          if (col >= Lk || (causal && col > row)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl[h]) * scale;
      }

    // dq += ds k over this warp's SPAN KV rows
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      const FragA ads = a_from_c(dp[kk]);
#pragma unroll
      for (int j = 0; j < KS; ++j) mma3(acc[j], ads, load_b_cols<P>(sK, n0 + 8 * kk, 8 * j));
    }

    __syncthreads();  // every warp is done with this stage
    if (n + 2 < nkv) stage_kv(n + 2);
    cp_commit();
  }

  cp_wait<0>();
  if (merge_partials<KS>(acc, ring)) store_acc<KS>(acc, dq + qoff, q0 + m0, Lq, hd);
}

// --------------------------------------------------------------------- dk/dv
// dv = sum_i p^T do and dk = sum_i scale (p (dp - delta))^T q with
// p = exp(scale q k^T - lse), walking the 64-row Q tiles from the diagonal
// (causal).  Grid (BH, ceil(Lk / OWN)); causal KV tile 0 walks every Q tile,
// so the heaviest blocks are the first.  Computed transposed (KV rows as M):
// warp (wm, wn) takes KV rows 16 wm of the block's tile and query rows SPAN
// wn of each walked tile: its s^T and dp^T are 16 x SPAN, its dk and dv
// partial sums over its query rows.  The ring's stages also carry the
// walked tile's lse and delta.
template <int HDP>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int hd,
                 float scale, int causal) {
  constexpr int P = HDP + 4, TF = TILE * P, KS = HDP / 8;
  constexpr int RS = 2 * TF + 2 * TILE;  // one stage: q, do, lse, delta
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;            // hi after the split, lo in sKl
  float* sKl = sK + OWN * P;
  float* sV = sKl + OWN * P;
  float* sVl = sV + OWN * P;
  float* ring = sVl + OWN * P;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM), n0 = SPAN * (warp / WM);
  const int bh = blockIdx.x, k0 = blockIdx.y * OWN;
  const int qt0 = causal ? k0 / TILE : 0;  // first Q tile that reaches this KV tile
  const int nq = (Lq + TILE - 1) / TILE - qt0;
  const size_t qoff = (size_t)bh * Lq * hd, koff = (size_t)bh * Lk * hd;
  const float *qb = q + qoff, *ob = dout + qoff;
  const float *lb = lse + (size_t)bh * Lq, *db = delta + (size_t)bh * Lq;

  auto stage_q = [&](int n) {
    float* s = ring + (n & 1) * RS;
    const int row0 = (qt0 + n) * TILE;
    stage_tile<HDP, TILE>(s, qb, row0, Lq, hd);
    stage_tile<HDP, TILE>(s + TF, ob, row0, Lq, hd);
    if (threadIdx.x < TILE) {
      const int row = row0 + threadIdx.x;
      const bool ok = row < Lq;
      cp4(s + 2 * TF + threadIdx.x, ok ? lb + row : lb, ok);
      cp4(s + 2 * TF + TILE + threadIdx.x, ok ? db + row : db, ok);
    }
  };
  stage_tile<HDP, OWN>(sK, k + koff, k0, Lk, hd);
  stage_tile<HDP, OWN>(sV, v + koff, k0, Lk, hd);
  cp_commit();
  stage_q(0);
  cp_commit();
  if (nq > 1) stage_q(1);
  cp_commit();
  cp_wait<2>();  // the block's own tiles, split once for the whole walk
  __syncthreads();
  split_tile<HDP, OWN>(sK, sKl);
  split_tile<HDP, OWN>(sV, sVl);

  const float sl2 = scale * LOG2E;
  float dk_acc[KS][4], dv_acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int n = 0; n < nq; ++n) {
    cp_wait<1>();
    __syncthreads();
    const float* sQ = ring + (n & 1) * RS;
    const float* sO = sQ + TF;
    const float* sL = sO + TF;
    const float* sD = sL + TILE;
    const int q0 = (qt0 + n) * TILE;

    // s^T = k q^T and dp^T = v do^T over this warp's 16 x SPAN
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA ak = load_a<P>(sK, sKl, m0, 8 * kk);
      const FragA av = load_a<P>(sV, sVl, m0, 8 * kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma3(s[j], ak, load_b_rows<P>(sQ, n0 + 8 * j, 8 * kk));
        mma3(dp[j], av, load_b_rows<P>(sO, n0 + 8 * j, 8 * kk));
      }
    }

    // p into s, ds into dp; only the diagonal tile (causal) and ragged
    // tiles mask
    const bool masked = (causal && q0 < k0 + OWN) || q0 + TILE > Lq || k0 + OWN > Lk;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + 8 * j + 2 * t + (e & 1);  // query row within the tile
        float p = exp2f(s[j][e] * sl2 - sL[c] * LOG2E);
        if (masked) {
          const int qpos = q0 + c, kpos = k0 + m0 + g + 8 * (e >> 1);
          if (qpos >= Lq || kpos >= Lk || (causal && kpos > qpos)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sD[c]) * scale;
      }

    // dv += p^T do and dk += ds^T q over this warp's SPAN query rows
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      const FragA ap = a_from_c(s[kk]), ads = a_from_c(dp[kk]);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        mma3(dv_acc[j], ap, load_b_cols<P>(sO, n0 + 8 * kk, 8 * j));
        mma3(dk_acc[j], ads, load_b_cols<P>(sQ, n0 + 8 * kk, 8 * j));
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (n + 2 < nq) stage_q(n + 2);
    cp_commit();
  }

  cp_wait<0>();
  merge_partials<KS>(dk_acc, ring);
  if (!merge_partials<KS>(dv_acc, ring)) return;
  store_acc<KS>(dk_acc, dk + koff, k0 + m0, Lk, hd);
  store_acc<KS>(dv_acc, dv + koff, k0 + m0, Lk, hd);
}

// ------------------------------------------------------------------- launch

// the resident tiles and a 2-stage ring of two walked tiles (dk/dv: and
// their lse and delta); the ring also holds the partial sums at the end
constexpr size_t dq_smem(int hdp) { return sizeof(float) * (4 * OWN + 4 * TILE) * (hdp + 4); }
constexpr size_t dkv_smem(int hdp) { return dq_smem(hdp) + sizeof(float) * 4 * TILE; }
// the partial sums, (WN - 1) WM KS 128 floats, fit the ring's 4 TILE (HDP + 4)
static_assert((WN - 1) * WM <= 16, "the ring holds the partial sums");
// the forward: q split, the ring of k and v, which then holds the states
// (merge_states), unless they need more
constexpr size_t fwd_smem(int hdp) {
  return sizeof(float) * (2 * FOWN * (hdp + 4) +
                          (4 * TILE * (hdp + 4) > (FWN - 1) * FWM * (hdp / 2 + 4) * 32
                               ? 4 * TILE * (hdp + 4)
                               : (FWN - 1) * FWM * (hdp / 2 + 4) * 32));
}

template <int HDP>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int Lq, int Lk,
        int hd, float scale, int causal, cudaStream_t st, int device) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_fwd_tf32x3<HDP>;
  cudaError_t e = ddl::allow_smem(opted, kern, fwd_smem(HDP), device);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(bh, (Lq + FOWN - 1) / FOWN), FNT, fwd_smem(HDP), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, Lq, Lk, hd,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int HDP>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dq_, int bh, int Lq, int Lk, int hd, float scale, int causal,
       cudaStream_t st, int device) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_dq_tf32x3<HDP>;
  cudaError_t e = ddl::allow_smem(opted, kern, dq_smem(HDP), device);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(bh, (Lq + OWN - 1) / OWN), NT, dq_smem(HDP), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dq_, Lq, Lk, hd, scale, causal);
  return (int)cudaGetLastError();
}

template <int HDP>
int dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dk_, void* dv_, int bh, int Lq, int Lk, int hd, float scale,
        int causal, cudaStream_t st, int device) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_dkv_tf32x3<HDP>;
  cudaError_t e = ddl::allow_smem(opted, kern, dkv_smem(HDP), device);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(bh, (Lk + OWN - 1) / OWN), NT, dkv_smem(HDP), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dk_, (float*)dv_, Lq, Lk, hd, scale, causal);
  return (int)cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  return true;
}

// What the kernels take: hd a multiple of 4 up to 128, causal only square,
// grids CUDA can launch (blocks of the smaller own tile), 16-byte aligned
// [BH, L, hd] operands.
int refuse(int bh, int Lq, int Lk, int hd, int causal, int device, bool aligned) {
  constexpr int rows = OWN < FOWN ? OWN : FOWN;
  if (hd < 4 || hd > 128 || hd % 4 || Lq < 1 || Lk < 1 || bh < 1 || (causal && Lq != Lk) ||
      (Lq + rows - 1) / rows > 65535 || (Lk + rows - 1) / rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned) return (int)cudaErrorMisalignedAddress;
  return (int)cudaSetDevice(device);
}

// head_dim padded to a multiple of 16 (HDP), as the sm90 kernels pad it
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

// Plain C interface, loaded with ctypes; float32 operands only.  Each entry
// launches one kernel on `stream` of `device` and returns 0 when the launch
// was accepted, else a cudaError_t for ddl_flash_tf32x3_error_string.
extern "C" {

int ddl_flash_fwd_tf32x3(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                         int Lq, int Lk, int hd, float scale, int causal, int device,
                         void* stream) {
  if (int r = refuse(bh, Lq, Lk, hd, causal, device, aligned16({q, k, v, o}))) return r;
  DISPATCH_HD(hd, fwd, q, k, v, o, lse, bh, Lq, Lk, hd, scale, causal, (cudaStream_t)stream,
              device);
}

int ddl_flash_dq_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq_, int bh, int Lq, int Lk,
                        int hd, float scale, int causal, int device, void* stream) {
  if (int r = refuse(bh, Lq, Lk, hd, causal, device, aligned16({q, k, v, dout, dq_}))) return r;
  DISPATCH_HD(hd, dq, q, k, v, dout, lse, delta, dq_, bh, Lq, Lk, hd, scale, causal,
              (cudaStream_t)stream, device);
}

int ddl_flash_dkv_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk_, void* dv_, int bh,
                         int Lq, int Lk, int hd, float scale, int causal, int device,
                         void* stream) {
  if (int r = refuse(bh, Lq, Lk, hd, causal, device, aligned16({q, k, v, dout, dk_, dv_})))
    return r;
  DISPATCH_HD(hd, dkv, q, k, v, dout, lse, delta, dk_, dv_, bh, Lq, Lk, hd, scale, causal,
              (cudaStream_t)stream, device);
}

const char* ddl_flash_tf32x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
