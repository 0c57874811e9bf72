// Flash attention for Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the three Pallas TPU kernels of ddl25spring_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel  (launched by _fwd)
//   flash_dq_kernel   <- _dq_kernel   (launched by _bwd_pallas)
//   flash_dkv_kernel  <- _dkv_kernel  (launched by _bwd_pallas)
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, L, hd] contiguous (heads folded
// into the batch); lse and delta are [BH, Lq] float32.  Inputs are float32 or
// bfloat16; every product and sum is float32, outputs are rounded to the input
// type when they are stored, and so are p (forward, dk/dv) and ds (dq, dk/dv)
// before the second product, as the TPU kernels round them (a no-op for
// float32).  The bf16 kernels run on the tensor cores (flash_attention_sm90.cu)
// wherever those take the shape; these kernels take float32 and the bf16
// shapes the tensor-core kernels do not.
//
// Design.  The TPU kernels walk the contraction axis as the innermost,
// sequential grid dimension and carry the online state in VMEM scratch across
// grid steps.  CUDA blocks run in no order, so here that walk is a loop inside
// one block: a block owns one 64-row tile of the output and loops over the
// 64-row tiles of the other operand, staging them in shared memory.  Each of
// the 256 threads owns a quarter of one tile row (4 threads per row, all in one
// warp), so row reductions are two warp shuffles and no atomics are used:
// results are deterministic.  head_dim is padded to HD (64 or 128) in shared
// memory with zeros; ragged tails of L are masked on load and on store.
//
// What bounds them on this card.  At the shapes the LLaMA path gives them
// ([18, 256, 48] bf16) each kernel moves 1.8-2.7 MB and does 0.1-0.2 GFLOP: the
// memory bound is below a microsecond and the launch costs more than the work.
// These kernels do their products with scalar FP32 FMAs from shared memory,
// not with the tensor cores (mma/wgmma), and launch one block per 64-row tile
// (72 blocks on 132 SMs at the main-path shape), so they are bound by
// shared-memory traffic and by latency, far from either roofline.  That is
// deliberate: float32 stays exact to 1e-4, which TF32 tensor cores would not
// be; the bf16 path has its tensor-core kernels in flash_attention_sm90.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem_optin.cuh"

namespace {

constexpr int TILE = 64;            // rows of q (and of k/v) per tile
constexpr int NT = 256;             // threads per block: 4 per tile row
constexpr int PER = TILE / 4;       // tile columns each thread owns
constexpr int SP = TILE + 1;        // pitch of a [TILE][TILE] score tile
constexpr float NEG_INF = -1e30f;   // the mask value of the reference kernels

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// x rounded to T and back: what a TPU kernel's .astype(T) before a matmul does
template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<T>(x));
}

// Stage rows [row0, row0 + TILE) of a [L, hd] slab as float32 into dst[TILE][pitch],
// zero past L and past hd (up to HD), so padded lanes add nothing to any product.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src,
                                          int row0, int L, int hd) {
  for (int idx = threadIdx.x; idx < TILE * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    dst[r * pitch + d] = (row < L && d < hd) ? to_f(src[(size_t)row * hd + d]) : 0.f;
  }
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool live(int qpos, int kpos, int Lq, int Lk, int causal) {
  return qpos < Lq && kpos < Lk && (!causal || kpos <= qpos);
}

// ------------------------------------------------------------------ forward
// Replaces _fwd_kernel: o = softmax(scale * q k^T) v and lse = m + log l, by the
// online-softmax recurrence.  Grid (BH, ceil(Lq / TILE)); thread (r, x) owns
// query row r of the tile, score columns x + 4i and output columns x + 4j.
// Causal: KV tiles past the tile's last query row are never loaded.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int Lq, int Lk, int hd, float scale, int causal) {
  constexpr int P = HD + 1;
  extern __shared__ float smem[];
  float* sQ = smem;               // [TILE][P]
  float* sK = sQ + TILE * P;      // [TILE][P]
  float* sV = sK + TILE * P;      // [TILE][P]
  float* sS = sV + TILE * P;      // [TILE][SP] probabilities of this KV tile

  const int bh = blockIdx.x, q0 = blockIdx.y * TILE;
  const int r = threadIdx.x >> 2, x = threadIdx.x & 3, qpos = q0 + r;
  const T* qb = q + (size_t)bh * Lq * hd;
  const T* kb = k + (size_t)bh * Lk * hd;
  const T* vb = v + (size_t)bh * Lk * hd;

  load_tile<T, HD>(sQ, P, qb, q0, Lq, hd);
  float m = NEG_INF, l = 0.f, acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] = 0.f;

  const int kv_end = causal ? min(Lk, q0 + TILE) : Lk;
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();  // the previous tile's sK/sV are no longer read
    load_tile<T, HD>(sK, P, kb, k0, Lk, hd);
    load_tile<T, HD>(sV, P, vb, k0, Lk, hd);
    __syncthreads();

    float s[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) s[i] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qd = sQ[r * P + d];
#pragma unroll
      for (int i = 0; i < PER; ++i) s[i] += qd * sK[(x + 4 * i) * P + d];
    }
    float mt = NEG_INF;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      s[i] = live(qpos, k0 + x + 4 * i, Lq, Lk, causal) ? s[i] * scale : NEG_INF;
      mt = fmaxf(mt, s[i]);
    }
    const float m_new = fmaxf(m, row_max4(mt));
    const float corr = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float p = s[i] == NEG_INF ? 0.f : expf(s[i] - m_new);
      ls += p;
      sS[r * SP + x + 4 * i] = round_as<T>(p);  // p.astype(v.dtype) before p @ v
    }
    l = l * corr + row_sum4(ls);
    m = m_new;
    __syncwarp();  // row r of sS was written by the 4 threads of row r, one warp

#pragma unroll
    for (int j = 0; j < HD / 4; ++j) acc[j] *= corr;
    for (int c = 0; c < TILE; ++c) {
      const float p = sS[r * SP + c];
#pragma unroll
      for (int j = 0; j < HD / 4; ++j) acc[j] += p * sV[c * P + x + 4 * j];
    }
  }

  if (qpos < Lq) {
    const float inv = 1.f / l;
    T* orow = o + ((size_t)bh * Lq + qpos) * hd;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) {
      const int d = x + 4 * j;
      if (d < hd) orow[d] = from_f<T>(acc[j] * inv);
    }
    if (x == 0) lse[(size_t)bh * Lq + qpos] = m + logf(l);
  }
}

// ------------------------------------------------------------------------ dq
// Replaces _dq_kernel: dq = sum_j scale * p (do v^T - delta) k with
// p = exp(scale q k^T - lse) recomputed per KV tile.  Grid (BH, ceil(Lq / TILE));
// the KV walk is the loop, thread (r, x) owns dq row r, columns x + 4j.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int Lq, int Lk, int hd, float scale, int causal) {
  constexpr int P = HD + 1;
  extern __shared__ float smem[];
  float* sQ = smem;               // [TILE][P]
  float* sO = sQ + TILE * P;      // [TILE][P] the output cotangent do
  float* sK = sO + TILE * P;      // [TILE][P]
  float* sV = sK + TILE * P;      // [TILE][P]
  float* sS = sV + TILE * P;      // [TILE][SP] ds of this KV tile

  const int bh = blockIdx.x, q0 = blockIdx.y * TILE;
  const int r = threadIdx.x >> 2, x = threadIdx.x & 3, qpos = q0 + r;
  const size_t qoff = (size_t)bh * Lq * hd, koff = (size_t)bh * Lk * hd;

  load_tile<T, HD>(sQ, P, q + qoff, q0, Lq, hd);
  load_tile<T, HD>(sO, P, dout + qoff, q0, Lq, hd);
  const float lse_r = qpos < Lq ? lse[(size_t)bh * Lq + qpos] : 0.f;
  const float delta_r = qpos < Lq ? delta[(size_t)bh * Lq + qpos] : 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] = 0.f;

  const int kv_end = causal ? min(Lk, q0 + TILE) : Lk;
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();
    load_tile<T, HD>(sK, P, k + koff, k0, Lk, hd);
    load_tile<T, HD>(sV, P, v + koff, k0, Lk, hd);
    __syncthreads();

    float s[PER], dp[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qd = sQ[r * P + d], od = sO[r * P + d];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        s[i] += qd * sK[(x + 4 * i) * P + d];
        dp[i] += od * sV[(x + 4 * i) * P + d];
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float p = live(qpos, k0 + x + 4 * i, Lq, Lk, causal)
                          ? expf(s[i] * scale - lse_r) : 0.f;
      sS[r * SP + x + 4 * i] = round_as<T>(p * (dp[i] - delta_r) * scale);  // ds.astype(k.dtype)
    }
    __syncwarp();

    for (int c = 0; c < TILE; ++c) {
      const float ds = sS[r * SP + c];
#pragma unroll
      for (int j = 0; j < HD / 4; ++j) acc[j] += ds * sK[c * P + x + 4 * j];
    }
  }

  if (qpos < Lq) {
    T* row = dq + qoff + (size_t)qpos * hd;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) {
      const int d = x + 4 * j;
      if (d < hd) row[d] = from_f<T>(acc[j]);
    }
  }
}

// --------------------------------------------------------------------- dk/dv
// Replaces _dkv_kernel: dv = sum_i p^T do and dk = sum_i scale (p (dp - delta))^T q.
// Grid (BH, ceil(Lk / TILE)); the Q walk is the loop, starting (causal) at the
// first Q tile that reaches this KV tile.  Thread (c, x) owns KV row c, score
// columns (query rows) x + 4i and output columns x + 4j.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv,
                 int Lq, int Lk, int hd, float scale, int causal) {
  constexpr int P = HD + 1;
  extern __shared__ float smem[];
  float* sK = smem;               // [TILE][P]
  float* sV = sK + TILE * P;      // [TILE][P]
  float* sQ = sV + TILE * P;      // [TILE][P]
  float* sO = sQ + TILE * P;      // [TILE][P] do
  float* sP = sO + TILE * P;      // [TILE][SP] p^T of this Q tile
  float* sD = sP + TILE * SP;     // [TILE][SP] ds^T of this Q tile
  float* sL = sD + TILE * SP;     // [TILE] lse of this Q tile
  float* sDl = sL + TILE;         // [TILE] delta of this Q tile

  const int bh = blockIdx.x, k0 = blockIdx.y * TILE;
  const int c = threadIdx.x >> 2, x = threadIdx.x & 3, kpos = k0 + c;
  const size_t qoff = (size_t)bh * Lq * hd, koff = (size_t)bh * Lk * hd;

  load_tile<T, HD>(sK, P, k + koff, k0, Lk, hd);
  load_tile<T, HD>(sV, P, v + koff, k0, Lk, hd);
  float dk_acc[HD / 4], dv_acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int q_begin = causal ? (k0 / TILE) * TILE : 0;
  for (int q0 = q_begin; q0 < Lq; q0 += TILE) {
    __syncthreads();
    load_tile<T, HD>(sQ, P, q + qoff, q0, Lq, hd);
    load_tile<T, HD>(sO, P, dout + qoff, q0, Lq, hd);
    for (int i = threadIdx.x; i < TILE; i += NT) {
      const bool in = q0 + i < Lq;
      sL[i] = in ? lse[(size_t)bh * Lq + q0 + i] : 0.f;
      sDl[i] = in ? delta[(size_t)bh * Lq + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[PER], dp[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float kd = sK[c * P + d], vd = sV[c * P + d];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        s[i] += sQ[(x + 4 * i) * P + d] * kd;
        dp[i] += sO[(x + 4 * i) * P + d] * vd;
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int rr = x + 4 * i;
      const float p = live(q0 + rr, kpos, Lq, Lk, causal)
                          ? expf(s[i] * scale - sL[rr]) : 0.f;
      sP[c * SP + rr] = round_as<T>(p);
      sD[c * SP + rr] = round_as<T>(p * (dp[i] - sDl[rr]) * scale);
    }
    __syncwarp();

    for (int rr = 0; rr < TILE; ++rr) {
      const float p = sP[c * SP + rr], ds = sD[c * SP + rr];
#pragma unroll
      for (int j = 0; j < HD / 4; ++j) {
        dv_acc[j] += p * sO[rr * P + x + 4 * j];
        dk_acc[j] += ds * sQ[rr * P + x + 4 * j];
      }
    }
  }

  if (kpos < Lk) {
    T* krow = dk + koff + (size_t)kpos * hd;
    T* vrow = dv + koff + (size_t)kpos * hd;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) {
      const int d = x + 4 * j;
      if (d < hd) {
        krow[d] = from_f<T>(dk_acc[j]);
        vrow[d] = from_f<T>(dv_acc[j]);
      }
    }
  }
}

template <int HD> constexpr size_t fwd_smem() { return sizeof(float) * (3 * TILE * (HD + 1) + TILE * SP); }
template <int HD> constexpr size_t dq_smem() { return sizeof(float) * (4 * TILE * (HD + 1) + TILE * SP); }
template <int HD> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * TILE * (HD + 1) + 2 * TILE * SP + 2 * TILE);
}

inline dim3 grid_of(int bh, int L) { return dim3(bh, (L + TILE - 1) / TILE); }

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                int Lq, int Lk, int hd, float scale, int causal, int device, cudaStream_t st) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t e = ddl::allow_smem(opted, kern, fwd_smem<HD>(), device);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(bh, Lq), NT, fwd_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Lq, Lk, hd, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq_, int bh, int Lq, int Lk, int hd, float scale,
               int causal, int device, cudaStream_t st) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_dq_kernel<T, HD>;
  cudaError_t e = ddl::allow_smem(opted, kern, dq_smem<HD>(), device);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(bh, Lq), NT, dq_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq_, Lq, Lk, hd, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk_, void* dv_, int bh, int Lq, int Lk, int hd,
                float scale, int causal, int device, cudaStream_t st) {
  static std::atomic<uint32_t> opted{0};
  auto kern = flash_dkv_kernel<T, HD>;
  cudaError_t e = ddl::allow_smem(opted, kern, dkv_smem<HD>(), device);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(bh, Lk), NT, dkv_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk_, (T*)dv_, Lq, Lk, hd, scale, causal);
  return cudaGetLastError();
}

// Pick the instantiation for (dtype, hd) and call FN with it; hd > 128, an
// unknown dtype, an empty sequence or a grid too tall for CUDA is refused before
// anything launches.  Expands to the last statement of the entry point.
#define DISPATCH(dtype, hd, Lq, Lk, L, FN, ...)                                   \
  {                                                                               \
    if ((hd) < 1 || (hd) > 128 || (Lq) < 1 || (Lk) < 1 ||                         \
        ((L) + TILE - 1) / TILE > 65535)                                          \
      return (int)cudaErrorInvalidValue;                                          \
    if ((dtype) == F32)                                                           \
      return (int)((hd) <= 64 ? FN<float, 64>(__VA_ARGS__)                        \
                              : FN<float, 128>(__VA_ARGS__));                     \
    if ((dtype) == BF16)                                                          \
      return (int)((hd) <= 64 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)                \
                              : FN<__nv_bfloat16, 128>(__VA_ARGS__));             \
    return (int)cudaErrorInvalidValue;                                            \
  }

}  // namespace

// Plain C interface, loaded with ctypes.  Each entry launches one kernel on
// `stream` (a cudaStream_t) of `device` and returns cudaGetLastError(): 0 when
// the launch was accepted.  The caller allocates every output.
extern "C" {

int ddl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                  int Lq, int Lk, int hd, float scale, int causal, int dtype, int device,
                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  DISPATCH(dtype, hd, Lq, Lk, Lq, fwd, q, k, v, o, lse, bh, Lq, Lk, hd, scale, causal, device,
           (cudaStream_t)stream);
}

int ddl_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq_, int bh, int Lq, int Lk,
                 int hd, float scale, int causal, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  DISPATCH(dtype, hd, Lq, Lk, Lq, dq, q, k, v, dout, lse, delta, dq_, bh, Lq, Lk, hd, scale, causal,
           device, (cudaStream_t)stream);
}

int ddl_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk_, void* dv_, int bh, int Lq,
                  int Lk, int hd, float scale, int causal, int dtype, int device,
                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  DISPATCH(dtype, hd, Lq, Lk, Lk, dkv, q, k, v, dout, lse, delta, dk_, dv_, bh, Lq, Lk, hd, scale,
           causal, device, (cudaStream_t)stream);
}

const char* ddl_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
