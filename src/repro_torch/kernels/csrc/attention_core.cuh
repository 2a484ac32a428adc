// The CUDA-core attention body of the f32 kernels (paged prefill and flash
// in f32; their bf16 paths run wgmma, attention_wgmma.cuh): one thread
// block takes a tile of query rows and streams the keys they may see
// through shared memory in tiles of KT keys, with an online softmax
// (running max m, running sum l and the output accumulator in f32), the
// products in f32 from shared memory.
//
// What differs between the kernels is only where a row's query lives, its
// absolute position, and where key position `kpos` lives (a dense [B, S,
// Hkv, D] array, or a page of the paged pool found through the page table).
// Each kernel passes that as two small functors, `Rows` and `Keys`.
//
// Masking follows the Pallas kernels: a key is seen when kpos < the block's
// key limit (context length or seq_k), kpos <= qpos when causal, and
// qpos - kpos < window when a window is set. Key tiles that no row of the
// block can see are never loaded (the [kv_lo, kv_hi) range). A row that sees
// no key at all returns 0 (acc / max(l, 1e-30)), as the Pallas kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int KT = 32;          // keys per shared-memory tile
constexpr float NEG = -1e30f;   // initial running max (finite, as in Pallas)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory (floats) for a tile of `rows` query rows of width D:
// q [rows][D], k [KT][D+1] (padded against bank conflicts), v [KT][D],
// p [rows][KT+1], o [rows][D], m/l/alpha [rows].
__host__ __device__ inline size_t smem_floats(int rows, int D) {
  return (size_t)rows * D * 2 + (size_t)KT * (D + 1) + (size_t)KT * D +
         (size_t)rows * (KT + 1) + 3 * (size_t)rows;
}

// Key/value tiles move from device memory in 16-byte chunks (VEC elements
// of one key's row); each thread holds up to MAXC chunks of K and of V in
// registers, so the next tile's loads are in flight while the block computes
// on the current one. D must be a multiple of VEC (the wrapper checks).
constexpr int MAXC = 4;

template <typename T>
struct Chunks {
  uint4 k[MAXC], v[MAXC];
};

// Issue the loads of the first MAXC * blockDim chunks of the tile at t0.
template <typename T, typename Keys>
__device__ __forceinline__ void load_tile(Chunks<T>& r, const Keys& keys,
                                          int t0, int kv_hi, int D) {
  constexpr int VEC = 16 / sizeof(T);
  const int cpr = D / VEC, n = KT * cpr;
#pragma unroll
  for (int u = 0; u < MAXC; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    const int c = i / cpr, kpos = t0 + c;
    r.k[u] = r.v[u] = make_uint4(0, 0, 0, 0);
    if (i < n && kpos < kv_hi) {
      const int e = (i - c * cpr) * VEC;
      r.k[u] = *reinterpret_cast<const uint4*>(keys.k(kpos) + e);
      r.v[u] = *reinterpret_cast<const uint4*>(keys.v(kpos) + e);
    }
  }
}

// Convert held chunks to f32 into k [KT][D+1] and v [KT][D].
template <typename T>
__device__ __forceinline__ void store_tile(const Chunks<T>& r, float* ks,
                                           float* vs, int D) {
  constexpr int VEC = 16 / sizeof(T);
  const int cpr = D / VEC, n = KT * cpr;
#pragma unroll
  for (int u = 0; u < MAXC; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < n) {
      const int c = i / cpr, e = (i - c * cpr) * VEC;
      const T* kx = reinterpret_cast<const T*>(&r.k[u]);
      const T* vx = reinterpret_cast<const T*>(&r.v[u]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[c * (D + 1) + e + j] = to_f<T>(kx[j]);
        vs[c * D + e + j] = to_f<T>(vx[j]);
      }
    }
  }
}

// No log-sum-exp output (attend_rows' default).
struct NoLse {
  __device__ float* operator()(int) const { return nullptr; }
};

// Rows must provide: const T* q_row(r), T* out(r) (nullptr: row is padding),
// int qpos(r). Keys must provide: const T* k(kpos), const T* v(kpos), each
// 16-byte aligned. lse_of(r) is row r's f32 slot for m + log(max(l, 1e-30)),
// the log-sum-exp of its scaled scores, or nullptr.
template <typename T, typename Rows, typename Keys, typename Lse = NoLse>
__device__ void attend_rows(const Rows& rows_of, const Keys& keys, int rows,
                            int D, int kv_lo, int kv_hi, bool causal,
                            int window, float scale,
                            const Lse& lse_of = Lse{}) {
  static_assert(KT == 32, "the softmax step maps one key to one lane");
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + rows * D;
  float* vs = ks + KT * (D + 1);
  float* ps = vs + KT * D;
  float* os = ps + rows * (KT + 1);
  float* ms = os + rows * D;
  float* ls = ms + rows;
  float* as = ls + rows;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  // chunks of a tile beyond what the registers hold (large D with few
  // threads) load in extra passes after the prefetched ones
  const int held = MAXC * nt, n_chunks = KT * (D / VEC);

  Chunks<T> next;
  if (kv_lo < kv_hi) load_tile<T>(next, keys, kv_lo, kv_hi, D);
  for (int i = tid; i < rows * D; i += nt) {
    const int r = i / D, d = i % D;
    const T* qp = rows_of.q_row(r);
    qs[i] = qp ? to_f<T>(qp[d]) * scale : 0.f;
    os[i] = 0.f;
  }
  for (int r = tid; r < rows; r += nt) {
    ms[r] = NEG;
    ls[r] = 0.f;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += KT) {
    // 1. the key tile, converted to f32 (keys past kv_hi read as 0); the
    // loop's closing barrier (or the one above) keeps the previous tile
    // alive until every thread is done with it
    store_tile<T>(next, ks, vs, D);
    for (int i = held + tid; i < n_chunks; i += nt) {
      const int c = i / (D / VEC), e = (i - c * (D / VEC)) * VEC;
      const int kpos = t0 + c;
      for (int j = 0; j < VEC; ++j) {
        ks[c * (D + 1) + e + j] = kpos < kv_hi ? to_f<T>(keys.k(kpos)[e + j]) : 0.f;
        vs[c * D + e + j] = kpos < kv_hi ? to_f<T>(keys.v(kpos)[e + j]) : 0.f;
      }
    }
    __syncthreads();
    if (t0 + KT < kv_hi) load_tile<T>(next, keys, t0 + KT, kv_hi, D);
    // 2. masked scores
    for (int i = tid; i < rows * KT; i += nt) {
      const int r = i / KT, c = i % KT;
      const int kpos = t0 + c;
      const int qpos = rows_of.qpos(r);
      bool ok = kpos < kv_hi && rows_of.out(r) != nullptr;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos < window);
      float s = -INFINITY;
      if (ok) {
        const float* qr = qs + r * D;
        const float* kr = ks + c * (D + 1);
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc;
      }
      ps[r * (KT + 1) + c] = s;
    }
    __syncthreads();
    // 3. online softmax update: one warp per row, one lane per key
    for (int r = warp; r < rows; r += nwarps) {
      const float s = ps[r * (KT + 1) + lane];
      const float m_prev = ms[r];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      const float p = s == -INFINITY ? 0.f : expf(s - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * (KT + 1) + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
        as[r] = alpha;
      }
    }
    __syncthreads();
    // 4. o = o * alpha + p @ v
    for (int i = tid; i < rows * D; i += nt) {
      const int r = i / D, d = i % D;
      const float* pr = ps + r * (KT + 1);
      float acc = os[i] * as[r];
      for (int c = 0; c < KT; ++c) acc = fmaf(pr[c], vs[c * D + d], acc);
      os[i] = acc;
    }
    __syncthreads();
  }

  __syncthreads();   // a block with no key tile still reads m/l of others
  for (int i = tid; i < rows * D; i += nt) {
    const int r = i / D, d = i % D;
    T* op = rows_of.out(r);
    if (op) op[d] = from_f<T>(os[i] / fmaxf(ls[r], 1e-30f));
  }
  for (int r = tid; r < rows; r += nt)
    if (float* lp = lse_of(r)) *lp = ms[r] + logf(fmaxf(ls[r], 1e-30f));
}

// Sets the kernel's dynamic shared memory limit once per size it needs.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

// A paged key source: key position kpos of sequence b lives at slot
// kpos % page of physical page page_table[b, kpos / page].
template <typename T>
struct PagedKeys {
  const T* k_pool;
  const T* v_pool;
  const int* pt_row;   // page_table[b], N entries
  int page, hkv, D, h;
  __device__ size_t off(int kpos) const {
    const int64_t pid = pt_row[kpos / page];
    return ((size_t)(pid * page + kpos % page) * hkv + h) * D;
  }
  __device__ const T* k(int kpos) const { return k_pool + off(kpos); }
  __device__ const T* v(int kpos) const { return v_pool + off(kpos); }
};

}  // namespace rt
