// Shared body of the three attention kernels (paged decode, paged prefill,
// flash): one thread block takes a tile of query rows and streams the keys
// they may see through shared memory in tiles of KT keys, with an online
// softmax (running max m, running sum l and the output accumulator in f32).
//
// What differs between the kernels is only where a row's query lives, its
// absolute position, and where key position `kpos` lives (a dense [B, S,
// Hkv, D] array, or a page of the paged pool found through the page table).
// Each kernel passes that as two small functors, `Rows` and `Keys`.
//
// Two bodies share that structure. `attend_rows` runs the products on the
// CUDA cores in f32 from shared memory: any row count, f32 or bf16 inputs.
// `attend_rows_tc` (bf16 inputs, 64-row tiles: prefill and flash) runs
// Q K^T and P V on the tensor cores through WMMA (mma.sync, bf16 operands,
// f32 accumulation), with the softmax still in f32; P is rounded to bf16
// for its product with V. No wgmma and no TMA yet. Accumulation is f32 and
// the output is written in the input's type.
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
#include <mma.h>
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

// Rows must provide: const T* q_row(r), T* out(r) (nullptr: row is padding),
// int qpos(r). Keys must provide: const T* k(kpos), const T* v(kpos), each
// 16-byte aligned.
template <typename T, typename Rows, typename Keys>
__device__ void attend_rows(const Rows& rows_of, const Keys& keys, int rows,
                            int D, int kv_lo, int kv_hi, bool causal,
                            int window, float scale) {
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
}

// ---------------------------------------------------------------- tensor cores
constexpr int TC_ROWS = 64;      // query rows per block (4 WMMA row blocks)
constexpr int TC_THREADS = 256;  // 8 warps

// Leading dimensions (elements) of the tensor-core tiles: head dims padded
// to a multiple of 16 (the padding is zero and adds nothing to Q K^T), and
// every row padded by 16 bytes against shared-memory bank conflicts.
struct TcLayout {
  int dp, ldq, ldk, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, bytes;   // byte offsets
  __host__ __device__ explicit TcLayout(int D) {
    dp = (D + 15) / 16 * 16;
    ldq = ldk = dp + 8;
    lds = KT + 4;
    ldp = KT + 8;
    ldo = dp + 4;
    size_t at = 0;
    q = take(at, (size_t)TC_ROWS * ldq * 2);
    k = take(at, (size_t)KT * ldk * 2);
    v = take(at, (size_t)KT * ldk * 2);
    s = take(at, (size_t)TC_ROWS * lds * 4);
    p = take(at, (size_t)TC_ROWS * ldp * 2);
    o = take(at, (size_t)TC_ROWS * ldo * 4);
    m = take(at, TC_ROWS * 4);
    l = take(at, TC_ROWS * 4);
    bytes = at;
  }
  // the offset of the next n bytes, each array starting 128-byte aligned
  __host__ __device__ static size_t take(size_t& at, size_t n) {
    const size_t o = at;
    at += (n + 127) / 128 * 128;
    return o;
  }
};

// Store held bf16 chunks, as they are, into k/v [KT][ldk].
__device__ __forceinline__ void store_tile_raw(const Chunks<__nv_bfloat16>& r,
                                               __nv_bfloat16* ks,
                                               __nv_bfloat16* vs, int D,
                                               int ldk) {
  const int cpr = D / 8, n = KT * cpr;
#pragma unroll
  for (int u = 0; u < MAXC; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < n) {
      const int c = i / cpr, e = (i - c * cpr) * 8;
      *reinterpret_cast<uint4*>(ks + c * ldk + e) = r.k[u];
      *reinterpret_cast<uint4*>(vs + c * ldk + e) = r.v[u];
    }
  }
}

// attend_rows for bf16 and 64 rows, products on the tensor cores. Launch
// with TC_THREADS threads and TcLayout(D).bytes of dynamic shared memory;
// D <= 256 and a multiple of 8 (every chunk of a tile is then held).
template <typename Rows, typename Keys>
__device__ void attend_rows_tc(const Rows& rows_of, const Keys& keys, int D,
                               int kv_lo, int kv_hi, bool causal, int window,
                               float scale) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const TcLayout L(D);
  bf16* qs = reinterpret_cast<bf16*>(tc_smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(tc_smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(tc_smem + L.v);
  float* ss = reinterpret_cast<float*>(tc_smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(tc_smem + L.p);
  float* os = reinterpret_cast<float*>(tc_smem + L.o);
  float* ms = reinterpret_cast<float*>(tc_smem + L.m);
  float* ls = reinterpret_cast<float*>(tc_smem + L.l);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dp = L.dp;
  const bf16 zero = __float2bfloat16(0.f);

  Chunks<bf16> next;
  if (kv_lo < kv_hi) load_tile<bf16>(next, keys, kv_lo, kv_hi, D);
  for (int i = tid; i < TC_ROWS * dp; i += TC_THREADS) {
    const int r = i / dp, d = i % dp;
    const bf16* qp = rows_of.q_row(r);
    qs[r * L.ldq + d] = (qp && d < D) ? qp[d] : zero;
    os[r * L.ldo + d] = 0.f;
  }
  for (int i = tid; i < KT * (dp - D); i += TC_THREADS) {   // pad columns
    const int c = i / (dp - D), d = D + i % (dp - D);
    ks[c * L.ldk + d] = zero;
    vs[c * L.ldk + d] = zero;
  }
  for (int r = tid; r < TC_ROWS; r += TC_THREADS) {
    ms[r] = NEG;
    ls[r] = 0.f;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += KT) {
    store_tile_raw(next, ks, vs, D, L.ldk);
    __syncthreads();
    if (t0 + KT < kv_hi) load_tile<bf16>(next, keys, t0 + KT, kv_hi, D);
    // 1. S = Q K^T: 4 x 2 blocks of 16 x 16, one per warp
    {
      const int rb = warp >> 1, cb = warp & 1;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::load_matrix_sync(a, qs + rb * 16 * L.ldq + kk, L.ldq);
        wmma::load_matrix_sync(b, ks + cb * 16 * L.ldk + kk, L.ldk);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(ss + rb * 16 * L.lds + cb * 16, c, L.lds,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // 2. masked online softmax, one warp per row and one lane per key; the
    // same warp rescales its row of O by alpha
    for (int r = warp; r < TC_ROWS; r += TC_THREADS / 32) {
      const int kpos = t0 + lane, qpos = rows_of.qpos(r);
      bool ok = kpos < kv_hi && rows_of.out(r) != nullptr;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos < window);
      const float s = ok ? ss[r * L.lds + lane] * scale : -INFINITY;
      const float m_prev = ms[r];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * L.ldp + lane] = __float2bfloat16(p);
      const float alpha = expf(m_prev - m_new);
      for (int d = lane; d < dp; d += 32) os[r * L.ldo + d] *= alpha;
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
      }
    }
    __syncthreads();
    // 3. O += P V: warp w takes row block w % 4 and every other column block
    {
      const int rb = warp & 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      for (int cb = warp >> 2; cb < dp / 16; cb += 2) {
        float* o = os + rb * 16 * L.ldo + cb * 16;
        wmma::load_matrix_sync(c, o, L.ldo, wmma::mem_row_major);
        for (int kk = 0; kk < KT; kk += 16) {
          wmma::load_matrix_sync(a, ps + rb * 16 * L.ldp + kk, L.ldp);
          wmma::load_matrix_sync(b, vs + kk * L.ldk + cb * 16, L.ldk);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(o, c, L.ldo, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  __syncthreads();   // a block with no key tile still reads m/l of others
  for (int i = tid; i < TC_ROWS * D; i += TC_THREADS) {
    const int r = i / D, d = i % D;
    bf16* op = rows_of.out(r);
    if (op) op[d] = __float2bfloat16(os[r * L.ldo + d] / fmaxf(ls[r], 1e-30f));
  }
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
