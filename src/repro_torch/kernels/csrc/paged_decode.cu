// Paged decode attention (GQA) over the block-paged KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` / `_kernel` in
// src/repro/kernels/paged_attention/kernel.py: one new query token per
// sequence attends over the pages its page table lists, keys below the
// context length (and inside the window when one is set).
//
// What bounds it on the card: the K/V bytes. Each decoded token reads its
// whole context once per KV head (2 * ctx * D * bytes), against 4 * G * ctx
// * D flops; at G = 4 that is a few flops per byte, far under the H100's
// ~295 flops per byte. Tensor cores buy nothing here; bytes in flight and
// SMs kept busy are what matter.
//
// The design (flash-decoding on the CUDA cores):
//  - split-KV: the page table's N * page key slots are cut into `splits`
//    runs of `split_keys` keys (a multiple of the key tile and of the page,
//    planned on the host from B, Hkv, N, page and D alone: see
//    decode_split_plan in kernels/paged_attention/kernel.py), and a grid of
//    (B, Hkv x head groups, splits) blocks of 128 threads each takes one
//    run of one (sequence, KV head): at B = 8, Hkv = 8, N = 40 that is 320
//    blocks on 132 SMs. The split is the slowest grid dimension, so the
//    first splits, which every context covers, start first, and the empty
//    ones past short contexts do not push busy blocks into a later wave.
//    A block holds the (up to 8) query heads of its group that share the
//    KV head, so every K/V byte it reads serves all of them. A block
//    whose run lies wholly at or past the context, or before the window,
//    reads nothing and writes an empty partial;
//  - copies: the block streams its keys in tiles of KT = 32 through a ring
//    of STAGES = 3 stages in shared memory, by 16-byte cp.async, each key's
//    physical page looked up in the split's page ids, which the block reads
//    from its page-table row once, into shared memory (a lookup per chunk
//    in device memory held each copy back by that load's latency). Each
//    thread copies the chunks its own lanes read, in a loop of fixed trip
//    count; keys past the context are zero-filled, never read. K/V stay in
//    their input type (bf16 on the serve path); one block-wide barrier a
//    tile;
//  - arithmetic: each warp owns 8 keys of a tile. LPK lanes take one key,
//    each lane CPL 16-byte chunks of its head dims: q (in registers, scaled
//    into the log2 domain) against the key row from shared memory, a
//    shuffle sum across the LPK lanes; each group of LPK lanes keeps its own
//    running max, sum and f32 output accumulator (no barrier inside a
//    tile); at the end they merge across the warp by shuffles and across
//    the four warps through shared memory, in a fixed order;
//  - combine: each block writes its partial (o[D], m, l) per query head to
//    an f32 scratch; a second launch (decode_combine) merges the splits of
//    each (sequence, query head) in split order and writes the output. No
//    atomics, so the result is the same bit for bit on every call. With a
//    single split the first launch writes the output itself.
// f32 inputs run the same design with 4-element chunks. ctx = 0 returns 0
// for the row, as the Pallas kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_core.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 128, NW = THREADS / 32;
constexpr int KT = 32;           // keys per tile
constexpr int WK = KT / NW;      // keys of a tile each warp owns
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;    // initial running max (finite, as in Pallas)
constexpr int MAX_SPLITS = 1024;  // the combine's shared-memory bound

// Partials: per (b, query head, split) D floats of o, then m and l.
__host__ __device__ inline size_t part_row(int D) { return (size_t)D + 2; }

template <typename T, int R, int LPK, int CPL>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ k_pool,
             const T* __restrict__ v_pool, const int* __restrict__ page_table,
             const int* __restrict__ ctx_lens, T* __restrict__ out,
             float* __restrict__ part, int Hq, int Hkv, int D, int page, int N,
             int window, int split_keys, float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KPI = 32 / LPK;          // keys a warp takes a round
  constexpr int ROUNDS = WK / KPI;
  static_assert(KPI <= WK, "at least 4 lanes a key");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [STAGES][K, V][KT][D]

  const int b = blockIdx.x, split = blockIdx.z, splits = gridDim.z;
  const int G = Hq / Hkv, groups = (G + R - 1) / R;
  const int h = blockIdx.y / groups, g0 = blockIdx.y % groups * R;
  const int ctx = ctx_lens[b], qpos = ctx - 1;
  int lo = split * split_keys;
  const int hi = min(lo + split_keys, min(ctx, N * page));
  if (window > 0) lo = max(lo, qpos - window + 1);
  const int n_tiles = hi > lo ? (hi - lo + KT - 1) / KT : 0;
  const size_t ring_bytes = (size_t)STAGES * 2 * KT * D * sizeof(T);
  const int cpr = D / VEC;               // 16-byte chunks a key row
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sub = lane % LPK, grp = lane / LPK;

  // the physical pages of the split, once, into shared memory
  int* pages = reinterpret_cast<int*>(smem + ring_bytes);
  const int p0 = split * (split_keys / page);
  const int n_pages = min(split_keys / page, N - p0);
  const int* pt_row = page_table + (size_t)b * N + p0;
  for (int i = tid; i < n_pages; i += THREADS) pages[i] = pt_row[i];
  __syncthreads();

  // Tile t into its stage: thread tid copies chunks sub + j LPK of keys
  // tid / LPK + KPP u (the lanes that read them below); keys past hi are
  // zero-filled and never read.
  constexpr int KPP = THREADS / LPK;     // keys a pass
  auto issue = [&](int t) {
    if (t < n_tiles) {
      T* kt = ring + (size_t)(t % STAGES) * 2 * KT * D;
      T* vt = kt + KT * D;
      const int t0 = lo + t * KT;
#pragma unroll
      for (int u = 0; u < KT / KPP; ++u) {
        const int c = tid / LPK + KPP * u, kpos = t0 + c;
        const bool live = kpos < hi;
        int64_t row = 0;
        if (live)
          row = ((int64_t)pages[kpos / page - p0] * page + kpos % page) *
                    Hkv + h;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int e = (sub + j * LPK) * VEC;
          if (e < D) {
            hp::cp_async16(kt + c * D + e, k_pool + row * D + e, live);
            hp::cp_async16(vt + c * D + e, v_pool + row * D + e, live);
          }
        }
      }
    }
    hp::cp_async_commit();   // empty past the last tile: the count stays
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  // the group's query rows in registers, scaled into the log2 domain
  float qr[R][CPL][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int chunk = sub + j * LPK;
      const bool ok = g0 + r < G && chunk < cpr;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (ok)
        raw = *reinterpret_cast<const uint4*>(
            q + ((size_t)b * Hq + h * G + g0 + r) * D + chunk * VEC);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[r][j][e] = rt::to_f<T>(x[e]) * scale_log2;
    }
  float m[R], l[R], acc[R][CPL][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][j][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    hp::cp_async_wait<STAGES - 2>();   // this thread's copies of tile t
    __syncthreads();                   // everyone's; tile t - 1 is done
    issue(t + STAGES - 1);             // into tile t - 1's stage
    const T* kt = ring + (size_t)(t % STAGES) * 2 * KT * D;
    const T* vt = kt + KT * D;
    const int t0 = lo + t * KT;
    float sc[ROUNDS][R];
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int c = warp * WK + u * KPI + grp;
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int chunk = sub + j * LPK;
        if (chunk < cpr) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(kt + c * D + chunk * VEC);
          const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float kf = rt::to_f<T>(x[e]);
#pragma unroll
            for (int r = 0; r < R; ++r) dot[r] = fmaf(qr[r][j][e], kf, dot[r]);
          }
        }
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o /= 2)
#pragma unroll
        for (int r = 0; r < R; ++r)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
#pragma unroll
      for (int r = 0; r < R; ++r)
        sc[u][r] = t0 + c < hi ? dot[r] : -INFINITY;
    }
    // online softmax of the group's keys of this tile
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) mx = fmaxf(mx, sc[u][r]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = hp::exp2_approx(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) {
        sc[u][r] = hp::exp2_approx(sc[u][r] - m_new);
        sum += sc[u][r];
      }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][j][e] *= alpha;
    }
    // o += p v
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int c = warp * WK + u * KPI + grp;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int chunk = sub + j * LPK;
        if (chunk < cpr) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(vt + c * D + chunk * VEC);
          const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float vf = rt::to_f<T>(x[e]);
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r][j][e] = fmaf(sc[u][r], vf, acc[r][j][e]);
          }
        }
      }
    }
  }
  hp::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the merge below

  // merge the key groups of the warp (lanes LPK, 2 LPK, ... apart)
#pragma unroll
  for (int o = LPK; o < 32; o *= 2)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float m_new = fmaxf(m[r], m_o);
      const float a = hp::exp2_approx(m[r] - m_new);
      const float a_o = hp::exp2_approx(m_o - m_new);
      l[r] = l[r] * a + l_o * a_o;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[r][j][e] = acc[r][j][e] * a +
                         __shfl_xor_sync(0xffffffffu, acc[r][j][e], o) * a_o;
    }
  // ... then the warps, through shared memory: red[warp][r][D + 2]
  float* red = reinterpret_cast<float*>(smem);
  const size_t row = part_row(D);
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* w = red + (warp * R + r) * row;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int chunk = sub + j * LPK;
        if (chunk < cpr)
#pragma unroll
          for (int e = 0; e < VEC; ++e) w[chunk * VEC + e] = acc[r][j][e];
      }
      if (sub == 0) {
        w[D] = m[r];
        w[D + 1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D, g = g0 + r;
    if (g >= G) break;
    float m_all = NEG;
    for (int w = 0; w < NW; ++w)
      m_all = fmaxf(m_all, red[(w * R + r) * row + D]);
    float l_all = 0.f, o_all = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float* x = red + (w * R + r) * row;
      const float a = hp::exp2_approx(x[D] - m_all);
      l_all = fmaf(x[D + 1], a, l_all);
      o_all = fmaf(x[d], a, o_all);
    }
    const size_t hq = (size_t)b * Hq + h * G + g;
    if (splits == 1) {
      out[hq * D + d] = rt::from_f<T>(o_all / fmaxf(l_all, 1e-30f));
    } else {
      float* p = part + (hq * splits + split) * row;
      p[d] = o_all;
      if (d == 0) {
        p[D] = m_all;
        p[D + 1] = l_all;
      }
    }
  }
}

// One block per (sequence, query head): the splits' partials merged in
// split order. The m and l of every split go through shared memory at
// once, and the block's max and sum through a fixed shuffle tree and the
// warps in order, so the result does not depend on timing.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ part, T* __restrict__ out, int D,
               int splits) {
  __shared__ float ms[MAX_SPLITS], ws[MAX_SPLITS], red[NW];
  const size_t row = part_row(D);
  const float* p = part + (size_t)blockIdx.x * splits * row;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  auto block_reduce = [&](float x, bool is_max) {
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = is_max ? fmaxf(x, y) : x + y;
    }
    __syncthreads();   // red is free
    if (lane == 0) red[warp] = x;
    __syncthreads();
    x = red[0];
    for (int w = 1; w < NW; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
    return x;
  };
  float m = NEG;
  for (int s = tid; s < splits; s += THREADS) {
    ms[s] = p[s * row + D];
    ws[s] = p[s * row + D + 1];
    m = fmaxf(m, ms[s]);
  }
  m = block_reduce(m, true);
  float l = 0.f;
  for (int s = tid; s < splits; s += THREADS) {
    const float w = hp::exp2_approx(ms[s] - m);
    l = fmaf(ws[s], w, l);
    ws[s] = w;
  }
  const float denom = fmaxf(block_reduce(l, false), 1e-30f);   // syncs ws
  for (int d = tid; d < D; d += THREADS) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) o = fmaf(p[s * row + d], ws[s], o);
    out[(size_t)blockIdx.x * D + d] = rt::from_f<T>(o / denom);
  }
}

template <typename T, int R, int LPK, int CPL>
cudaError_t launch_split(const T* q, const T* k_pool, const T* v_pool,
                         const int* pt, const int* ctx, T* out, float* part,
                         int B, int Hq, int Hkv, int D, int page, int N,
                         int window, int splits, int split_keys,
                         cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  auto kernel = decode_split<T, R, LPK, CPL>;
  // the ring, then the split's page ids; the warps' merge reuses the ring
  const size_t ring = (size_t)STAGES * 2 * KT * D * sizeof(T);
  const size_t smem = ring + (size_t)(split_keys / page) * sizeof(int);
  if ((size_t)NW * R * part_row(D) * sizeof(float) > ring)
    return cudaErrorInvalidValue;
  cudaError_t e = rt::allow_smem(kernel, smem, &allowed);
  if (e != cudaSuccess) return e;
  const int groups = (Hq / Hkv + R - 1) / R;
  kernel<<<dim3(B, Hkv * groups, splits), THREADS, smem, stream>>>(
      q, k_pool, v_pool, pt, ctx, out, part, Hq, Hkv, D, page, N, window,
      split_keys, LOG2E / sqrtf((float)D));
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  decode_combine<T><<<B * Hq, THREADS, 0, stream>>>(part, out, D, splits);
  return cudaGetLastError();
}

// R: query heads a block (larger groups take several blocks a KV head).
// LPK: lanes a key, CPL: 16-byte chunks a lane (LPK x CPL chunks cover a
// row of up to 256 head dims; lanes past the row's chunks idle). bf16 takes
// R = G rounded up to a power of two, at most 8, and LPK 16 up to D = 128
// (the serve path: decode_split<bf16, 4, 16, 1>), 32 above; f32 (the
// checks) runs a single instance.
template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* pt, const int* ctx, void* out, float* part,
                   int B, int Hq, int Hkv, int D, int page, int N, int window,
                   int splits, int split_keys, cudaStream_t stream) {
  auto run = [&](auto r, auto lpk, auto cpl) {
    return launch_split<T, decltype(r)::value, decltype(lpk)::value,
                        decltype(cpl)::value>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool, pt, ctx, (T*)out,
        part, B, Hq, Hkv, D, page, N, window, splits, split_keys, stream);
  };
  using I1 = std::integral_constant<int, 1>;
  using I16 = std::integral_constant<int, 16>;
  using I32 = std::integral_constant<int, 32>;
  if constexpr (sizeof(T) == 4) {
    return run(std::integral_constant<int, 4>(), I32(),
               std::integral_constant<int, 2>());
  } else {
    auto rows = [&](auto r) {
      return D <= 128 ? run(r, I16(), I1()) : run(r, I32(), I1());
    };
    const int G = Hq / Hkv;
    if (G == 1) return rows(I1());
    if (G == 2) return rows(std::integral_constant<int, 2>());
    if (G <= 4) return rows(std::integral_constant<int, 4>());
    return rows(std::integral_constant<int, 8>());
  }
}

}  // namespace

// partials: B * Hq * splits * (D + 2) floats (unused when splits == 1);
// split_keys a multiple of 32 with splits * split_keys >= N * page, and at
// most 1024 splits; D at most 256, a multiple of 16 bytes.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* ctx, void* out, void* partials, int B,
    int Hq, int Hkv, int D, int page, int N, int window, int splits,
    int split_keys, int dtype, void* stream) {
  if (D < 1 || D > 256 || splits < 1 || splits > MAX_SPLITS ||
      split_keys < KT ||
      split_keys % KT || (int64_t)splits * split_keys < (int64_t)N * page ||
      (splits > 1 && !partials))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto pt = (const int*)page_table;
  auto cl = (const int*)ctx;
  auto part = (float*)partials;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, pt, cl, out, part, B, Hq, Hkv, D,
                         page, N, window, splits, split_keys, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, pt, cl, out, part, B, Hq,
                                 Hkv, D, page, N, window, splits, split_keys,
                                 s);
  return (int)cudaErrorInvalidValue;
}
