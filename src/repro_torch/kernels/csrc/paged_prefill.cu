// Chunked-prefill attention over the block-paged KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel `paged_prefill_attention` /
// `_prefill_kernel` in src/repro/kernels/paged_attention/kernel.py: the Sq
// queries of a prompt chunk, at absolute positions q_start + i, attend over
// their sequence's pages, into which the chunk's own K/V were scattered
// before the call. Row r of a (sequence, KV head) pair is query token r / G
// of query head h * G + r % G; its mask is kpos <= q_start + r / G,
// kpos < ctx, and q_start + r / G - kpos < window when a window is set.
//
// What bounds it on the card: the operations. A 256-token chunk with G = 4
// over a context of a few hundred tokens does ~4 * Sq * G * ctx * D flops on
// ~2 * ctx * D * 2 bytes of K/V per KV head, about 2 * Sq * G flops per
// byte, far above the H100's ~295: the tensor cores.
//
// The bf16 design (paged_wgmma below), flash's over pages:
//  - a block's consumer warpgroup (128 threads) owns BM = 64 rows of one
//    (sequence, KV head): 64 / G tokens x the G heads of the group, so all
//    G heads share each K/V tile. At the serve shape (Sq 256, G 4, Hkv 8,
//    B 1) that is 128 blocks on the 132 SMs; two warpgroups of 128 rows
//    would leave half the card idle;
//  - Q is copied once into 128-byte-swizzled shared memory by cp.async
//    (rows past the chunk and head dims past D as zeros);
//  - K/V come in 64-key tiles into a ring of STAGES stages, with a full
//    and an empty mbarrier per stage, loaded by producer threads beside the
//    consumer warpgroup (warp specialisation: no load is issued from the
//    consumers' loop). The physical page of each key is read from the
//    block's page ids, which the block copies from its page-table row into
//    shared memory once. Where page % 16 == 0 and pages tile 64 keys
//    evenly, one producer warp loads each page as a TMA box through 4-D
//    tensor maps of the pools [P, page, Hkv, D]; a page that starts at or
//    past the block's key limit gets the page coordinate P, out of bounds,
//    and arrives as zeros without being read, and the slots of the page
//    that holds the limit, from the limit on, are zeroed in shared memory
//    before the products read them. Other page sizes go by
//    cp.async from a producer warpgroup into the same swizzled layout
//    (keys past the limit zero-filled), each thread's copies arriving on
//    the stage's full mbarrier when they land;
//  - the warpgroup runs the wgmma tile body of attention_wgmma.cuh, shared
//    with flash: S = Q K^T and O += P V as wgmma, the masked online softmax
//    on the accumulator fragments, P in registers, O in registers until one
//    final write divided by max(l, 1e-30); only the tiles that cross the
//    causal edge, the window's edge or ctx are masked element by element.
//    A stage is freed (its empty mbarrier) as soon as its P V product is
//    done.
// Each block streams only the key tiles its rows can see: from its first
// row's window start up to min(ctx, last row's position + 1). f32 inputs
// run on the CUDA cores (rt::attend_rows).
#include "attention_core.cuh"
#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------ f32: CUDA cores
constexpr int F32_ROWS = 64;      // query rows per block
constexpr int F32_THREADS = 256;

struct PrefillRows {   // rows [r0, r0 + F32_ROWS) of (sequence b, KV head h)
  const float* q;      // [B, Sq, Hq, D]
  float* o;
  int b, h, G, Sq, Hq, D, r0, q0;
  __device__ bool live(int r) const { return r0 + r < Sq * G; }
  __device__ size_t off(int r) const {
    const int rg = r0 + r, s = rg / G, g = rg % G;
    return (((size_t)b * Sq + s) * Hq + h * G + g) * D;
  }
  __device__ const float* q_row(int r) const {
    return live(r) ? q + off(r) : nullptr;
  }
  __device__ float* out(int r) const { return live(r) ? o + off(r) : nullptr; }
  __device__ int qpos(int r) const { return q0 + (r0 + r) / G; }
};

__global__ void paged_f32(const float* __restrict__ q,
                          const float* __restrict__ k_pool,
                          const float* __restrict__ v_pool,
                          const int* __restrict__ page_table,
                          const int* __restrict__ q_start,
                          const int* __restrict__ ctx_lens,
                          float* __restrict__ out, int Sq, int Hq, int Hkv,
                          int D, int page, int N, int window, float scale) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int r0 = tile * F32_ROWS;
  const int last = min(Sq * G, r0 + F32_ROWS) - 1;
  const int q0 = q_start[b];
  const int q_first = q0 + r0 / G, q_last = q0 + last / G;
  const int kv_hi = min(min(ctx_lens[b], N * page), q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q_first - window + 1) / page * page;
  PrefillRows rows{q, out, b, h, G, Sq, Hq, D, r0, q0};
  rt::PagedKeys<float> keys{k_pool, v_pool, page_table + (size_t)b * N,
                            page, Hkv, D, h};
  rt::attend_rows<float>(rows, keys, F32_ROWS, D, kv_lo, kv_hi,
                         /*causal=*/true, window, scale);
}

// ------------------------------------------- bf16: wgmma, paged K/V ring
constexpr int BM = 64;           // query rows per block (one warpgroup)
constexpr int CONSUMERS = 128;   // the warpgroup
// then the producers: one warp issues TMA page boxes, a warpgroup the
// 16-byte cp.async chunks (fewer threads could not issue them in time)
template <bool TMA> struct Roles {
  static constexpr int PRODUCERS = TMA ? 32 : 128;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
};
constexpr int KT = 64;           // keys per tile

// NC = ceil(D / 64) swizzle tiles of 64 head-dim columns; three stages
// where they fit beside Q at two blocks an SM, else two.
template <int NC> struct Tiles {
  static constexpr int STAGES = NC <= 2 ? 3 : 2;
  static constexpr size_t Q_BYTES = (size_t)NC * BM * 128;
  static constexpr size_t KV_BYTES = (size_t)NC * KT * 128;   // K or V tile
  static constexpr size_t BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + 1024: the dynamic shared memory is aligned up to the swizzle atom;
  // then the block's page ids, at most the page table's N
  static size_t smem(int N) { return BAR_OFF + STAGES * 16 + 1024 + 4 * N; }
};

// The block's ring: key tile n (keys kv_lo + n * KT ...) in stage
// n % STAGES. TMA: one thread loads whole pages (boxes of box_rows slots);
// else every thread copies 16-byte chunks. Only keys below kv_hi are read,
// their pages looked up in the block's page ids in shared memory.
template <int NC, bool TMA>
struct PagedRing {
  static constexpr int STAGES = Tiles<NC>::STAGES;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const bf16* k_pool;
  const bf16* v_pool;
  const int* pages;    // the block's page ids, from page kv_lo / page on
  bf16* ks;            // [STAGES][NC][KT][64]
  bf16* vs;
  uint64_t* full;      // [STAGES]: the tile has landed
  uint64_t* empty;     // [STAGES]: the consumers are done with it
  int h, Hkv, D, page, P, box_rows, kv_lo, kv_hi, n_tiles;

  // the producers: every tile in turn, each once its stage is free
  __device__ void produce() const {
    constexpr int NP = Roles<TMA>::PRODUCERS;
    const int pt = threadIdx.x - CONSUMERS;
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES, t0 = kv_lo + n * KT;
      if (n >= STAGES) hp::mbar_wait(&empty[s], (n / STAGES - 1) & 1);
      bf16* kt = ks + (size_t)s * NC * KT * 64;
      bf16* vt = vs + (size_t)s * NC * KT * 64;
      if constexpr (TMA) {
        if (pt != 0) continue;
        hp::mbar_expect_tx(&full[s], (uint32_t)(2 * Tiles<NC>::KV_BYTES));
        for (int i = 0; i < KT; i += box_rows) {
          const int key = t0 + i;
          const int pid = key < kv_hi ? pages[key / page - kv_lo / page] : P;
          for (int c = 0; c < NC; ++c) {
            const size_t at = ((size_t)c * KT + i) * 64;
            hp::tma_load_4d(kt + at, tk, &full[s], 64 * c, h, key % page, pid);
            hp::tma_load_4d(vt + at, tv, &full[s], 64 * c, h, key % page, pid);
          }
        }
      } else {
        for (int i = pt; i < KT * NC * 8; i += NP) {
          const int r = i / (NC * 8), c = (i / 8) % NC;
          const int col = 64 * c + 8 * (i % 8), key = t0 + r;
          const bool ok = key < kv_hi && col < D;
          size_t off = 0;
          if (ok)
            off = ((size_t)((int64_t)pages[key / page - kv_lo / page] * page +
                            key % page) * Hkv + h) * D + col;
          const int at = c * KT * 64 + hp::sw128(r, col & 63);
          hp::cp_async16(kt + at, k_pool + off, ok);
          hp::cp_async16(vt + at, v_pool + off, ok);
        }
        hp::cp_async_arrive(&full[s]);
      }
    }
    if constexpr (!TMA) hp::cp_async_wait_all();
  }
  // the consumers, before a tile's S product
  __device__ void wait(int it) const {
    hp::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    if constexpr (TMA) {
      // A page box brings its page's slots at and past kv_hi too: no row
      // sees them, but past ctx they may hold what a freed page left, and
      // P = 0 times a NaN or an Inf of V is NaN. They become zeros here,
      // as the cp.async path zero-fills them (only in the tile that holds
      // kv_hi, and only where kv_hi is not on a page's edge).
      const int t0 = kv_lo + it * KT;
      const int z0 = kv_hi - t0;
      const int z1 = min(KT, (kv_hi + page - 1) / page * page - t0);
      if (z0 < z1) {
        bf16* kt = ks + (size_t)(it % STAGES) * NC * KT * 64;
        bf16* vt = vs + (size_t)(it % STAGES) * NC * KT * 64;
        for (int i = threadIdx.x; i < (z1 - z0) * NC * 8; i += CONSUMERS) {
          const int r = z0 + i / (NC * 8), c = (i / 8) % NC;
          const int at = c * KT * 64 + hp::sw128(r, 8 * (i % 8));
          *reinterpret_cast<uint4*>(kt + at) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(vt + at) = make_uint4(0, 0, 0, 0);
        }
        hp::fence_proxy_async();          // st -> wgmma
        hp::bar_sync(1, CONSUMERS);
      }
    } else {
      hp::fence_proxy_async();            // cp.async -> wgmma
    }
  }
  // one thread, after the warpgroup's wgmma wait: the stage is free
  __device__ void release(int it) const {
    if (threadIdx.x == 0) hp::mbar_arrive(&empty[it % STAGES]);
  }
  __device__ const bf16* k(int it) const {
    return ks + (size_t)(it % STAGES) * NC * KT * 64;
  }
  __device__ const bf16* v(int it) const {
    return vs + (size_t)(it % STAGES) * NC * KT * 64;
  }
};

template <int NC, bool TMA>
__global__ void __launch_bounds__(Roles<TMA>::THREADS, 1)
paged_wgmma(const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ q,
            const bf16* __restrict__ k_pool, const bf16* __restrict__ v_pool,
            const int* __restrict__ page_table,
            const int* __restrict__ q_start, const int* __restrict__ ctx_lens,
            bf16* __restrict__ out, int Sq, int Hq, int Hkv, int D, int page,
            int N, int P, int window, float scale_log2) {
  using TL = Tiles<NC>;
  constexpr int STAGES = TL::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* qs = reinterpret_cast<bf16*>(sm);                 // [NC][BM][64]
  bf16* ks = reinterpret_cast<bf16*>(sm + TL::Q_BYTES);
  bf16* vs = ks + STAGES * TL::KV_BYTES / sizeof(bf16);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + TL::BAR_OFF);
  uint64_t* empty = full + STAGES;

  // the last row tiles see the most keys: they start first
  const int tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, rows = Sq * G;
  const int r0 = tile * BM;
  const int q0 = q_start[b];
  const int q_first = q0 + r0 / G, q_last = q0 + (min(rows, r0 + BM) - 1) / G;
  const int kv_limit = min(ctx_lens[b], N * page);
  const int kv_hi = min(kv_limit, q_last + 1);
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) / KT * KT : 0;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + KT - 1) / KT : 0;

  // the physical pages of the block's keys, once, into shared memory
  int* pages = reinterpret_cast<int*>(empty + STAGES);
  const int p_lo = kv_lo / page, p_hi = (kv_hi + page - 1) / page;
  constexpr int THREADS = Roles<TMA>::THREADS;
  for (int i = p_lo + threadIdx.x; i < p_hi; i += THREADS)
    pages[i - p_lo] = page_table[(size_t)b * N + i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], TMA ? 1 : Roles<TMA>::PRODUCERS);
      hp::mbar_init(&empty[s], 1);
    }
    hp::mbar_fence_init();
  }
  // Q: row r is token (r0 + r) / G, head h * G + (r0 + r) % G
  for (int i = threadIdx.x; i < BM * NC * 8; i += THREADS) {
    const int r = i / (NC * 8), c = (i / 8) % NC, col = 64 * c + 8 * (i % 8);
    const int rg = r0 + r;
    const bool ok = rg < rows && col < D;
    const bf16* src =
        ok ? q + (((size_t)b * Sq + rg / G) * Hq + h * G + rg % G) * D + col
           : q;
    hp::cp_async16(qs + c * BM * 64 + hp::sw128(r, col & 63), src, ok);
  }
  hp::cp_async_wait_all();
  hp::fence_proxy_async();
  __syncthreads();

  const PagedRing<NC, TMA> ring{&tk,  &tv,  k_pool, v_pool, pages,
                                ks,   vs,   full,   empty,  h,
                                Hkv,  D,    page,   P,      min(page, KT),
                                kv_lo, kv_hi, n_tiles};
  if (threadIdx.x >= CONSUMERS) {   // the producers
    ring.produce();
    return;
  }
  const int lane = threadIdx.x % 32, quad = lane % 4, warp = threadIdx.x / 32;
  const int ra = r0 + 16 * warp + lane / 4;      // rows ra, ra + 8
  const aw::Mask mask{kv_limit, 1,    window,
                      q_first,  q0 + (r0 + BM - 1) / G,
                      quad,     q0 + ra / G, q0 + (ra + 8) / G};
  float o[NC][32], m[2], l[2];
  aw::attend_tiles<NC, KT, BM>(qs, ring, 0, n_tiles, kv_lo, mask, scale_log2,
                               o, m, l);
  aw::store_rows<NC>(o, l, quad, D, [&](int hh) -> bf16* {
    const int rg = ra + 8 * hh;
    return rg < rows ? out + (((size_t)b * Sq + rg / G) * Hq + h * G +
                              rg % G) * D
                     : nullptr;
  });
}

// TMA page boxes where a page's slots are a whole number of 16-row pairs
// of swizzle groups and pages tile the 64-key tiles evenly (each box then
// lands 1024-byte aligned); else cp.async. On an H100, boxes of 8 rows
// (page 8) were slower than cp.async, boxes of 16 rows and more faster.
bool use_tma(int page) {
  return page % 16 == 0 && (KT % page == 0 || page % KT == 0);
}

template <int NC>
cudaError_t launch_wgmma(const void* q, const void* k_pool, const void* v_pool,
                         const int* page_table, const int* q_start,
                         const int* ctx, void* out, int B, int Sq, int Hq,
                         int Hkv, int D, int page, int N, int P, int window,
                         cudaStream_t stream) {
  static size_t allowed_tma = 48 * 1024, allowed_cp = 48 * 1024;
  const bool tma = use_tma(page);
  const int box = min(page, KT);
  CUtensorMap m[2] = {};
  if (tma && !(hp::encode_pool(&m[0], k_pool, P, page, Hkv, D, box) &&
               hp::encode_pool(&m[1], v_pool, P, page, Hkv, D, box)))
    return cudaErrorInvalidValue;
  auto kernel = tma ? paged_wgmma<NC, true> : paged_wgmma<NC, false>;
  const size_t smem = Tiles<NC>::smem(N);
  cudaError_t e =
      rt::allow_smem(kernel, smem, tma ? &allowed_tma : &allowed_cp);
  if (e != cudaSuccess) return e;
  const int G = Hq / Hkv;
  const dim3 grid((Sq * G + BM - 1) / BM, Hkv, B);
  const int nthreads = tma ? Roles<true>::THREADS : Roles<false>::THREADS;
  kernel<<<grid, nthreads, smem, stream>>>(
      m[0], m[1], (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool,
      page_table, q_start, ctx, (bf16*)out, Sq, Hq, Hkv, D, page, N, P, window,
      LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k_pool, const void* v_pool,
                       const int* page_table, const int* q_start,
                       const int* ctx, void* out, int B, int Sq, int Hq,
                       int Hkv, int D, int page, int N, int window,
                       cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int G = Hq / Hkv;
  const size_t smem = rt::smem_floats(F32_ROWS, D) * sizeof(float);
  cudaError_t e = rt::allow_smem(paged_f32, smem, &allowed);
  if (e != cudaSuccess) return e;
  const int tiles = (Sq * G + F32_ROWS - 1) / F32_ROWS;
  paged_f32<<<dim3(tiles, Hkv, B), F32_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool, page_table,
      q_start, ctx, (float*)out, Sq, Hq, Hkv, D, page, N, window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; P is the pools' page count. Returns a
// cudaError_t (0 = launched).
extern "C" int rt_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* q_start, const void* ctx, void* out,
    int B, int Sq, int Hq, int Hkv, int D, int page, int N, int P, int window,
    int dtype, void* stream) {
  auto s = (cudaStream_t)stream;
  auto pt = (const int*)page_table;
  auto qs = (const int*)q_start;
  auto cl = (const int*)ctx;
  if (dtype == 0)
    return launch_f32(q, k_pool, v_pool, pt, qs, cl, out, B, Sq, Hq, Hkv, D,
                      page, N, window, s);
  if (dtype != 1 || D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  switch ((D + 63) / 64) {
    case 1:
      return launch_wgmma<1>(q, k_pool, v_pool, pt, qs, cl, out, B, Sq, Hq,
                             Hkv, D, page, N, P, window, s);
    case 2:
      return launch_wgmma<2>(q, k_pool, v_pool, pt, qs, cl, out, B, Sq, Hq,
                             Hkv, D, page, N, P, window, s);
    case 3:
      return launch_wgmma<3>(q, k_pool, v_pool, pt, qs, cl, out, B, Sq, Hq,
                             Hkv, D, page, N, P, window, s);
    default:
      return launch_wgmma<4>(q, k_pool, v_pool, pt, qs, cl, out, B, Sq, Hq,
                             Hkv, D, page, N, P, window, s);
  }
}
