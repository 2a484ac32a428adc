// Forward flash attention (GQA, causal or bidirectional, optional sliding
// window), for Hopper. Optionally it also writes each query row's
// log-sum-exp of its scaled scores (lse [B, Sq, Hq] f32, natural log), which
// the backward pass (attention_ops.FlashAttention, plain PyTorch as the
// reference's jnp custom VJP is) recomputes the probabilities from; serving
// passes no lse buffer and no lse is written.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention/kernel.py. Query i and key j sit at
// positions i and j; a key is seen when j < seq_k, j <= i when causal, and
// i - j < window when a window is set. A row that sees no key returns 0.
//
// What bounds it on the card: the operations. A causal prefill of S tokens
// does ~2 * S^2 * D flops per query head on O(S * D) bytes, hundreds of flops
// per byte at S = 2048, above the H100's ~295 flops per byte: the tensor
// cores are the way to its peak. f32 inputs run on the CUDA cores
// (rt::attend_rows, off the serve path).
//
// The bf16 design (flash_wgmma below), for Hopper's TMA and wgmma:
//  - a block of 256 threads takes BM = 128 query rows of one query head:
//    warpgroups 0 and 1 each own 64 rows;
//  - one thread issues TMA loads through 4-D tensor maps over the
//    [B, S, H, D] arrays (dims D, H, S, B): the Q tile once, then K and V
//    tiles of KT keys into a ring of STAGES stages, each with a full
//    mbarrier and a count of the warpgroups done with it: the second
//    warpgroup to free the stage of tile n loads tile n + STAGES into it
//    (neither waits for the other). Keys past seq_k and head dims
//    past D arrive as zeros (D is padded to 64-column swizzle tiles in
//    shared memory only);
//  - each warpgroup runs the wgmma tile body of attention_wgmma.cuh
//    (shared with paged prefill): S = Q K^T and O += P V as wgmma, the
//    masked online softmax on the accumulator fragments, P in registers,
//    S of tile n issued beside P V of tile n - 1, O in registers until one
//    final write divided by max(l, 1e-30);
//  - registers: a producer warpgroup with setmaxnreg (40 registers to it,
//    232 to each consumer, in a block of 384 threads) left ptxas at the
//    launch bound's 168 registers for the whole kernel, spilling the
//    consumers' O, S and P fragments and serialising their wgmma; so did
//    a single producer warp (288 threads: one of the
//    SM's four register-file quarters holds three warps). Without a
//    producer, every thread of the 256 may have 255 registers, which the
//    pipeline needs (O 64, S 64 and P 32 a thread at D = 128).
// Each block walks key tiles only from its window start up to its causal
// diagonal; only tiles that cross the diagonal, seq_k or the window's edge
// are masked element by element. Blocks run the longest (last) query tiles
// first, all heads of a tile side by side. A block takes one query head,
// not the G heads of a KV head: its 128 rows already fill two warpgroups,
// and the K/V re-read by the G heads of a group comes from the L2 cache
// (8 KV heads x 2048 keys are 8 MB), read by their blocks at about the
// same time.
#include <math.h>

#include <chrono>

#include "attention_core.cuh"
#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ f32: CUDA cores
constexpr int ROWS = 64;       // query positions per block
constexpr int THREADS = 256;

struct FlashRows {   // query positions [r0, r0 + ROWS) of head hq, batch b
  const float* q;    // [B, Sq, Hq, D]
  float* o;
  float* lse_;       // [B, Sq, Hq] or nullptr
  int b, hq, Sq, Hq, D, r0;
  __device__ bool live(int r) const { return r0 + r < Sq; }
  __device__ size_t off(int r) const {
    return (((size_t)b * Sq + r0 + r) * Hq + hq) * D;
  }
  __device__ const float* q_row(int r) const {
    return live(r) ? q + off(r) : nullptr;
  }
  __device__ float* out(int r) const { return live(r) ? o + off(r) : nullptr; }
  __device__ int qpos(int r) const { return r0 + r; }
  __device__ float* operator()(int r) const {   // row r's lse slot
    return lse_ && live(r) ? lse_ + ((size_t)b * Sq + r0 + r) * Hq + hq
                           : nullptr;
  }
};

struct DenseKeys {   // k/v [B, Sk, Hkv, D], KV head h of batch b
  const float* k_;
  const float* v_;
  int b, h, Sk, Hkv, D;
  __device__ size_t off(int kpos) const {
    return (((size_t)b * Sk + kpos) * Hkv + h) * D;
  }
  __device__ const float* k(int kpos) const { return k_ + off(kpos); }
  __device__ const float* v(int kpos) const { return v_ + off(kpos); }
};

__global__ void flash_f32(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ lse, int Sq, int Sk, int Hq,
                          int Hkv, int D, int causal, int window,
                          float scale) {
  const int tile = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int r0 = tile * ROWS;
  const int q_last = min(Sq, r0 + ROWS) - 1;
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, r0 - window + 1) / rt::KT * rt::KT;
  FlashRows rows{q, out, lse, b, hq, Sq, Hq, D, r0};
  DenseKeys keys{k, v, b, hq / G, Sk, Hkv, D};
  rt::attend_rows<float>(rows, keys, ROWS, D, kv_lo, kv_hi, causal != 0,
                         window, scale, rows);
}

// ------------------------------------------------- bf16: wgmma, TMA ring
constexpr int BM = 128;          // query rows per block (two warpgroups)
constexpr int WG_THREADS = 128;
constexpr int BLOCK_THREADS = 2 * WG_THREADS;
constexpr float LOG2E = 1.4426950408889634f;
template <int NC> struct Tiles {
  static constexpr int KT = NC <= 2 ? 128 : 64;
  static constexpr int STAGES = NC <= 2 ? 3 : 2;
  static constexpr size_t Q_BYTES = (size_t)NC * BM * 128;
  static constexpr size_t KV_BYTES = (size_t)NC * KT * 128;   // K or V tile
  static constexpr size_t BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + 1024: the dynamic shared memory is aligned up to the swizzle atom
  static constexpr size_t SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// The TMA ring of one block: tile it in stage it % STAGES, filled by one
// thread, with a full mbarrier per stage and a count of the warpgroups done
// with it: the second warpgroup to free the stage of tile n loads tile
// n + STAGES into it (neither waits for the other). Every warpgroup frees
// every tile once, in order.
template <int NC>
struct FlashRing {
  using TL = Tiles<NC>;
  static constexpr int KT = TL::KT, STAGES = TL::STAGES;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  bf16* ks;
  bf16* vs;
  uint64_t* full;
  int* freed;
  int hkv, kv_lo, b, n_tiles;
  __device__ void load(int n) const {
    const int s = n % STAGES;
    hp::mbar_expect_tx(&full[s], (uint32_t)(2 * TL::KV_BYTES));
    for (int c = 0; c < NC; ++c) {
      const size_t at = ((size_t)s * NC + c) * KT * 64;
      hp::tma_load_4d(ks + at, tk, &full[s], 64 * c, hkv, kv_lo + n * KT, b);
      hp::tma_load_4d(vs + at, tv, &full[s], 64 * c, hkv, kv_lo + n * KT, b);
    }
  }
  __device__ void wait(int it) const {
    hp::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
  }
  // one thread of the warpgroup, after the warpgroup's wgmma wait
  __device__ void release(int it) const {
    if (threadIdx.x % WG_THREADS == 0 &&
        atomicAdd(&freed[it % STAGES], 1) == 1) {
      freed[it % STAGES] = 0;
      if (it + STAGES < n_tiles) load(it + STAGES);
    }
  }
  __device__ const bf16* k(int it) const {
    return ks + (it % STAGES) * NC * KT * 64;
  }
  __device__ const bf16* v(int it) const {
    return vs + (it % STAGES) * NC * KT * 64;
  }
};

template <int NC>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
            float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int D,
            int causal, int window, float scale_log2) {
  using TL = Tiles<NC>;
  constexpr int KT = TL::KT, STAGES = TL::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* qs = reinterpret_cast<bf16*>(sm);                 // [NC][BM][64]
  // K and V rings: [STAGES][NC][KT][64] each
  bf16* ks = reinterpret_cast<bf16*>(sm + TL::Q_BYTES);
  bf16* vs = ks + STAGES * TL::KV_BYTES / sizeof(bf16);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + TL::BAR_OFF);
  uint64_t* full = qbar + 1;
  int* freed = reinterpret_cast<int*>(full + STAGES);   // [STAGES]

  // grid (Hq, query tiles, B): the heads of one query tile run side by
  // side (the G heads of a KV head read the same K/V tiles from L2 at about
  // the same time), and the longest (last) query tiles first
  const int hq = blockIdx.x, tile = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int r0 = tile * BM;
  const int q_last = min(Sq, r0 + BM) - 1;
  const int kv_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_lo = window > 0 ? max(0, r0 - window + 1) / KT * KT : 0;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + KT - 1) / KT : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      freed[s] = 0;
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  const FlashRing<NC> ring{&tk, &tv, ks, vs, full, freed, hkv, kv_lo, b,
                           n_tiles};
  if (threadIdx.x == 0) {
    hp::mbar_expect_tx(qbar, (uint32_t)TL::Q_BYTES);
    for (int c = 0; c < NC; ++c)
      hp::tma_load_4d(qs + c * BM * 64, &tq, qbar, 64 * c, hq, r0, b);
    for (int n = 0; n < min(STAGES, n_tiles); ++n) ring.load(n);
  }

  const int cw = threadIdx.x / WG_THREADS;       // warpgroup: 0 or 1
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int warp = (threadIdx.x % WG_THREADS) / 32;
  const int w0 = r0 + 64 * cw;                   // warpgroup's first row
  const int row_a = w0 + 16 * warp + lane / 4;   // rows row_a, row_a + 8
  // the warpgroup's own key tiles [it_lo, it_hi) of the block's n_tiles
  int it_lo = 0, it_hi = 0;
  if (w0 < Sq) {
    const int hi = causal ? min(Sk, min(Sq, w0 + 64)) : Sk;
    const int lo = window > 0 ? max(0, w0 - window + 1) : 0;
    it_lo = min(n_tiles, (lo - kv_lo) / KT);
    it_hi = max(it_lo, min(n_tiles, (hi - kv_lo + KT - 1) / KT));
  }
  const aw::Mask mask{Sk,   causal, window, w0, w0 + 63,
                      quad, row_a,  row_a + 8};

  hp::mbar_wait(qbar, 0);
  for (int it = 0; it < it_lo; ++it) {   // tiles before the window
    ring.wait(it);
    ring.release(it);
  }
  float o[NC][32], m[2], l[2];
  aw::attend_tiles<NC, KT, BM>(qs + 64 * cw * 64, ring, it_lo, it_hi, kv_lo,
                               mask, scale_log2, o, m, l);
  for (int it = it_hi; it < n_tiles; ++it) {   // tiles past the diagonal
    ring.wait(it);
    ring.release(it);
  }
  // O / l, rows below Sq only
  aw::store_rows<NC>(o, l, quad, D, [&](int h) -> bf16* {
    const int i = row_a + 8 * h;
    return i < Sq ? out + (((size_t)b * Sq + i) * Hq + hq) * D : nullptr;
  });
  if (lse)   // the same for every thread of the block
    aw::store_lse(m, l, quad, [&](int h) -> float* {
      const int i = row_a + 8 * h;
      return i < Sq ? lse + ((size_t)b * Sq + i) * Hq + hq : nullptr;
    });
}

// The three tensor maps of one call (Q with BM-row boxes, K and V with
// KT-row boxes); false when the driver refuses them.
bool encode_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
                 int B, int Sq, int Sk, int Hq, int Hkv, int D, int kt) {
  return hp::encode_bshd(&m[0], q, B, Sq, Hq, D, BM) &&
         hp::encode_bshd(&m[1], k, B, Sk, Hkv, D, kt) &&
         hp::encode_bshd(&m[2], v, B, Sk, Hkv, D, kt);
}

template <int NC>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Sk, int Hq,
                         int Hkv, int D, int causal, int window,
                         cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  CUtensorMap m[3];
  if (!encode_maps(m, q, k, v, B, Sq, Sk, Hq, Hkv, D, Tiles<NC>::KT))
    return cudaErrorInvalidValue;
  cudaError_t e = rt::allow_smem(flash_wgmma<NC>, Tiles<NC>::SMEM, &allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, (Sq + BM - 1) / BM, B);
  flash_wgmma<NC><<<grid, BLOCK_THREADS, Tiles<NC>::SMEM, stream>>>(
      m[0], m[1], m[2], (bf16*)out, lse, Sq, Sk, Hq, Hkv, D, causal, window,
      LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                       int D, int causal, int window, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const size_t smem = rt::smem_floats(ROWS, D) * sizeof(float);
  cudaError_t e = rt::allow_smem(flash_f32, smem, &allowed);
  if (e != cudaSuccess) return e;
  const int tiles = (Sq + ROWS - 1) / ROWS;
  flash_f32<<<dim3(tiles, Hq, B), THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, Sq,
      Sk, Hq, Hkv, D, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: [B, Sq, Hq] f32, or null for none.
// Returns a cudaError_t (0 = launched).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D, int causal,
                                  int window, int dtype, void* stream) {
  auto s = (cudaStream_t)stream;
  auto l = (float*)lse;
  if (dtype == 0)
    return launch_f32(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, D, causal, window,
                      s);
  if (dtype != 1 || D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  switch ((D + 63) / 64) {
    case 1:
      return launch_wgmma<1>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, D, causal,
                             window, s);
    case 2:
      return launch_wgmma<2>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, D, causal,
                             window, s);
    case 3:
      return launch_wgmma<3>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, D, causal,
                             window, s);
    default:
      return launch_wgmma<4>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, D, causal,
                             window, s);
  }
}

// Host cost of one bf16 call's tensor maps: the mean nanoseconds of
// encoding the three maps over `reps` encodings (no launch). Negative when
// the driver refuses them.
extern "C" double rt_flash_encode_ns(const void* q, const void* k,
                                     const void* v, int B, int Sq, int Sk,
                                     int Hq, int Hkv, int D, int reps) {
  CUtensorMap m[3];
  const int kt = (D + 63) / 64 <= 2 ? 128 : 64;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (!encode_maps(m, q, k, v, B, Sq, Sk, Hq, Hkv, D, kt)) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / reps;
}
