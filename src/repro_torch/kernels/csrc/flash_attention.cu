// Forward flash attention (GQA, causal or bidirectional, optional sliding
// window), for Hopper.
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
//  - S = Q K^T is wgmma with Q and K from shared memory (128-byte swizzle,
//    K-major), f32 accumulators. The masked online softmax runs on the
//    accumulator fragments in registers (row max and sum across the quad
//    by shuffles); P is rounded to bf16 in registers and is the register A
//    operand of the second wgmma, O += P V, with V read through a
//    transposed (MN-major) descriptor. O stays in registers for the whole
//    key loop and is written once, divided by max(l, 1e-30);
//  - per key tile, S of tile n and O += P V of tile n - 1 are issued
//    together, so the softmax of tile n runs while the tensor cores do the
//    P V product (P of tile n - 1 stays in its registers until then);
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
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ f32: CUDA cores
constexpr int ROWS = rt::TC_ROWS;   // query positions per block
constexpr int THREADS = rt::TC_THREADS;

struct FlashRows {   // query positions [r0, r0 + ROWS) of head hq, batch b
  const float* q;    // [B, Sq, Hq, D]
  float* o;
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
                          int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                          int window, float scale) {
  const int tile = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int r0 = tile * ROWS;
  const int q_last = min(Sq, r0 + ROWS) - 1;
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, r0 - window + 1) / rt::KT * rt::KT;
  FlashRows rows{q, out, b, hq, Sq, Hq, D, r0};
  DenseKeys keys{k, v, b, hq / G, Sk, Hkv, D};
  rt::attend_rows<float>(rows, keys, ROWS, D, kv_lo, kv_hi, causal != 0,
                         window, scale);
}

// ------------------------------------------------- bf16: wgmma, TMA ring
constexpr int BM = 128;          // query rows per block (two warpgroups)
constexpr int WG_THREADS = 128;
constexpr int BLOCK_THREADS = 2 * WG_THREADS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;    // initial running max (finite, as in Pallas)

// Key tile: 128 keys while O fits beside a 128-wide S (head dim <= 128),
// else 64; three stages where they fit in shared memory, else two. NC =
// ceil(D / 64) swizzle tiles of 64 head-dim columns.
template <int NC> struct Tiles {
  static constexpr int KT = NC <= 2 ? 128 : 64;
  static constexpr int STAGES = NC <= 2 ? 3 : 2;
  static constexpr size_t Q_BYTES = (size_t)NC * BM * 128;
  static constexpr size_t KV_BYTES = (size_t)NC * KT * 128;   // K or V tile
  static constexpr size_t BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + 1024: the dynamic shared memory is aligned up to the swizzle atom
  static constexpr size_t SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// Which keys a warpgroup's rows see, for the tiles that need a mask: a
// thread holds rows row_a and row_a + 8 of the accumulator fragments.
struct Mask {
  int Sk, causal, window, w0, row_a, quad;
  // every key of tile [t0, t0 + kt) is seen by all 64 rows
  __device__ bool open(int t0, int kt) const {
    return t0 + kt <= Sk && (!causal || t0 + kt - 1 <= w0) &&
           (window <= 0 || t0 >= w0 + 64 - window);
  }
  __device__ bool seen(int i, int j) const {
    return j < Sk && (!causal || j <= i) && (window <= 0 || i - j < window);
  }
};

// S = Q K^T of one key tile: NC x 4 k-steps of 16 head dims.
template <int NC, int KT>
__device__ __forceinline__ void issue_qk(float (&sc)[KT / 2], const bf16* qw,
                                         const bf16* kt) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da =
          hp::desc_sw128(qw + c * BM * 64 + kk * 16, 16, 1024);
      const uint64_t db = hp::desc_sw128(kt + c * KT * 64 + kk * 16, 16, 1024);
      if constexpr (KT == 128)
        hp::wgmma_m64n128k16_ss(sc, da, db, c | kk);
      else
        hp::wgmma_m64n64k16_ss(sc, da, db, c | kk);
    }
}

// O += P V of one key tile: P from registers, 16 keys a k-step, V through
// the transposed descriptor, one 64-column block of O per instruction.
template <int NC, int KT>
__device__ __forceinline__ void issue_pv(float (&o)[NC][32],
                                         const uint32_t (&pa)[KT / 16][4],
                                         const bf16* vt) {
#pragma unroll
  for (int k16 = 0; k16 < KT / 16; ++k16)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      hp::wgmma_m64n64k16_rs_tb(
          o[c], pa[k16],
          hp::desc_sw128(vt + (c * KT + 16 * k16) * 64, KT * 128, 1024));
}

template <int NC>
__device__ __forceinline__ void fence_o(float (&o)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) hp::fence_regs(o[c]);
}

// The masked online softmax of one tile on the accumulator fragments, in
// the log2 domain: scores become probabilities in place, m and l advance,
// alpha is the factor O must be rescaled by. Row max and row sum go across
// the quad that shares a row; l stays a per-thread partial sum until the
// end.
template <int KT>
__device__ __forceinline__ void online_softmax(float (&sc)[KT / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const Mask& mask, int t0,
                                               float scale_log2) {
  if (!mask.open(t0, KT)) {
#pragma unroll
    for (int r = 0; r < KT / 2; ++r) {
      const int j = t0 + 8 * (r / 4) + 2 * mask.quad + (r & 1);
      if (!mask.seen(mask.row_a + 8 * ((r >> 1) & 1), j)) sc[r] = -INFINITY;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int r = 2 * h; r < KT / 2; r += 4)
      mx = fmaxf(mx, fmaxf(sc[r], sc[r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * scale_log2);
    alpha[h] = hp::exp2_approx(m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int r = 2 * h; r < KT / 2; r += 4) {
      sc[r] = hp::exp2_approx(fmaf(sc[r], scale_log2, -m_new));
      sc[r + 1] = hp::exp2_approx(fmaf(sc[r + 1], scale_log2, -m_new));
      sum += sc[r] + sc[r + 1];
    }
    l[h] = l[h] * alpha[h] + sum;
    m[h] = m_new;
  }
}

// P to bf16 A fragments: the accumulator layout of 16 keys is the A
// operand's layout, two values a register.
template <int KT>
__device__ __forceinline__ void to_bf16_frags(const float (&sc)[KT / 2],
                                              uint32_t (&pa)[KT / 16][4]) {
#pragma unroll
  for (int k16 = 0; k16 < KT / 16; ++k16)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      __nv_bfloat162 p2 = __floats2bfloat162_rn(sc[8 * k16 + 2 * u],
                                                sc[8 * k16 + 2 * u + 1]);
      pa[k16][u] = *reinterpret_cast<uint32_t*>(&p2);
    }
}

template <int NC>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
            int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
            float scale_log2) {
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

  // Key tile n into its stage (free: both warpgroups are done with the
  // tile STAGES before it), by one thread.
  auto load = [&](int n) {
    const int s = n % STAGES;
    hp::mbar_expect_tx(&full[s], (uint32_t)(2 * TL::KV_BYTES));
    for (int c = 0; c < NC; ++c) {
      const size_t at = ((size_t)s * NC + c) * KT * 64;
      hp::tma_load_4d(ks + at, &tk, &full[s], 64 * c, hkv, kv_lo + n * KT, b);
      hp::tma_load_4d(vs + at, &tv, &full[s], 64 * c, hkv, kv_lo + n * KT, b);
    }
  };
  if (threadIdx.x == 0) {
    hp::mbar_expect_tx(qbar, (uint32_t)TL::Q_BYTES);
    for (int c = 0; c < NC; ++c)
      hp::tma_load_4d(qs + c * BM * 64, &tq, qbar, 64 * c, hq, r0, b);
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load(n);
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
  const Mask mask{Sk, causal, window, w0, row_a, quad};
  auto wait_full = [&](int it) {
    hp::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
  };
  // A warpgroup frees tile it's stage once its products have read it (one
  // thread, after the warpgroup's wgmma wait); the second of the two to do
  // so loads tile it + STAGES into the stage. Neither waits for the other.
  // Every warpgroup frees every tile once, in order.
  auto release = [&](int it) {
    if (threadIdx.x % WG_THREADS == 0 &&
        atomicAdd(&freed[it % STAGES], 1) == 1) {
      freed[it % STAGES] = 0;
      if (it + STAGES < n_tiles) load(it + STAGES);
    }
  };
  auto k_tile = [&](int it) { return ks + (it % STAGES) * NC * KT * 64; };
  auto v_tile = [&](int it) { return vs + (it % STAGES) * NC * KT * 64; };
  const bf16* qw = qs + 64 * cw * 64;

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[c][r] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[KT / 2];
  uint32_t pa[KT / 16][4];

  hp::mbar_wait(qbar, 0);
  for (int it = 0; it < it_lo; ++it) {   // tiles before the window
    wait_full(it);
    release(it);
  }
  if (it_lo < it_hi) {
    // S of the first tile, then per tile: S of tile it and O += P V of
    // tile it - 1 in flight together, the softmax of tile it running
    // while the tensor cores do the P V product
    wait_full(it_lo);
    hp::fence_regs(sc);
    hp::wgmma_fence();
    issue_qk<NC, KT>(sc, qw, k_tile(it_lo));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    online_softmax<KT>(sc, m, l, alpha, mask, kv_lo + it_lo * KT,
                       scale_log2);
    to_bf16_frags<KT>(sc, pa);
    for (int it = it_lo + 1; it < it_hi; ++it) {
      wait_full(it);
      hp::fence_regs(sc);
      fence_o<NC>(o);
      hp::wgmma_fence();
      issue_qk<NC, KT>(sc, qw, k_tile(it));
      hp::wgmma_commit();
      issue_pv<NC, KT>(o, pa, v_tile(it - 1));
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);
      online_softmax<KT>(sc, m, l, alpha, mask, kv_lo + it * KT,
                         scale_log2);
      hp::wgmma_wait<0>();
      fence_o<NC>(o);
      release(it - 1);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int r = 0; r < 32; ++r) o[c][r] *= alpha[(r >> 1) & 1];
      to_bf16_frags<KT>(sc, pa);
    }
    fence_o<NC>(o);
    hp::wgmma_fence();
    issue_pv<NC, KT>(o, pa, v_tile(it_hi - 1));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    fence_o<NC>(o);
    release(it_hi - 1);
  }
  for (int it = it_hi; it < n_tiles; ++it) {   // tiles past the diagonal
    wait_full(it);
    release(it);
  }

  // O / l, rows below Sq and head dims below D only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int i = row_a + 8 * h;
    if (i >= Sq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow = out + (((size_t)b * Sq + i) * Hq + hq) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = 64 * c + 8 * g + 2 * quad;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * g + 2 * h] * inv,
                                    o[c][4 * g + 2 * h + 1] * inv);
      }
  }
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
                         void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                         int D, int causal, int window, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  CUtensorMap m[3];
  if (!encode_maps(m, q, k, v, B, Sq, Sk, Hq, Hkv, D, Tiles<NC>::KT))
    return cudaErrorInvalidValue;
  cudaError_t e = rt::allow_smem(flash_wgmma<NC>, Tiles<NC>::SMEM, &allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, (Sq + BM - 1) / BM, B);
  flash_wgmma<NC><<<grid, BLOCK_THREADS, Tiles<NC>::SMEM, stream>>>(
      m[0], m[1], m[2], (bf16*)out, Sq, Sk, Hq, Hkv, D, causal, window,
      LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int Hq, int Hkv, int D,
                       int causal, int window, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const size_t smem = rt::smem_floats(ROWS, D) * sizeof(float);
  cudaError_t e = rt::allow_smem(flash_f32, smem, &allowed);
  if (e != cudaSuccess) return e;
  const int tiles = (Sq + ROWS - 1) / ROWS;
  flash_f32<<<dim3(tiles, Hq, B), THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk,
      Hq, Hkv, D, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int Sq, int Sk, int Hq,
                                  int Hkv, int D, int causal, int window,
                                  int dtype, void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window, s);
  if (dtype != 1 || D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  switch ((D + 63) / 64) {
    case 1:
      return launch_wgmma<1>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                             window, s);
    case 2:
      return launch_wgmma<2>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                             window, s);
    case 3:
      return launch_wgmma<3>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                             window, s);
    default:
      return launch_wgmma<4>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
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
