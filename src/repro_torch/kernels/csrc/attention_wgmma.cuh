// The wgmma tile body of the bf16 attention kernels (flash and paged
// prefill): one warpgroup owns 64 query rows, held in 128-byte-swizzled
// shared memory, and walks key tiles of KT keys that its kernel brings into
// a ring of stages (K and V tiles [NC][KT][64], 128-byte swizzle, NC =
// ceil(D / 64) column blocks; head dims past D are zeros).
//
// Per key tile: S = Q K^T is wgmma with Q and K from shared memory
// (K-major), f32 accumulators; the masked online softmax runs on the
// accumulator fragments in registers, in the log2 domain (row max and sum
// across the quad that shares a row); P is rounded to bf16 in registers and
// is the register A operand of O += P V, with V read through a transposed
// (MN-major) descriptor. S of tile n and P V of tile n - 1 are issued
// together, so the softmax of tile n runs while the tensor cores do the P V
// product. O stays in registers for the whole key loop and is written once,
// divided by max(l, 1e-30), so a row that sees no key returns 0.
//
// The two kernels differ only in how a tile reaches its stage (a `Ring`:
// wait(it), release(it), k(it), v(it)) and in where a row's query sits
// (the `Mask`'s positions and the `store_rows` callback).
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace aw {

using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;    // initial running max (finite, as in Pallas)

// Which keys a warpgroup's rows see, for the tiles that need a mask. A
// thread holds rows row_a and row_a + 8 of the accumulator fragments, at
// query positions qpos_a and qpos_b (two scalars: ptxas selected between
// the elements of an array here, which cost flash ~4%);
// q_min and q_max bound the positions of the warpgroup's 64 rows.
struct Mask {
  int kv_limit, causal, window, q_min, q_max, quad, qpos_a, qpos_b;
  // every key of tile [t0, t0 + kt) is seen by all 64 rows
  __device__ __forceinline__ bool open(int t0, int kt) const {
    return t0 + kt <= kv_limit && (!causal || t0 + kt - 1 <= q_min) &&
           (window <= 0 || t0 >= q_max - window + 1);
  }
  // fragment row h (0: row_a, 1: row_a + 8) sees key j
  __device__ __forceinline__ bool seen(int h, int j) const {
    const int i = h ? qpos_b : qpos_a;
    return j < kv_limit && (!causal || j <= i) &&
           (window <= 0 || i - j < window);
  }
};

// S = Q K^T of one key tile: NC x 4 k-steps of 16 head dims. Q is the
// warpgroup's 64 rows of a [NC][QROWS][64] tile.
template <int NC, int KT, int QROWS>
__device__ __forceinline__ void issue_qk(float (&sc)[KT / 2], const bf16* qw,
                                         const bf16* kt) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da =
          hp::desc_sw128(qw + c * QROWS * 64 + kk * 16, 16, 1024);
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
// alpha is the factor O must be rescaled by. l stays a per-thread partial
// sum until the end.
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
      if (!mask.seen((r >> 1) & 1, j)) sc[r] = -INFINITY;
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

// The warpgroup's key tiles [it_lo, it_hi), tile it starting at key
// kv_lo + it * KT: O (zeroed here), the running max m (log2 units of the
// scaled scores) and l accumulate over them. Each tile's stage is waited
// for before its S product and released once its P V product is done.
template <int NC, int KT, int QROWS, typename Ring>
__device__ __forceinline__ void attend_tiles(const bf16* qw, const Ring& ring,
                                             int it_lo, int it_hi, int kv_lo,
                                             const Mask& mask,
                                             float scale_log2,
                                             float (&o)[NC][32],
                                             float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[c][r] = 0.f;
  float alpha[2];
  m[0] = m[1] = NEG;
  l[0] = l[1] = 0.f;
  if (it_lo >= it_hi) return;
  float sc[KT / 2];
  uint32_t pa[KT / 16][4];
  ring.wait(it_lo);
  hp::fence_regs(sc);
  hp::wgmma_fence();
  issue_qk<NC, KT, QROWS>(sc, qw, ring.k(it_lo));
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(sc);
  online_softmax<KT>(sc, m, l, alpha, mask, kv_lo + it_lo * KT, scale_log2);
  to_bf16_frags<KT>(sc, pa);
  for (int it = it_lo + 1; it < it_hi; ++it) {
    ring.wait(it);
    hp::fence_regs(sc);
    fence_o<NC>(o);
    hp::wgmma_fence();
    issue_qk<NC, KT, QROWS>(sc, qw, ring.k(it));
    hp::wgmma_commit();
    issue_pv<NC, KT>(o, pa, ring.v(it - 1));
    hp::wgmma_commit();
    hp::wgmma_wait<1>();
    hp::fence_regs(sc);
    online_softmax<KT>(sc, m, l, alpha, mask, kv_lo + it * KT, scale_log2);
    hp::wgmma_wait<0>();
    fence_o<NC>(o);
    ring.release(it - 1);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int r = 0; r < 32; ++r) o[c][r] *= alpha[(r >> 1) & 1];
    to_bf16_frags<KT>(sc, pa);
  }
  fence_o<NC>(o);
  hp::wgmma_fence();
  issue_pv<NC, KT>(o, pa, ring.v(it_hi - 1));
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  fence_o<NC>(o);
  ring.release(it_hi - 1);
}

// O / l for the thread's two rows: row_out(h) is the bf16 output row of
// fragment row h (row_a + 8 h), or nullptr for a row that is not written;
// head dims below D only.
template <int NC, typename RowOut>
__device__ __forceinline__ void store_rows(const float (&o)[NC][32],
                                           const float (&l)[2], int quad,
                                           int D, const RowOut& row_out) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    bf16* orow = row_out(h);
    if (!orow) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
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

// Each row's log-sum-exp of its scaled scores, in the natural log: m is in
// log2 units, so lse = (m + log2 l) ln 2 (l summed across the quad first).
// row_lse(h) is the f32 slot of fragment row h (row_a + 8 h), or nullptr for
// a row that is not written; the quad's first thread writes it.
template <typename RowLse>
__device__ __forceinline__ void store_lse(const float (&m)[2],
                                          const float (&l)[2], int quad,
                                          const RowLse& row_lse) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    float* slot = row_lse(h);
    if (slot && quad == 0)
      *slot = (m[h] + log2f(fmaxf(lt, 1e-30f))) * 0.6931471805599453f;
  }
}

}  // namespace aw
