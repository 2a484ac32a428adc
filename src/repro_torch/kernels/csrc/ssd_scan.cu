// Chunked scalar-decay linear recurrence (SSD form), for Hopper.
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_kernel` in
// src/repro/kernels/ssd_scan/kernel.py. Per (batch, head), with a_t =
// exp(log_a_t) <= 1:
//
//   S_t = a_t S_{t-1} + k_t v_t^T        (S: [dk, dv], f32, S_0 = 0)
//   y_t = q_t . S_t
//
// and it returns y [B, T, H, dv] and the final state S_T [B, H, dk, dv],
// both f32, which continues the recurrence exactly (one more decode step
// from it equals the scan over one more token).
//
// Chunkwise form: over a chunk c of L tokens with cum_i the inclusive
// cumsum of log_a inside the chunk and tot = cum_{L-1},
//
//   y_i = e^{cum_i} (q_i . S_c)
//         + sum_{j <= i} (q_i . k_j) e^{cum_i - cum_j} v_j
//   S_{c+1} = e^{tot} S_c + sum_j k_j (e^{tot - cum_j} v_j)^T
//
// where S_c is the state entering chunk c (S_0 = 0). Every decay factor
// used is <= 1 (cum falls within a chunk); e^{cum_i - cum_j} for i < j is
// only evaluated behind the causal select. The chunk is a fixed L = 64
// tokens; a ragged last chunk is masked (its missing tokens act as q = k =
// v = 0 and log_a = 0), where the Pallas wrapper and the plain version
// shrink the chunk to a divisor of T: the same recurrence, other rounding.
//
// What bounds it on the card: the operations, in f32. At xLSTM width (dk =
// 512, dv = 513) one head does ~4 T dk dv flops (the state update and the
// q . S products) on ~T (dk + dv) inputs, far more than the H100's ~20 f32
// flops per byte. v and the state are f32 (the recurrence must keep 1e-4 of
// the plain version, which TF32's 10-bit mantissa does not), so the
// products run on the CUDA cores in f32.
//
// What the design does about it (the chunk-parallel form): the 1 MB state
// of a head is far over a block's shared memory, and a sequential scan per
// head (the earlier design: one block per 16 value columns, 132 blocks of 8
// warps at xLSTM width) leaves too few warps to hide any latency, so the
// work is split in two launches whose blocks are all independent:
//  1. ssd_states, B H (dk/64 x dv/64 tiles + nc) blocks. Tile blocks carry
//     one 64 x 64 tile of the state in registers (a 4 x 4 micro-tile a
//     thread) through the sequential chunk loop, S = e^{tot} S + K^T (w V),
//     and store the state entering each chunk c >= 1 to a scratch (a tile
//     needs only its own 64 dims of k and 64 columns of v). The last B H nc
//     blocks compute, beside them, each chunk's [L, L] scores (transposed,
//     P^T[j][i]) and its decayed queries (transposed, q_i e^{cum_i}).
//  2. ssd_outputs, grid (dv/64, nc, B H): y = (Q e^{cum}) S_c + P V for one
//     chunk and 64 columns, the reduction over dk in slices of 32.
// Every product reads 16-byte float4 operands from shared memory into a
// 4 x 4 register micro-tile (16 FMAs for two loads): K by token row and V
// by column (states), the decayed Q transposed and S by column (outputs).
// Tiles arrive through cp.async (16-byte copies where rows are 16-byte
// aligned, 4-byte ones for v at odd dv and for log_a), double-buffered: the
// next tile is in flight while the current one is computed. The cumsum of
// log_a is a warp shuffle scan, run by each warp that needs it. The decay
// factors are applied in the pass that converts a tile (w V, bf16 k to f32)
// or where the scores block writes the queries. Blocks of 256 threads with
// <= 66 KB of shared memory, three to an SM (24 warps): the 288 tile blocks
// of xLSTM width at B = 1 run in one wave. The form's extra traffic: the
// (nc - 1) entering states, written once and read once (7 x 1.18 MB per
// head at T = 512, dv padded to 576 columns), and the decayed queries (1 MB
// a head in f32), read once per 64 value columns, mostly from L2.
// No atomics: the result is bitwise reproducible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 64;          // tokens per chunk
constexpr int TILE = 64;       // state dims / value columns per block
constexpr int THREADS = 256;   // 16 x 16 threads of 4 x 4 micro-tiles
constexpr int KS = 32;         // dk per slice of the scores and outputs
static_assert(THREADS == 4 * L && TILE == 64 && L == 64,
              "the converting pass gives each thread 4 x 4 values");
constexpr int MIN_BLOCKS = 3; // blocks an SM holds (the register budget)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------- copies
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from global to shared; zeros when !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages a ROWS x COLS tile of a row-major source (row r at src + r *
// stride) into dst [ROWS][LD]; elements at r >= rows_ok or c >= cols_ok
// read as 0. With `vec` (16-byte aligned rows and tile, cols_ok a multiple
// of the vector) in 16-byte copies; else in 4-byte copies (f32) or plain
// loads (bf16 rows that are not 4-byte aligned).
template <int ROWS, int COLS, int LD, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t stride,
                                      int rows_ok, int cols_ok, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    constexpr int CPR = COLS / V;
    for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * V;
      const bool ok = r < rows_ok && c < cols_ok;
      cp16(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const bool ok = r < rows_ok && c < cols_ok;
      if constexpr (sizeof(T) == 4)
        cp4(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
      else
        dst[r * LD + c] = ok ? src[r * stride + c] : T(0.f);
    }
  }
}

// Stages the chunk's L values of log_a (tokens past T read 0) into la[L]
// with 4-byte copies; they complete with the caller's next commit group.
__device__ __forceinline__ void stage_log_a(float* la, const float* log_a,
                                            int b, int h, int t0,
                                            const int T, const int H) {
  if (threadIdx.x < L) {
    const int t = t0 + threadIdx.x;
    const float* src = log_a + ((size_t)b * T + min(t, T - 1)) * H + h;
    cp4(la + threadIdx.x, src, t < T);
  }
}

// The inclusive cumsum of a chunk's log_a (la[L], shared memory), in one
// warp by a shuffle scan: lane l returns cum[2 l] and cum[2 l + 1]. Every
// warp that needs it runs it; cum[j] is then in lane j / 2.
__device__ __forceinline__ float2 warp_cumsum(const float* la) {
  const int l = threadIdx.x & 31;
  const float a = la[2 * l], b = la[2 * l + 1];
  float incl = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, o);
    if (l >= o) incl += n;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (l == 0) excl = 0.f;
  return make_float2(excl + a, incl);
}

// cum[j] from the warp's scan (j may differ between lanes)
__device__ __forceinline__ float cum_at(float2 cw, int j) {
  const float x = __shfl_sync(0xffffffffu, cw.x, j >> 1);
  const float y = __shfl_sync(0xffffffffu, cw.y, j >> 1);
  return (j & 1) ? y : x;
}

// acc[r][s] += a[r] b[s] over float4 operands
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct Shape {
  int B, T, H, dk, dv, nc, dkt, dvt, dvp;
  bool vec_qk, vec_v;   // 16-byte copies of q/k rows, of v rows
};

// ------------------------------------------------ 1a. scores of a chunk
// P^T[j][i] = (q_i . k_j) e^{cum_i - cum_j} for i >= j, else 0, and the
// chunk's decayed queries transposed, qT[d][i] = q_i[d] e^{cum_i}, for the
// outputs. q and k slices are converted to f32 and transposed (qT[d][i],
// kT[d][j]) so the micro-tile reads both as float4.
template <typename TQ>
__device__ void scores_block(const TQ* q, const TQ* k, const float* log_a,
                             float* PT, float* qT_out, int c, int h, int b,
                             const Shape& sh, unsigned char* smem) {
  constexpr int LDR = KS + 16 / sizeof(TQ);   // raw rows, one vector padded
  TQ* rq = reinterpret_cast<TQ*>(smem);       // [2][L][LDR]
  TQ* rk = rq + 2 * L * LDR;
  float* qT = reinterpret_cast<float*>(rk + 2 * L * LDR);   // [KS][L]
  float* kT = qT + KS * L;
  float* la = kT + KS * L;                                   // [L]
  float* cum = la + L;                                       // [L]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * L, rows_ok = min(L, sh.T - t0);
  const size_t stride = (size_t)sh.H * sh.dk;
  const size_t base = (((size_t)b * sh.T + t0) * sh.H + h) * sh.dk;
  const size_t blk = ((size_t)b * sh.H + h) * sh.nc + c;
  const int n_sl = (sh.dk + KS - 1) / KS;
  auto issue = [&](int s) {
    const int cols = min(KS, sh.dk - s * KS);
    stage<L, KS, LDR>(rq + (s & 1) * L * LDR, q + base + s * KS, stride,
                      rows_ok, cols, sh.vec_qk);
    stage<L, KS, LDR>(rk + (s & 1) * L * LDR, k + base + s * KS, stride,
                      rows_ok, cols, sh.vec_qk);
    cp_commit();
  };
  stage_log_a(la, log_a, b, h, t0, sh.T, sh.H);
  issue(0);
  // this thread writes tokens 4 u .. 4 u + 3 of the decayed queries
  const int u = tid % 16;
  float eq[4];
  float acc[4][4] = {};
  for (int s = 0; s < n_sl; ++s) {
    if (s + 1 < n_sl) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
      const float2 cw = warp_cumsum(la);
#pragma unroll
      for (int r = 0; r < 4; ++r) eq[r] = expf(cum_at(cw, 4 * u + r));
      if (tid < 32) {
        cum[2 * tid] = cw.x;
        cum[2 * tid + 1] = cw.y;
      }
    }
    const TQ* sq = rq + (s & 1) * L * LDR;
    const TQ* sk = rk + (s & 1) * L * LDR;
    for (int e = tid; e < L * KS; e += THREADS) {
      const int t = e % L, d = e / L;
      qT[d * L + t] = to_f(sq[t * LDR + d]);
      kT[d * L + t] = to_f(sk[t * LDR + d]);
    }
    __syncthreads();
    for (int e = tid; e < KS * L / 4; e += THREADS) {
      const int d = e / 16, dd = s * KS + d;
      if (dd < sh.dk) {
        const float4 x = ld4(qT + d * L + 4 * u);
        *reinterpret_cast<float4*>(qT_out + (blk * sh.dk + dd) * L + 4 * u) =
            make_float4(x.x * eq[0], x.y * eq[1], x.z * eq[2], x.w * eq[3]);
      }
    }
#pragma unroll 8
    for (int d = 0; d < KS; ++d)
      outer4(acc, ld4(qT + d * L + 4 * ty), ld4(kT + d * L + 4 * tx));
    __syncthreads();
  }
  float* P = PT + blk * L * L;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = 4 * tx + s;
    float o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      // select before multiplying: e^{cum_i - cum_j} may be inf for i < j
      o[r] = i >= j ? acc[r][s] * expf(cum[i] - cum[j]) : 0.f;
    }
    *reinterpret_cast<float4*>(P + j * L + 4 * ty) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// ----------------------------------------- 1b. a state tile through T
// Tile (d0, n0) of the state: rows d0 + 4 ty + r, columns n0 + 4 tx + s.
template <typename TQ>
__device__ void state_block(const TQ* k, const float* v, const float* log_a,
                            float* states, float* final_state, int d0, int n0,
                            int h, int b, const Shape& sh,
                            unsigned char* smem) {
  TQ* rk = reinterpret_cast<TQ*>(smem);                      // [2][L][TILE]
  float* rv = reinterpret_cast<float*>(rk + 2 * L * TILE);   // [2][L][TILE]
  float* la = rv + 2 * L * TILE;                             // [2][L]
  float* kf = la + 2 * L;     // [L][TILE] f32 copy of bf16 k
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int dk_ok = min(TILE, sh.dk - d0), dv_ok = min(TILE, sh.dv - n0);
  auto issue = [&](int c) {
    const int t0 = c * L, rows_ok = min(L, sh.T - t0);
    const size_t row = ((size_t)b * sh.T + t0) * sh.H + h;
    stage<L, TILE, TILE>(rk + (c & 1) * L * TILE, k + row * sh.dk + d0,
                         (size_t)sh.H * sh.dk, rows_ok, dk_ok, sh.vec_qk);
    stage<L, TILE, TILE>(rv + (c & 1) * L * TILE, v + row * sh.dv + n0,
                         (size_t)sh.H * sh.dv, rows_ok, dv_ok, sh.vec_v);
    stage_log_a(la + (c & 1) * L, log_a, b, h, t0, sh.T, sh.H);
    cp_commit();
  };
  float st[4][4] = {};
  issue(0);
  for (int c = 0; c < sh.nc; ++c) {
    const int slot = c & 1;
    if (c + 1 < sh.nc) {
      issue(c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // every warp scans the chunk's log_a; the converting pass (four values
    // of rows j = tid / 16 + 16 i a thread, a warp on two whole rows)
    // scales v_j by e^{tot - cum_j} and turns bf16 k into f32
    const float2 cw = warp_cumsum(la + slot * L);
    const float tot = __shfl_sync(0xffffffffu, cw.y, 31);
    float* vs = rv + slot * L * TILE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = tid / 16 + 16 * i, e0 = j * TILE + (tid % 16) * 4;
      const float wj = expf(tot - cum_at(cw, j));
      float4 x = ld4(vs + e0);
      x.x *= wj;
      x.y *= wj;
      x.z *= wj;
      x.w *= wj;
      *reinterpret_cast<float4*>(vs + e0) = x;
      if constexpr (sizeof(TQ) != 4) {
        const TQ* kr = rk + slot * L * TILE + e0;
        *reinterpret_cast<float4*>(kf + e0) = make_float4(
            to_f(kr[0]), to_f(kr[1]), to_f(kr[2]), to_f(kr[3]));
      }
    }
    if (c > 0) {   // the state entering chunk c, for the outputs
      float* dst = states + ((((size_t)b * sh.H + h) * (sh.nc - 1) + c - 1) *
                                 sh.dk + d0) * sh.dvp + n0 + 4 * tx;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * ty + r < dk_ok)
          *reinterpret_cast<float4*>(dst + (size_t)(4 * ty + r) * sh.dvp) =
              make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
    }
    __syncthreads();
    const float etot = expf(tot);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) st[r][s] *= etot;
    const float* ks = sizeof(TQ) == 4
                          ? reinterpret_cast<const float*>(rk) + slot * L * TILE
                          : kf;
#pragma unroll 8
    for (int j = 0; j < L; ++j)
      outer4(st, ld4(ks + j * TILE + 4 * ty), ld4(vs + j * TILE + 4 * tx));
    __syncthreads();   // before the next issue overwrites this slot
  }
  float* fs = final_state + (((size_t)b * sh.H + h) * sh.dk + d0) * sh.dv + n0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (4 * ty + r < dk_ok && 4 * tx + s < dv_ok)
        fs[(size_t)(4 * ty + r) * sh.dv + 4 * tx + s] = st[r][s];
}

template <typename TQ>
constexpr size_t scores_smem() {
  return 4 * (size_t)L * (KS + 16 / sizeof(TQ)) * sizeof(TQ) +
         (2 * KS * L + 2 * L) * sizeof(float);
}
template <typename TQ>
constexpr size_t state_smem() {
  return 2 * (size_t)L * TILE * sizeof(TQ) +
         (2 * L * TILE + 2 * L + (sizeof(TQ) == 4 ? 0 : L * TILE)) *
             sizeof(float);
}
template <typename TQ>
constexpr size_t states_kernel_smem() {
  return scores_smem<TQ>() > state_smem<TQ>() ? scores_smem<TQ>()
                                              : state_smem<TQ>();
}

// Kernel 1. A 1-D grid: first B x H x (dk tiles x dv tiles) blocks that
// carry a state tile each (dispatched first: their chunk loop is the long
// one), then B x H x nc blocks that compute a chunk's scores and decayed
// queries each.
template <typename TQ>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssd_states(const TQ* __restrict__ q, const TQ* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ log_a,
           float* __restrict__ PT, float* __restrict__ qT,
           float* __restrict__ states, float* __restrict__ final_state,
           Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = sh.dkt * sh.dvt;
  int x = blockIdx.x;
  if (x < sh.B * sh.H * tiles) {
    const int tile = x % tiles, bh = x / tiles;
    state_block<TQ>(k, v, log_a, states, final_state,
                    (tile / sh.dvt) * TILE, (tile % sh.dvt) * TILE,
                    bh % sh.H, bh / sh.H, sh, smem);
    return;
  }
  x -= sh.B * sh.H * tiles;
  const int bh = x / sh.nc;
  scores_block<TQ>(q, k, log_a, PT, qT, x % sh.nc, bh % sh.H, bh / sh.H, sh,
                   smem);
}

// ---------------------------------------------------- 2. the outputs
// y rows t0 + 4 ty + r, columns n0 + 4 tx + s of chunk c: the decayed
// queries (qT, from kernel 1) times the entering state, slice by slice,
// then the chunk's P V.
constexpr size_t OUTPUTS_SMEM =
    (2 * KS * L + 2 * KS * TILE + L * L + L * TILE) * sizeof(float);

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssd_outputs(const float* __restrict__ qT, const float* __restrict__ v,
            const float* __restrict__ PT, const float* __restrict__ states,
            float* __restrict__ y, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [2][KS][L]
  float* ss = qs + 2 * KS * L;                  // [2][KS][TILE]
  float* ps = ss + 2 * KS * TILE;               // [L][L] P^T
  float* vs = ps + L * L;                       // [L][TILE]
  const int n0 = blockIdx.x * TILE, c = blockIdx.y;
  const int b = blockIdx.z / sh.H, h = blockIdx.z % sh.H;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int t0 = c * L, rows_ok = min(L, sh.T - t0);
  const int dv_ok = min(TILE, sh.dv - n0);
  const size_t blk = ((size_t)b * sh.H + h) * sh.nc + c;
  const size_t row = ((size_t)b * sh.T + t0) * sh.H + h;
  const int n_sl = (sh.dk + KS - 1) / KS;
  auto issue = [&](int s) {   // slice s of the queries and of the state
    const int rows = min(KS, sh.dk - s * KS);
    stage<KS, L, L>(qs + (s & 1) * KS * L,
                    qT + (blk * sh.dk + (size_t)s * KS) * L, L, rows, L,
                    true);
    stage<KS, TILE, TILE>(
        ss + (s & 1) * KS * TILE,
        states + ((((size_t)b * sh.H + h) * (sh.nc - 1) + c - 1) * sh.dk +
                  (size_t)s * KS) * sh.dvp + n0,
        sh.dvp, rows, TILE, true);
  };
  stage<L, L, L>(ps, PT + blk * L * L, L, L, L, true);
  stage<L, TILE, TILE>(vs, v + row * sh.dv + n0, (size_t)sh.H * sh.dv,
                       rows_ok, dv_ok, sh.vec_v);
  if (c > 0) issue(0);
  cp_commit();
  float acc[4][4] = {};
  // inter-chunk: (q_i e^{cum_i}) . S_c (no state enters chunk 0)
  for (int s = 0; c > 0 && s < n_sl; ++s) {
    if (s + 1 < n_sl) {
      issue(s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sq = qs + (s & 1) * KS * L;
    const float* sS = ss + (s & 1) * KS * TILE;
#pragma unroll 8
    for (int d = 0; d < KS; ++d)
      outer4(acc, ld4(sq + d * L + 4 * ty), ld4(sS + d * TILE + 4 * tx));
    __syncthreads();   // before the next issue overwrites this slot
  }
  cp_wait<0>();
  __syncthreads();
  // intra-chunk: sum_{j <= i} P_ij v_j (P^T[j][i] is 0 for j > i)
  const int j_end = 4 * ty + 4;
  for (int j = 0; j < j_end; ++j)
    outer4(acc, ld4(ps + j * L + 4 * ty), ld4(vs + j * TILE + 4 * tx));
  float* yo = y + row * sh.dv + n0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (4 * ty + r < rows_ok && 4 * tx + s < dv_ok)
        yo[(size_t)(4 * ty + r) * sh.H * sh.dv + 4 * tx + s] = acc[r][s];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TQ>
cudaError_t launch(const void* q, const void* k, const float* v,
                   const float* log_a, float* y, float* final_state,
                   float* scores, float* qT, float* states, int B, int T,
                   int H, int dk, int dv, cudaStream_t stream) {
  static bool ready = false;
  constexpr size_t smem1 = states_kernel_smem<TQ>();
  if (!ready) {
    cudaError_t e = allow_smem(ssd_states<TQ>, smem1);
    if (e == cudaSuccess) e = allow_smem(ssd_outputs, OUTPUTS_SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  Shape sh;
  sh.B = B;
  sh.T = T;
  sh.H = H;
  sh.dk = dk;
  sh.dv = dv;
  sh.nc = (T + L - 1) / L;
  sh.dkt = (dk + TILE - 1) / TILE;
  sh.dvt = (dv + TILE - 1) / TILE;
  sh.dvp = sh.dvt * TILE;
  sh.vec_qk = dk % (16 / sizeof(TQ)) == 0 && aligned16(q) && aligned16(k);
  sh.vec_v = dv % 4 == 0 && aligned16(v);
  ssd_states<TQ><<<B * H * (sh.dkt * sh.dvt + sh.nc), THREADS, smem1,
                   stream>>>(
      (const TQ*)q, (const TQ*)k, v, log_a, scores, qT, states, final_state,
      sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_outputs<<<dim3(sh.dvt, sh.nc, B * H), THREADS, OUTPUTS_SMEM, stream>>>(
      qT, v, scores, states, y, sh);
  return cudaGetLastError();
}

}  // namespace

// q, k [B, T, H, dk] in qk_dtype (0 = float32, 1 = bfloat16); v [B, T, H,
// dv], log_a [B, T, H], y [B, T, H, dv] and final_state [B, H, dk, dv] f32;
// f32 scratch, nc = ceil(T / 64): scores [B, H, nc, 64, 64] (P
// transposed), qt [B, H, nc, dk, 64] (the decayed queries, transposed) and
// states [B, H, max(nc - 1, 1), dk, ceil(dv / 64) * 64]. Returns a
// cudaError_t (0 = launched).
extern "C" int rt_ssd_scan(const void* q, const void* k, const void* v,
                           const void* log_a, void* y, void* final_state,
                           void* scores, void* qt, void* states, int B, int T,
                           int H, int dk, int dv, int qk_dtype, void* stream) {
  auto s = (cudaStream_t)stream;
  auto vi = (const float*)v;
  auto la = (const float*)log_a;
  auto yo = (float*)y;
  auto fo = (float*)final_state;
  auto sc = (float*)scores;
  auto qo = (float*)qt;
  auto st = (float*)states;
  if (qk_dtype == 0)
    return launch<float>(q, k, vi, la, yo, fo, sc, qo, st, B, T, H, dk, dv, s);
  if (qk_dtype == 1)
    return launch<__nv_bfloat16>(q, k, vi, la, yo, fo, sc, qo, st, B, T, H,
                                 dk, dv, s);
  return (int)cudaErrorInvalidValue;
}
