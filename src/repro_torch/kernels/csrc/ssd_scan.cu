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
// Chunkwise form, as the Pallas kernel computes it: over a chunk of L
// tokens with cum_i the inclusive cumsum of log_a inside the chunk and
// tot = cum_{L-1},
//
//   y_i   = (q_i e^{cum_i}) . S_prev + sum_{j <= i} (q_i . k_j) e^{cum_i - cum_j} v_j
//   S_new = e^{tot} S_prev + sum_j (k_j e^{tot - cum_j}) v_j^T
//
// Every decay factor used is <= 1 (cum falls within a chunk), so nothing
// overflows; the one exponent that could (cum_i - cum_j for i < j) is only
// evaluated behind the causal select, never multiplied by a masked zero.
// The chunk is a fixed L = 64 tokens; a ragged last chunk is masked (its
// missing tokens act as q = k = v = 0 and log_a = 0), where the Pallas
// wrapper and the plain version shrink the chunk to a divisor of T. The
// recurrence is the same; only the rounding differs.
//
// What bounds it on the card: the operations, in f32. At xLSTM width (dk =
// 512, dv = 513) one head does ~4 T dk dv flops on ~T (dk + dv) inputs,
// far more than the H100's ~20 f32 flops per byte. The state and v are
// f32 (the recurrence must keep 1e-4 of the plain version, which TF32's
// 10-bit mantissa does not), so the products run on the CUDA cores in f32.
//
// What the design does about it: the [dk, dv] f32 state is 1 MB at xLSTM
// width, far over a block's 227 KB of shared memory, so it is tiled over
// dv: one block per (batch, head, DVT = 16 value columns) carries its
// [dk, DVT] slice in shared memory through a sequential loop over the
// chunks (132 blocks at xLSTM width and B = 1: the card's 132 SMs). The
// [L, L] scores need all of dk and are the same for every dv tile, so a
// first kernel computes them once per (batch, head, chunk), fully in
// parallel, into a scratch the wrapper allocates; the scan kernel reads
// them. q and k are still read once per dv tile (from L2). No atomics: the
// result is bitwise reproducible. Tensor cores (wgmma), TMA and wider
// loads are for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int L = 64;          // tokens per chunk
constexpr int THREADS = 256;
constexpr int SKT = 32;        // dk per shared-memory tile, scores kernel
constexpr int DVT = 16;        // value columns per block, scan kernel
constexpr int KT = 64;         // state rows per shared-memory tile, scan kernel
constexpr int GROUPS = THREADS / DVT;   // 16 row groups of a DVT-wide tile
constexpr int RPT = L / GROUPS;         // chunk rows per thread (4)
constexpr int SRT = KT / GROUPS;        // state rows per thread and tile (4)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Kernel 1. Grid (chunks, H, B). P[i, j] = (q_i . k_j) e^{cum_i - cum_j}
// for i >= j, else 0, and the chunk's inclusive cumsum of log_a. Each
// thread holds a 4 x 4 tile of P (rows ti + 16 a, columns tj + 16 b).
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
ssd_scores(const TQ* __restrict__ q, const TQ* __restrict__ k,
           const float* __restrict__ log_a, float* __restrict__ P,
           float* __restrict__ cum_out, int T, int H, int dk) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int t0 = c * L;
  const int tid = threadIdx.x;
  __shared__ float qs[L][SKT + 1];
  __shared__ float ks[L][SKT + 1];
  __shared__ float cum[L];
  if (tid < L) {
    const int t = t0 + tid;
    cum[tid] = t < T ? log_a[((size_t)b * T + t) * H + h] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < L; ++i) {
      s += cum[i];
      cum[i] = s;
    }
  }
  __syncthreads();
  const int ti = tid / 16, tj = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < dk; k0 += SKT) {
    for (int e = tid; e < L * SKT; e += THREADS) {
      const int i = e / SKT, kk = e % SKT, t = t0 + i, d = k0 + kk;
      const bool ok = t < T && d < dk;
      const size_t off = (((size_t)b * T + t) * H + h) * dk + d;
      qs[i][kk] = ok ? ld(q + off) : 0.f;
      ks[i][kk] = ok ? ld(k + off) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SKT; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = qs[ti + 16 * r][kk];
        bb[r] = ks[tj + 16 * r][kk];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], bb[s], acc[r][s]);
    }
    __syncthreads();
  }
  const size_t blk = ((size_t)b * H + h) * nc + c;
  float* Pc = P + blk * L * L;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = ti + 16 * r, j = tj + 16 * s;
      // select before multiplying: e^{cum_i - cum_j} may be inf for i < j
      Pc[i * L + j] = i >= j ? acc[r][s] * expf(cum[i] - cum[j]) : 0.f;
    }
  if (tid < L) cum_out[blk * L + tid] = cum[tid];
}

// Shared memory of the scan kernel, in floats.
__host__ __device__ inline size_t scan_smem_floats(int dk) {
  return (size_t)dk * DVT     // S, the state slice [dk][DVT]
         + L * DVT            // v of the chunk [L][DVT]
         + L * (L + 1)        // P of the chunk [L][L], padded rows
         + 2 * L * (KT + 1)   // decayed q and k tiles [L][KT], padded rows
         + 3 * L;             // cum, e^{cum}, e^{tot - cum}
}

// Kernel 2. Grid (ceil(dv / DVT), H, B). Thread (grp, col) owns column
// col of the tile: chunk rows grp + 16 r of y, and state rows
// k0 + grp + 16 r of each KT-row tile of S.
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
ssd_chunks(const TQ* __restrict__ q, const TQ* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ P,
           const float* __restrict__ cum_in, float* __restrict__ y,
           float* __restrict__ final_state, int T, int H, int dk, int dv) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = (T + L - 1) / L;
  const int c0 = tile * DVT;
  const int tid = threadIdx.x;
  const int col = tid % DVT, grp = tid / DVT;
  const int d_col = c0 + col;
  extern __shared__ float smem[];
  float* S = smem;
  float* vs = S + (size_t)dk * DVT;
  float* Ps = vs + L * DVT;
  float* qs = Ps + L * (L + 1);
  float* ks = qs + L * (KT + 1);
  float* cum = ks + L * (KT + 1);
  float* eq = cum + L;
  float* ek = eq + L;
  for (int e = tid; e < dk * DVT; e += THREADS) S[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    const size_t blk = ((size_t)b * H + h) * nc + c;
    for (int e = tid; e < L * DVT; e += THREADS) {
      const int i = e / DVT, d = c0 + e % DVT, t = t0 + i;
      vs[e] = (t < T && d < dv) ? v[(((size_t)b * T + t) * H + h) * dv + d]
                                : 0.f;
    }
    const float* Pc = P + blk * L * L;
    for (int e = tid; e < L * L; e += THREADS)
      Ps[(e / L) * (L + 1) + e % L] = Pc[e];
    if (tid < L) cum[tid] = cum_in[blk * L + tid];
    __syncthreads();
    const float tot = cum[L - 1];
    if (tid < L) {
      eq[tid] = expf(cum[tid]);
      ek[tid] = expf(tot - cum[tid]);
    }
    // intra-chunk: y_i = sum_{j <= i} P_ij v_j (P is 0 above the diagonal)
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = grp + GROUPS * r;
      const float* Pi = Ps + i * (L + 1);
      float s = 0.f;
      for (int j = 0; j <= i; ++j) s = fmaf(Pi[j], vs[j * DVT + col], s);
      acc[r] = s;
    }
    const float etot = expf(tot);
    for (int k0 = 0; k0 < dk; k0 += KT) {
      const int kn = min(KT, dk - k0);
      __syncthreads();   // eq/ek written; the previous tile's reads done
      for (int e = tid; e < L * KT; e += THREADS) {
        const int i = e / KT, kk = e % KT, t = t0 + i;
        const bool ok = t < T && kk < kn;
        const size_t off = (((size_t)b * T + t) * H + h) * dk + k0 + kk;
        qs[i * (KT + 1) + kk] = ok ? ld(q + off) * eq[i] : 0.f;
        ks[i * (KT + 1) + kk] = ok ? ld(k + off) * ek[i] : 0.f;
      }
      __syncthreads();
      // inter-chunk: y_i += (q_i e^{cum_i}) . S_prev[k0 : k0 + kn, col]
      for (int kk = 0; kk < kn; ++kk) {
        const float s = S[(k0 + kk) * DVT + col];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          acc[r] = fmaf(qs[(grp + GROUPS * r) * (KT + 1) + kk], s, acc[r]);
      }
      __syncthreads();   // every read of these state rows is done
      // state rows k0 + rr: S = e^{tot} S + sum_j (k_j e^{tot - cum_j}) v_j
      float upd[SRT] = {};
      for (int j = 0; j < L; ++j) {
        const float vj = vs[j * DVT + col];
        const float* kj = ks + j * (KT + 1);
#pragma unroll
        for (int r = 0; r < SRT; ++r)
          upd[r] = fmaf(kj[grp + GROUPS * r], vj, upd[r]);
      }
#pragma unroll
      for (int r = 0; r < SRT; ++r) {
        const int rr = grp + GROUPS * r;
        if (rr < kn) {
          float* sp = S + (k0 + rr) * DVT + col;
          *sp = etot * *sp + upd[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int t = t0 + grp + GROUPS * r;
      if (t < T && d_col < dv)
        y[(((size_t)b * T + t) * H + h) * dv + d_col] = acc[r];
    }
    __syncthreads();   // before the next chunk overwrites vs, Ps and cum
  }
  if (d_col < dv)
    for (int kk = grp; kk < dk; kk += GROUPS)
      final_state[(((size_t)b * H + h) * dk + kk) * dv + d_col] =
          S[kk * DVT + col];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

template <typename TQ>
cudaError_t launch(const void* q, const void* k, const float* v,
                   const float* log_a, float* y, float* final_state,
                   float* scores, float* cum, int B, int T, int H, int dk,
                   int dv, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int nc = (T + L - 1) / L;
  ssd_scores<TQ><<<dim3(nc, H, B), THREADS, 0, stream>>>(
      (const TQ*)q, (const TQ*)k, log_a, scores, cum, T, H, dk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = scan_smem_floats(dk) * sizeof(float);
  e = allow_smem(ssd_chunks<TQ>, smem, &allowed);
  if (e != cudaSuccess) return e;
  ssd_chunks<TQ><<<dim3((dv + DVT - 1) / DVT, H, B), THREADS, smem, stream>>>(
      (const TQ*)q, (const TQ*)k, v, scores, cum, y, final_state, T, H, dk,
      dv);
  return cudaGetLastError();
}

}  // namespace

// q, k [B, T, H, dk] in qk_dtype (0 = float32, 1 = bfloat16); v [B, T, H,
// dv], log_a [B, T, H], y [B, T, H, dv] and final_state [B, H, dk, dv] f32;
// scores [B, H, ceil(T/64), 64, 64] and cum [B, H, ceil(T/64), 64] f32
// scratch. Returns a cudaError_t (0 = launched).
extern "C" int rt_ssd_scan(const void* q, const void* k, const void* v,
                           const void* log_a, void* y, void* final_state,
                           void* scores, void* cum, int B, int T, int H,
                           int dk, int dv, int qk_dtype, void* stream) {
  auto s = (cudaStream_t)stream;
  auto vi = (const float*)v;
  auto la = (const float*)log_a;
  auto yo = (float*)y;
  auto fo = (float*)final_state;
  auto sc = (float*)scores;
  auto cu = (float*)cum;
  if (qk_dtype == 0)
    return launch<float>(q, k, vi, la, yo, fo, sc, cu, B, T, H, dk, dv, s);
  if (qk_dtype == 1)
    return launch<__nv_bfloat16>(q, k, vi, la, yo, fo, sc, cu, B, T, H, dk,
                                 dv, s);
  return (int)cudaErrorInvalidValue;
}
