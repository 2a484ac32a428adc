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
// What bounds it on the card: at a 256-token chunk with G = 4 over a context
// of a few hundred tokens it does ~4 * Sq * G * ctx * D flops on ~2 * ctx * D
// * bytes of K/V per KV head, about 2 * Sq * G flops per byte: the operations
// bound it, on the tensor cores. bf16 inputs run Q K^T and P V there through
// WMMA (mma.sync; wgmma is a later change); f32 inputs run on the CUDA
// cores.
//
// What the design does about it: where the Pallas program holds every row of
// the chunk (Sq * G = 1024 at a 256-token chunk) in one grid step, here the
// rows are tiled over blocks, a grid of (row tiles, Hkv, B), so the chunk
// fills the SMs. Each tile streams only the key range its rows can see:
// below min(ctx, last row's position + 1), and from the first row's window
// start (a page no row of the tile can see is never read).
#include <type_traits>

#include "attention_core.cuh"

namespace {

constexpr int ROWS = rt::TC_ROWS;   // query rows per block
constexpr int THREADS = rt::TC_THREADS;

template <typename T>
struct PrefillRows {   // rows [r0, r0 + ROWS) of (sequence b, KV head h)
  const T* q;          // [B, Sq, Hq, D]
  T* o;
  int b, h, G, Sq, Hq, D, r0, q0;
  __device__ bool live(int r) const { return r0 + r < Sq * G; }
  __device__ size_t off(int r) const {
    const int rg = r0 + r, s = rg / G, g = rg % G;
    return (((size_t)b * Sq + s) * Hq + h * G + g) * D;
  }
  __device__ const T* q_row(int r) const { return live(r) ? q + off(r) : nullptr; }
  __device__ T* out(int r) const { return live(r) ? o + off(r) : nullptr; }
  __device__ int qpos(int r) const { return q0 + (r0 + r) / G; }
};

template <typename T>
__global__ void paged_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k_pool,
                                     const T* __restrict__ v_pool,
                                     const int* __restrict__ page_table,
                                     const int* __restrict__ q_start,
                                     const int* __restrict__ ctx_lens,
                                     T* __restrict__ out, int Sq, int Hq,
                                     int Hkv, int D, int page, int N,
                                     int window, float scale) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int r0 = tile * ROWS;
  const int last = min(Sq * G, r0 + ROWS) - 1;
  const int q0 = q_start[b];
  const int q_first = q0 + r0 / G, q_last = q0 + last / G;
  const int kv_hi = min(min(ctx_lens[b], N * page), q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q_first - window + 1) / page * page;
  PrefillRows<T> rows{q, out, b, h, G, Sq, Hq, D, r0, q0};
  rt::PagedKeys<T> keys{k_pool, v_pool, page_table + (size_t)b * N,
                        page, Hkv, D, h};
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    rt::attend_rows_tc(rows, keys, D, kv_lo, kv_hi, /*causal=*/true, window,
                       scale);
  else
    rt::attend_rows<T>(rows, keys, ROWS, D, kv_lo, kv_hi, /*causal=*/true,
                       window, scale);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_table, const int* q_start, const int* ctx,
                   void* out, int B, int Sq, int Hq, int Hkv, int D, int page,
                   int N, int window, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int G = Hq / Hkv;
  const size_t smem = std::is_same<T, __nv_bfloat16>::value
                           ? rt::TcLayout(D).bytes
                           : rt::smem_floats(ROWS, D) * sizeof(float);
  cudaError_t e = rt::allow_smem(paged_prefill_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return e;
  const int tiles = (Sq * G + ROWS - 1) / ROWS;
  paged_prefill_kernel<T><<<dim3(tiles, Hkv, B), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, page_table, q_start,
      ctx, (T*)out, Sq, Hq, Hkv, D, page, N, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rt_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* q_start, const void* ctx, void* out,
    int B, int Sq, int Hq, int Hkv, int D, int page, int N, int window,
    int dtype, void* stream) {
  auto s = (cudaStream_t)stream;
  auto pt = (const int*)page_table;
  auto qs = (const int*)q_start;
  auto cl = (const int*)ctx;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, pt, qs, cl, out, B, Sq, Hq, Hkv,
                         D, page, N, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, pt, qs, cl, out, B, Sq,
                                 Hq, Hkv, D, page, N, window, s);
  return (int)cudaErrorInvalidValue;
}
