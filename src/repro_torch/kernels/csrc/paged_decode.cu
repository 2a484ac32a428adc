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
// ~295 flops per byte, so the kernel is memory bound.
//
// What the design does about it: one block per (sequence, KV head) holds
// all G query heads of the group, so every K/V page is read from device
// memory once per group and not once per query head; the block loads its
// own page-table row and walks only the live pages [first_live,
// ceil(ctx/page)), skipping pages before the window. It does NOT yet fill
// the card at small batch: the grid is B * Hkv blocks (64 at B = 8 for
// llama3-8b, on 132 SMs). Splitting the context over blocks (flash-decoding)
// is the first thing a later change does here.
//
// ctx = 0 returns 0 for the row, as the Pallas kernel does.
#include "attention_core.cuh"

namespace {

template <typename T>
struct DecodeRows {   // the G query heads of KV head h, sequence b
  const T* q;         // [B, Hq, D]
  T* o;
  int b, h, G, Hq, D, pos;
  __device__ size_t off(int r) const { return ((size_t)b * Hq + h * G + r) * D; }
  __device__ const T* q_row(int r) const { return q + off(r); }
  __device__ T* out(int r) const { return o + off(r); }
  __device__ int qpos(int) const { return pos; }
};

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ ctx_lens,
                                    T* __restrict__ out, int Hq, int Hkv,
                                    int D, int page, int N, int window,
                                    float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int ctx = ctx_lens[b];
  const int qpos = ctx - 1;
  const int kv_hi = min(ctx, N * page);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, qpos - window + 1) / page * page;
  DecodeRows<T> rows{q, out, b, h, G, Hq, D, qpos};
  rt::PagedKeys<T> keys{k_pool, v_pool, page_table + (size_t)b * N,
                        page, Hkv, D, h};
  rt::attend_rows<T>(rows, keys, G, D, kv_lo, kv_hi, /*causal=*/true, window,
                     scale);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_table, const int* ctx, void* out, int B,
                   int Hq, int Hkv, int D, int page, int N, int window,
                   cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int G = Hq / Hkv;
  const size_t smem = rt::smem_floats(G, D) * sizeof(float);
  cudaError_t e = rt::allow_smem(paged_decode_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return e;
  paged_decode_kernel<T><<<dim3(Hkv, B), 128, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, page_table, ctx,
      (T*)out, Hq, Hkv, D, page, N, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* ctx, void* out, int B, int Hq,
    int Hkv, int D, int page, int N, int window, int dtype, void* stream) {
  auto s = (cudaStream_t)stream;
  auto pt = (const int*)page_table;
  auto cl = (const int*)ctx;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, pt, cl, out, B, Hq, Hkv, D, page,
                         N, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, pt, cl, out, B, Hq, Hkv,
                                 D, page, N, window, s);
  return (int)cudaErrorInvalidValue;
}
