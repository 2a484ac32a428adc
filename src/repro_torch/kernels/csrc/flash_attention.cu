// Forward flash attention (GQA, causal or bidirectional, optional sliding
// window), for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention/kernel.py. Query i and key j sit at
// positions i and j; a key is seen when j < seq_k, j <= i when causal, and
// i - j < window when a window is set.
//
// What bounds it on the card: the operations. A causal prefill of S tokens
// does ~2 * S^2 * D flops per query head on O(S * D) bytes, hundreds of flops
// per byte at S = 2048, above the H100's ~295 flops per byte: the tensor
// cores are the way to its peak. bf16 inputs run Q K^T and P V there
// through WMMA (mma.sync; wgmma and TMA are a later change); f32 inputs run
// on the CUDA cores.
//
// What the design does about it: a grid of (query tiles, Hq, B); each block
// loops over key tiles only up to its causal diagonal and from its window
// start, so a causal prefill costs ~S^2 / 2 and a windowed one ~S * window.
// The Pallas wrapper pads Sq and Sk to block multiples; here the ragged edge
// is masked in the kernel (rows past Sq are not written, keys past seq_k are
// not read), which computes the same result without the padded copies.
#include <type_traits>

#include "attention_core.cuh"

namespace {

constexpr int ROWS = rt::TC_ROWS;   // query positions per block
constexpr int THREADS = rt::TC_THREADS;

template <typename T>
struct FlashRows {   // query positions [r0, r0 + ROWS) of head hq, batch b
  const T* q;        // [B, Sq, Hq, D]
  T* o;
  int b, hq, Sq, Hq, D, r0;
  __device__ bool live(int r) const { return r0 + r < Sq; }
  __device__ size_t off(int r) const {
    return (((size_t)b * Sq + r0 + r) * Hq + hq) * D;
  }
  __device__ const T* q_row(int r) const { return live(r) ? q + off(r) : nullptr; }
  __device__ T* out(int r) const { return live(r) ? o + off(r) : nullptr; }
  __device__ int qpos(int r) const { return r0 + r; }
};

template <typename T>
struct DenseKeys {   // k/v [B, Sk, Hkv, D], KV head h of batch b
  const T* k_;
  const T* v_;
  int b, h, Sk, Hkv, D;
  __device__ size_t off(int kpos) const {
    return (((size_t)b * Sk + kpos) * Hkv + h) * D;
  }
  __device__ const T* k(int kpos) const { return k_ + off(kpos); }
  __device__ const T* v(int kpos) const { return v_ + off(kpos); }
};

template <typename T>
__global__ void flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int Sq, int Sk, int Hq, int Hkv, int D,
                             int causal, int window, float scale) {
  const int tile = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int r0 = tile * ROWS;
  const int q_last = min(Sq, r0 + ROWS) - 1;
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, r0 - window + 1) / rt::KT * rt::KT;
  FlashRows<T> rows{q, out, b, hq, Sq, Hq, D, r0};
  DenseKeys<T> keys{k, v, b, hq / G, Sk, Hkv, D};
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    rt::attend_rows_tc(rows, keys, D, kv_lo, kv_hi, causal != 0, window,
                       scale);
  else
    rt::attend_rows<T>(rows, keys, ROWS, D, kv_lo, kv_hi, causal != 0,
                       window, scale);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                   int window, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const size_t smem = std::is_same<T, __nv_bfloat16>::value
                           ? rt::TcLayout(D).bytes
                           : rt::smem_floats(ROWS, D) * sizeof(float);
  cudaError_t e = rt::allow_smem(flash_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return e;
  const int tiles = (Sq + ROWS - 1) / ROWS;
  flash_kernel<T><<<dim3(tiles, Hq, B), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, Hq, Hkv, D,
      causal, window, 1.0f / sqrtf((float)D));
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
    return launch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                                 window, s);
  return (int)cudaErrorInvalidValue;
}
