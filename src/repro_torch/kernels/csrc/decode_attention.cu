// Dense-cache decode attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:decode_attention
// for float32 queries; bf16 runs the split-KV tensor-core routine of
// decode_split.cuh over the cache viewed as a pool of 16-key pages
// (kernels/decode_attention.py: a dispatch by dtype).
// One new query token per batch row attends its row of a dense cache
// (b, S, kvh, d): keys [0, len) (or [len - window, len)), at most the first
// kv_bound of them and never past S.  K/V rows outside that range are
// zeroed at load, never read; a row with length 0 visits no key and comes
// out exactly zero.
//
// Bound on this card: bytes (2 * rep * d multiply-adds per K/V row read).
// Design: paged_attention.cu's float32 tile over a dense row instead of
// pages: one block per (batch row, kv head) holding the whole GQA group,
// stepping through exactly the live keys in blocks of bk with the fp32
// online softmax of the common.cuh tile.  With bk equal to a page size the
// arithmetic, and so the output, is paged_attention's bit for bit on the
// same keys.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rt::kThreads)
decode_attention_kernel(const float* __restrict__ q, const float* __restrict__ k_cache,
                        const float* __restrict__ v_cache, const int32_t* __restrict__ lengths,
                        float* __restrict__ out, int S, int h, int kvh, int d, int bk,
                        int kv_bound, int window, float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y, rep = h / kvh;
  const rt::Tile t = rt::carve_tile(smem, rep, bk, d);
  // query rows: heads g*rep .. g*rep + rep - 1 of batch row b
  auto q_row = [&](int r) -> int64_t { return ((int64_t)b * h + g * rep + r) * d; };
  rt::tile_load_q(t, q, q_row);
  rt::tile_reset(t);
  const int len = lengths[b];
  const int hi = rt::imin(rt::imin(len, S), kv_bound);
  const int lo = window > 0 ? rt::imax(len - window, 0) : 0;
  const int64_t row_stride = (int64_t)kvh * d;
  const int64_t base = (int64_t)b * S * row_stride + (int64_t)g * d;
  for (int kb = lo / bk; kb * bk < hi; ++kb) {
    auto key_ok = [&](int j) {
      const int pos = kb * bk + j;
      return pos < hi && pos >= lo;
    };
    auto offset = [&](int j) -> int64_t { return base + (int64_t)(kb * bk + j) * row_stride; };
    __syncthreads();  // the previous step's readers are done with K/V
    rt::tile_load_kv(t, k_cache, v_cache, nullptr, nullptr, offset, key_ok);
    __syncthreads();
    rt::tile_step(t, scale, softcap, [&](int, int j) { return key_ok(j); });
  }
  __syncthreads();
  rt::tile_store(t, out, q_row);
}

}  // namespace

// q, out: (b, 1, h, d); k_cache, v_cache: (b, S, kvh, d); lengths: (b,)
// int32.  All contiguous float32.  bk keys per step; kv_bound caps the
// keys visited per row; window <= 0 means none.
extern "C" int rt_decode_attention_f32(const void* q, const void* k_cache, const void* v_cache,
                                       const void* lengths, void* out, int b, int S, int h,
                                       int kvh, int d, int bk, int kv_bound, int window,
                                       float scale, float softcap, void* stream) {
  if (b <= 0 || S <= 0 || kvh <= 0 || h % kvh || d <= 0 || bk <= 0 || kv_bound <= 0 ||
      kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = rt::tile_floats(h / kvh, bk, d) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = rt::allow_smem(decode_attention_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  decode_attention_kernel<<<dim3(b, kvh), rt::kThreads, smem, st>>>(
      (const float*)q, (const float*)k_cache, (const float*)v_cache, (const int32_t*)lengths,
      (float*)out, S, h, kvh, d, bk, kv_bound, window, scale, softcap);
  return (int)cudaGetLastError();
}
