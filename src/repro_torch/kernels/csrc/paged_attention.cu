// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:paged_attention
// for float32 queries; bf16 runs the split-KV tensor-core routine of
// decode_split.cuh (the wrapper's plan: a dispatch by dtype).
// One new query token per request attends its live positions [0, len) (or
// [len - window, len)) in a global page pool (num_pages, page_size, kvh, d)
// through a per-request page table; page j of a request covers the logical
// positions [j*ps, (j+1)*ps) whatever physical page holds it.
//
// Bound on this card: bytes (2 * rep * d multiply-adds per K/V row read).
// Design: the exact float32 CUDA-core tile of common.cuh, which the
// reduced float32 card-vs-CPU token checks rest on (the tensor cores have
// no full-precision float32 product).  One block per (request, kv head)
// holds the whole GQA group, so each page is read from HBM once and not
// once per query head, and walks exactly ceil(len/ps) pages (capped by
// pages_bound), not the padded table width, with an fp32 online softmax.
// Idle rows whose table points at the scratch page read it like any page;
// their output is never used.  An int8/fp8 pool (KV = int8_t or
// __nv_fp8_e4m3) is dequantized at load with its row's f32 scale.
#include "common.cuh"

namespace {

template <typename KV>
__global__ void __launch_bounds__(rt::kThreads)
paged_attention_kernel(const float* __restrict__ q, const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int32_t* __restrict__ table,
                       const int32_t* __restrict__ lengths, float* __restrict__ out, int h,
                       int kvh, int d, int ps, int table_stride, int max_pages, int window,
                       float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y, rep = h / kvh;
  const rt::Tile t = rt::carve_tile(smem, rep, ps, d);
  // query rows: heads g*rep .. g*rep + rep - 1 of request b
  auto q_row = [&](int r) -> int64_t { return ((int64_t)b * h + g * rep + r) * d; };
  rt::tile_load_q(t, q, q_row);
  rt::tile_reset(t);
  const int len = lengths[b];
  const int n_pages = rt::imin((len + ps - 1) / ps, max_pages);
  const int first = window > 0 ? rt::imax(len - window, 0) / ps : 0;
  const int64_t row_stride = (int64_t)kvh * d;
  for (int pj = first; pj < n_pages; ++pj) {
    const int64_t page = table[(int64_t)b * table_stride + pj];
    auto key_ok = [&](int j) {
      const int pos = pj * ps + j;
      return pos < len && (window <= 0 || pos >= len - window);
    };
    auto offset = [&](int j) -> int64_t { return (page * ps + j) * row_stride + (int64_t)g * d; };
    __syncthreads();  // the previous step's readers are done with K/V
    rt::tile_load_kv(t, k_pages, v_pages, k_scales, v_scales, offset, key_ok);
    __syncthreads();
    rt::tile_step(t, scale, softcap, [&](int, int j) { return key_ok(j); });
  }
  __syncthreads();
  rt::tile_store(t, out, q_row);
}

}  // namespace

// q, out: (b, 1, h, d); k_pages, v_pages: (num_pages, ps, kvh, d); table:
// (b, table_stride) int32, of which the first max_pages columns are read;
// lengths: (b,) int32.  All contiguous; q and out float32, the pools
// float32 (kv_store 0, scales null) or int8/fp8 codes (kv_store 1/2) with
// float32 k_scales, v_scales (num_pages, ps, kvh).  window <= 0 means
// none.
extern "C" int rt_paged_attention_f32(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* table, const void* lengths, void* out, int b,
                                      int h, int kvh, int d, int ps, int table_stride, int max_pages,
                                      int window, float scale, float softcap, int kv_store,
                                      void* stream) {
  if (b <= 0 || kvh <= 0 || h % kvh || d <= 0 || ps <= 0 || max_pages <= 0 ||
      max_pages > table_stride || kvh > 65535 || !rt::kv_args_ok(kv_store, k_scales, v_scales))
    return (int)cudaErrorInvalidValue;
  const size_t smem = rt::tile_floats(h / kvh, ps, d) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  using T = float;
  RT_DISPATCH_KV(kv_store, T, KV, {
    cudaError_t e = rt::allow_smem(paged_attention_kernel<KV>, smem);
    if (e != cudaSuccess) return (int)e;
    paged_attention_kernel<KV><<<dim3(b, kvh), rt::kThreads, smem, st>>>(
        (const float*)q, (const KV*)k_pages, (const KV*)v_pages, (const float*)k_scales,
        (const float*)v_scales, (const int32_t*)table, (const int32_t*)lengths, (float*)out, h,
        kvh, d, ps, table_stride, max_pages, window, scale, softcap);
  });
  return (int)cudaGetLastError();
}
