// Speculative-decoding verification attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel repro/kernels/spec_verify.py:spec_verify for
// float32 queries; bf16 runs the split-KV tensor-core routine of
// decode_split.cuh (the wrapper's plan: a dispatch by dtype).  Each
// decoding slot b holds a window of window_lens[b] in-flight tokens (the
// pending next token and its drafts) whose K/V the caller has already
// written into the request's pages at positions [len, len + window_lens[b]);
// window starts are not page-aligned.  Query w sits at absolute position
// len + w and attends every position <= len + w (and inside the sliding
// window, if any) through the page table.  Rows w >= window_lens[b] (window
// pad, idle slots) come out exactly zero.
//
// Bound on this card: bytes (2 * rep * W * d multiply-adds per K/V row).
// Design: the exact float32 CUDA-core tile of common.cuh, which the reduced
// float32 card-vs-CPU token checks rest on.  The rep * W rows of a kv head
// (row r = w * rep + i: window position w, query head g * rep + i) are cut
// into chunks of `rows` that fit the tile (the wrapper's plan), one block
// per (slot, kv head, row chunk), so no window the zoo reaches exceeds the
// card's shared memory.  A block walks exactly ceil((len + window_lens[b])
// / ps) pages (capped by pages_bound), none for an idle slot, with a
// row-dependent causal mask on absolute positions.  An int8/fp8 pool is
// dequantized at load with its rows' f32 scales.  Row w sees the same
// pages, keys and summation order as a one-token paged_attention call at
// length len + w + 1 (later pages only add masked steps with alpha = 1),
// whatever chunk holds it, so verification is bit-identical to decoding.
#include "common.cuh"

namespace {

template <typename KV>
__global__ void __launch_bounds__(rt::kThreads)
spec_verify_kernel(const float* __restrict__ q, const KV* __restrict__ k_pages,
                   const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales, const int32_t* __restrict__ table,
                   const int32_t* __restrict__ lengths, const int32_t* __restrict__ window_lens,
                   float* __restrict__ out, int W, int h, int kvh, int d, int ps,
                   int table_stride, int max_pages, int window, float scale, float softcap,
                   int rows) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y, rep = h / kvh;
  const int row0 = blockIdx.z * rows, n_rows = rt::imin(rows, rep * W - row0);
  const rt::Tile t = rt::carve_tile(smem, n_rows, ps, d);
  // tile row r: row row0 + r = w * rep + i of the kv head, window position
  // w, query head g * rep + i
  auto q_row = [&](int r) -> int64_t {
    const int x = row0 + r;
    return (((int64_t)b * W + x / rep) * h + g * rep + x % rep) * d;
  };
  rt::tile_load_q(t, q, q_row);
  rt::tile_reset(t);
  const int len = lengths[b], wl = window_lens[b];
  const int total = wl > 0 ? len + wl : 0;  // positions any row may read
  const int n_pages = rt::imin((total + ps - 1) / ps, max_pages);
  // the earliest key in the window of the earliest query (position len)
  const int first = window > 0 ? rt::imax(len + 1 - window, 0) / ps : 0;
  const int64_t row_stride = (int64_t)kvh * d;
  for (int pj = first; pj < n_pages; ++pj) {
    const int64_t page = table[(int64_t)b * table_stride + pj];
    auto key_ok = [&](int j) {
      const int pos = pj * ps + j;
      return pos < total && (window <= 0 || pos > len - window);
    };
    auto offset = [&](int j) -> int64_t { return (page * ps + j) * row_stride + (int64_t)g * d; };
    __syncthreads();  // the previous step's readers are done with K/V
    rt::tile_load_kv(t, k_pages, v_pages, k_scales, v_scales, offset, key_ok);
    __syncthreads();
    rt::tile_step(t, scale, softcap, [&](int r, int j) {
      const int w = (row0 + r) / rep, k_pos = pj * ps + j, q_pos = len + w;
      return w < wl && k_pos <= q_pos && (window <= 0 || q_pos - k_pos < window);
    });
  }
  __syncthreads();
  rt::tile_store(t, out, q_row);
}

}  // namespace

// q, out: (b, W, h, d); k_pages, v_pages: (num_pages, ps, kvh, d); table:
// (b, table_stride) int32, of which the first max_pages columns are read;
// lengths (committed tokens before the window), window_lens: (b,) int32.
// All contiguous; q and out float32, the pools float32 (kv_store 0,
// scales null) or int8/fp8 codes (kv_store 1/2) with float32 k_scales,
// v_scales (num_pages, ps, kvh).  window <= 0 means none.  rows: tile rows
// per block (kernels/spec_verify.py's plan), the rep * W rows of a kv head
// in ceil(rep * W / rows) chunks.
extern "C" int rt_spec_verify_f32(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales, const void* table,
                                  const void* lengths, const void* window_lens, void* out,
                                  int b, int W, int h, int kvh, int d, int ps, int table_stride,
                                  int max_pages, int window, float scale, float softcap,
                                  int rows, int kv_store, void* stream) {
  if (b <= 0 || W <= 0 || kvh <= 0 || h % kvh || d <= 0 || ps <= 0 || max_pages <= 0 ||
      max_pages > table_stride || kvh > 65535 || rows <= 0 ||
      !rt::kv_args_ok(kv_store, k_scales, v_scales))
    return (int)cudaErrorInvalidValue;
  const int chunks = ((h / kvh) * W + rows - 1) / rows;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = rt::tile_floats(rt::imin(rows, (h / kvh) * W), ps, d) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  using T = float;
  RT_DISPATCH_KV(kv_store, T, KV, {
    cudaError_t e = rt::allow_smem(spec_verify_kernel<KV>, smem);
    if (e != cudaSuccess) return (int)e;
    spec_verify_kernel<KV><<<dim3(b, kvh, chunks), rt::kThreads, smem, st>>>(
        (const float*)q, (const KV*)k_pages, (const KV*)v_pages, (const float*)k_scales,
        (const float*)v_scales, (const int32_t*)table, (const int32_t*)lengths,
        (const int32_t*)window_lens, (float*)out, W, h, kvh, d, ps, table_stride, max_pages,
        window, scale, softcap, rows);
  });
  return (int)cudaGetLastError();
}
