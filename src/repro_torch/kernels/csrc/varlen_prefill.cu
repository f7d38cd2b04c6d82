// Packed varlen prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/varlen_prefill.py:varlen_prefill.
// Prompt chunks of many requests share one token-packed buffer: chunk c owns
// rows [cu[c], cu[c+1]) (page-aligned spans), its first chunk_lens[c] rows
// are real tokens, and it starts at the absolute, page-aligned position
// chunk_pos0[c].  Each real row attends its request's committed context
// pages [0, pos0) from the pool plus the causal prefix of its own chunk in
// the packed K/V; pad rows (chunk tails, buffer tail) come out exactly zero
// and no row ever sees another request's tokens.
//
// This source holds the CUDA-core kernel: float32 (the tensor cores have no
// full-precision float32 product, and the float32 checks hold the card's
// tokens equal to the CPU's), and bf16 at a head dim the tensor-core routine
// (varlen_prefill_tc.cuh, at multiples of 16 up to 256) is not built for;
// kernels/varlen_prefill.py plan chooses.  Bound on this card: operations for
// long prompts (a block of ps query rows does 4 * ps * d flops per key row it
// reads), bytes for short ones; this kernel does the products on the CUDA
// cores in fp32, well above the tensor-core bound.
// Design: one 256-thread block per (query block of page_size rows, query
// head).  The block finds its chunk by scanning cu_seqlens (C is the slot
// count), then walks exactly the chunk's ceil(pos0/ps) context pages (capped
// by pages_bound) and its own packed blocks up to the diagonal, not a
// padded stage count.  A block made only of pad rows writes zeros and
// stops.  The fp32 online softmax is the common.cuh tile with an explicit
// p mask, so fully masked rows keep l = 0.  With an int8/fp8 pool only the
// committed context pages are codes, dequantized at load with their rows'
// f32 scales; the chunk's own K/V come full-precision from the packed
// buffer, as in the TPU kernel.
#include "common.cuh"

namespace {

template <typename T, typename KV>
__global__ void __launch_bounds__(rt::kThreads)
varlen_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const KV* __restrict__ k_pages,
                      const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
                      const float* __restrict__ v_scales, const int32_t* __restrict__ cu,
                      const int32_t* __restrict__ chunk_lens,
                      const int32_t* __restrict__ chunk_pos0,
                      const int32_t* __restrict__ page_tables, T* __restrict__ out, int C,
                      int h, int kvh, int d, int ps, int max_pages, int ctx_bound,
                      int window, float scale, float softcap) {
  extern __shared__ float smem[];
  const int qj = blockIdx.x, head = blockIdx.y, g = head / (h / kvh);
  // the owning chunk: the last one whose span starts at or before this block
  // (empty chunks share their start with the next; the buffer tail maps to
  // the last chunk and is masked by its length)
  int c = 0;
  for (int i = 0; i < C; ++i)
    if (cu[i] / ps <= qj) c = i;
  const int seq_len = chunk_lens[c], pos0 = chunk_pos0[c], sblk = cu[c] / ps;
  const int off_q0 = (qj - sblk) * ps;  // chunk-local offset of row 0
  auto q_row = [&](int r) -> int64_t { return ((int64_t)(qj * ps + r) * h + head) * d; };
  if (off_q0 >= seq_len) {  // only pad rows: exact zeros
    for (int i = threadIdx.x; i < ps * d; i += blockDim.x)
      out[q_row(i / d) + i % d] = rt::from_f32<T>(0.f);
    return;
  }
  const rt::Tile t = rt::carve_tile(smem, ps, ps, d);
  rt::tile_load_q(t, q, q_row);
  rt::tile_reset(t);
  auto in_window = [&](int r, int k_pos) {
    return window <= 0 || (pos0 + off_q0 + r) - k_pos < window;
  };
  const int64_t row_stride = (int64_t)kvh * d;
  // committed context: pages [0, pos0/ps) of the owning request
  const int n_ctx = rt::imin((pos0 + ps - 1) / ps, ctx_bound);
  for (int s = 0; s < n_ctx; ++s) {
    const int64_t page = page_tables[(int64_t)c * max_pages + s];
    auto key_ok = [&](int j) { return s * ps + j < pos0; };
    auto offset = [&](int j) -> int64_t { return (page * ps + j) * row_stride + (int64_t)g * d; };
    __syncthreads();
    rt::tile_load_kv(t, k_pages, v_pages, k_scales, v_scales, offset, key_ok);
    __syncthreads();
    rt::tile_step(t, scale, softcap, [&](int r, int j) {
      return off_q0 + r < seq_len && key_ok(j) && in_window(r, s * ps + j);
    });
  }
  // the chunk's own tokens: packed blocks sblk .. qj (causal)
  for (int tb = 0; tb <= qj - sblk; ++tb) {
    auto key_ok = [&](int j) { return tb * ps + j < seq_len; };
    auto offset = [&](int j) -> int64_t {
      return ((int64_t)(sblk + tb) * ps + j) * row_stride + (int64_t)g * d;
    };
    __syncthreads();
    rt::tile_load_kv(t, k, v, nullptr, nullptr, offset, key_ok);
    __syncthreads();
    rt::tile_step(t, scale, softcap, [&](int r, int j) {
      const int off_k = tb * ps + j;
      return off_q0 + r < seq_len && key_ok(j) && off_q0 + r >= off_k &&
             in_window(r, pos0 + off_k);
    });
  }
  __syncthreads();
  rt::tile_store(t, out, q_row);
}

}  // namespace

// q, out: (T, h, d); k, v: (T, kvh, d); pools: (num_pages, ps, kvh, d);
// cu: (C+1,), chunk_lens, chunk_pos0: (C,), page_tables: (C, max_pages), all
// int32.  T is a multiple of ps.  All contiguous; q, k, v and out of one
// dtype, the pools of that dtype (kv_store 0, scales null) or int8/fp8
// codes (kv_store 1/2) with float32 k_scales, v_scales (num_pages, ps, kvh).
// ctx_bound caps context pages per chunk; window <= 0 means none.
extern "C" int rt_varlen_prefill(const void* q, const void* k, const void* v,
                                 const void* k_pages, const void* v_pages,
                                 const void* k_scales, const void* v_scales, const void* cu,
                                 const void* chunk_lens, const void* chunk_pos0,
                                 const void* page_tables, void* out, int T, int C, int h,
                                 int kvh, int d, int ps, int max_pages, int ctx_bound,
                                 int window, float scale, float softcap, int dtype,
                                 int kv_store, void* stream) {
  if (T <= 0 || C <= 0 || ps <= 0 || T % ps || kvh <= 0 || h % kvh || d <= 0 ||
      max_pages <= 0 || h > 65535 || !rt::kv_args_ok(kv_store, k_scales, v_scales))
    return (int)cudaErrorInvalidValue;
  const size_t smem = rt::tile_floats(ps, ps, d) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T_, RT_DISPATCH_KV(kv_store, T_, KV, {
    cudaError_t e = rt::allow_smem(varlen_prefill_kernel<T_, KV>, smem);
    if (e != cudaSuccess) return (int)e;
    varlen_prefill_kernel<T_, KV><<<dim3(T / ps, h), rt::kThreads, smem, st>>>(
        (const T_*)q, (const T_*)k, (const T_*)v, (const KV*)k_pages, (const KV*)v_pages,
        (const float*)k_scales, (const float*)v_scales, (const int32_t*)cu,
        (const int32_t*)chunk_lens, (const int32_t*)chunk_pos0, (const int32_t*)page_tables,
        (T_*)out, C, h, kvh, d, ps, max_pages, ctx_bound, window, scale, softcap);
  }));
  return (int)cudaGetLastError();
}
