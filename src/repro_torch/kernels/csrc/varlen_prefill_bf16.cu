// The varlen prefill tensor-core routine (varlen_prefill_tc.cuh) over a bf16 pool
// (kv_store 0, scales null): the bf16 varlen_prefill of the port.  Its own source so that its head-dim
// instances compile beside the others'.
#include "varlen_prefill_tc.cuh"

// q, out: (T, h, d) bf16; k, v: (T, kvh, d) bf16; pools: (num_pages, ps,
// kvh, d); cu: (C+1,), chunk_lens, chunk_pos0: (C,), page_tables: (C,
// max_pages), all int32; scratch: (2 * T / ps,) int32.  T is a multiple of
// ps.  All contiguous, q, k, v and the pools 16-byte aligned.  ctx_bound
// caps context pages per chunk; window <= 0 means none.  block_k, tile_rows
// and stages as kernels/varlen_prefill.py plan gives them.  Two launches:
// the block order, then the attention.
extern "C" int rt_varlen_prefill_bf16(const void* q, const void* k, const void* v,
                                       const void* k_pages, const void* v_pages,
                                       const void* k_scales, const void* v_scales,
                                       const void* cu, const void* chunk_lens,
                                       const void* chunk_pos0, const void* page_tables,
                                       void* scratch, void* out, int T, int C, int h, int kvh,
                                       int d, int ps, int max_pages, int ctx_bound, int window,
                                       int block_k, int tile_rows, int stages, int kv_store,
                                       float scale, float softcap, void* stream) {
  return rt::varlen::entry<false>(q, k, v, k_pages, v_pages, k_scales, v_scales, cu, chunk_lens,
                               chunk_pos0, page_tables, scratch, out, T, C, h, kvh, d, ps,
                               max_pages, ctx_bound, window, block_k, tile_rows, stages,
                               kv_store, scale, softcap, stream);
}
