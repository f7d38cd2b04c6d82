// The split-KV decode routine (decode_split.cuh) over an int8/fp8 pool of
// 1-byte codes (kv_store 1/2) with float32 k_scales, v_scales (num_pages,
// ps, kvh): the bf16 paged_attention and spec_verify of the port on a
// quantized pool.  Its own source so that its head-dim instances compile
// beside the others'.
#include "decode_split.cuh"

// q, out: (b, W, h, d) bf16; k_pages, v_pages: (num_pages, ps, kvh, d);
// table: (b, table_stride) int32, of which the first max_pages columns are
// read, or null for the identity table (row i holds pages i * table_stride
// + j: a dense cache viewed as a pool); lengths: (b,) int32; window_lens: (b,) int32, or null for the
// one-token instance (query at len - 1).  part_m, part_l: (b, kvh,
// n_splits, W * h/kvh) float32 scratch, part_acc the same times d, with
// n_splits = ceil(min(max_pages * ps, key_cap) / split_keys).  All
// contiguous, 16-byte aligned.  window <= 0 means none.  Two launches.
extern "C" int rt_decode_split_quant(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* table, const void* lengths,
                                      const void* window_lens, void* part_m, void* part_l,
                                      void* part_acc, void* out, int b, int W, int h, int kvh,
                                      int d, int ps, int table_stride, int max_pages,
                                      int key_cap, int window, int split_keys, int block_k,
                                      int tile_rows, int stages, int kv_store, float scale,
                                      float softcap, void* stream) {
  return rt::split::entry<true>(q, k_pages, v_pages, k_scales, v_scales, table, lengths,
                              window_lens, part_m, part_l, part_acc, out, b, W, h, kvh, d, ps,
                              table_stride, max_pages, key_cap, window, split_keys, block_k,
                              tile_rows, stages, kv_store, scale, softcap, stream);
}
