// Forward flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention.
// q (b, sq, h, d) attends k, v (b, sk, kvh, d); query head h reads kv head
// h / (h/kvh).  Query row i sits at absolute position q_offset + i; key j
// is live for it when j < sk, (causal) q_pos >= j and (window > 0)
// q_pos - j < window.  A row with no live key comes out exactly zero.
//
// Bound on this card: operations.  A block of R query rows does 4 * R * d
// flops per key row it reads; at the prefill shapes of the dense engines
// (sq 1024, 16 query heads per kv head) that is far above the H100's ~295
// operations per byte.  This first kernel does the products on the CUDA
// cores in fp32 (the common.cuh tile), so it sits well above the
// tensor-core bound; a wgmma/TMA version is later work.
// Design: one 256-thread block per (batch row, tile of bq query positions,
// kv head) that holds the whole GQA group, R = bq * rep rows, so each K/V
// block is read once per kv head and not once per query head.  Row r is
// query position q0 + r / rep of head g * rep + r % rep.  The TPU kernel's
// grid visits every kv block in order and carries the softmax state in
// scratch; here the block loops over exactly the kv blocks that can hold a
// live key for one of its rows: none past the causal diagonal of its last
// row, none before the window start of its first row.  For a row with a
// live key a skipped block would only add exp(NEG_INF - m) = 0.  Keys past
// the last live one are zeroed at load, so nothing beyond sk is read.
// Query rows past sq (the ragged last tile) load row sq - 1 and are never
// stored.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq, int sk, int h,
                       int kvh, int d, int bq, int bk, int causal, int window, int q_offset,
                       float scale, float softcap) {
  extern __shared__ float smem[];
  const int rep = h / kvh, n_qt = (sq + bq - 1) / bq;
  const int b = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * bq, g = blockIdx.y;
  const int R = bq * rep;
  const rt::Tile t = rt::carve_tile(smem, R, bk, d);
  auto q_idx = [&](int r) { return q0 + r / rep; };
  auto q_row = [&](int r) -> int64_t {
    return (((int64_t)b * sq + rt::imin(q_idx(r), sq - 1)) * h + g * rep + r % rep) * d;
  };
  rt::tile_load_q(t, q, q_row);
  rt::tile_reset(t);
  // live keys of this block's rows: [lo, hi)
  const int pos_first = q_offset + q0;
  const int pos_last = q_offset + rt::imin(q0 + bq, sq) - 1;
  const int hi = causal ? rt::imin(sk, pos_last + 1) : sk;
  const int lo = window > 0 ? rt::imax(pos_first - window + 1, 0) : 0;
  const int64_t row_stride = (int64_t)kvh * d;
  const int64_t base = (int64_t)b * sk * row_stride + (int64_t)g * d;
  for (int kb = lo / bk; kb * bk < hi; ++kb) {
    auto key_ok = [&](int j) { return kb * bk + j < hi; };
    auto offset = [&](int j) -> int64_t { return base + (int64_t)(kb * bk + j) * row_stride; };
    __syncthreads();  // the previous step's readers are done with K/V
    rt::tile_load_kv(t, k, v, nullptr, nullptr, offset, key_ok);
    __syncthreads();
    rt::tile_step(t, scale, softcap, [&](int r, int j) {
      const int k_pos = kb * bk + j;
      const int q_pos = q_offset + q_idx(r);
      return k_pos < hi && (!causal || q_pos >= k_pos) &&
             (window <= 0 || q_pos - k_pos < window);
    });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    if (q_idx(r) < sq) out[q_row(r) + c] = rt::from_f32<T>(t.acc[i] / fmaxf(t.l[r], rt::kMinL));
  }
}

}  // namespace

// q, out: (b, sq, h, d); k, v: (b, sk, kvh, d); all contiguous and of one
// dtype.  bq query positions per block (bq * h/kvh tile rows), bk keys per
// step; causal 0/1; window <= 0 means none.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                                  int sq, int sk, int h, int kvh, int d, int bq, int bk,
                                  int causal, int window, int q_offset, float scale,
                                  float softcap, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh || d <= 0 || bq <= 0 || bk <= 0 ||
      kvh > 65535 || (int64_t)b * ((sq + bq - 1) / bq) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int rows = bq * (h / kvh);
  const size_t smem = rt::tile_floats(rows, bk, d) * sizeof(float);
  const unsigned n_blocks = (unsigned)(b * ((sq + bq - 1) / bq));
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T, {
    cudaError_t e = rt::allow_smem(flash_attention_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    flash_attention_kernel<T><<<dim3(n_blocks, kvh), rt::kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, h, kvh, d, bq, bk, causal,
        window, q_offset, scale, softcap);
  });
  return (int)cudaGetLastError();
}
