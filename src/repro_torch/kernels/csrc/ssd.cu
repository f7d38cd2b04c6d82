// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd.  For one sequence
// row and one head the recurrence S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,
// y_t = S_t C_t (state S of p x n, float32) is computed chunk by chunk, as
// the SSD decomposition does it: per chunk of Q timesteps with inclusive
// cumulative log decays cum_q = sum_{j<=q} dt_j A,
//   y_q  = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k   (intra)
//        + exp(cum_q) C_q S                                     (inter)
//   S'   = exp(cum_last) S + sum_k exp(cum_last - cum_k) dt_k x_k B_k^T,
// all accumulated in float32, from an optional initial state, with the
// final state written out (the prefill -> decode hand-off).
//
// Bound on this card: bytes.  At the static serve pass (8 rows of 881
// tokens, 24 heads, p 64, n 128, chunk 64) the scan reads x, B, C, dt and
// writes y and the state, ~49 MB, for ~6.3 GFLOP: ~130 operations per
// byte, under the H100's ~295 in bf16.
// Design: the TPU grid (row, chunk) kept the whole (h, p, n) state of a row
// in VMEM; at full width that is 786 KB, far over the 227 KB of shared
// memory a block can have.  The math is pointwise in (head, p) except for
// C . B^T, which every head shares and each block recomputes.  So one
// 256-thread block per (head, row) carries its (p, n) float32 state slice
// (32 KB) in shared memory through a sequential loop over the chunks (the
// TPU's sequential grid axis), staging each chunk's x (Q, p), dt, B and C
// (Q, n) in float32 (~130 KB at full width, the opt-in of allow_smem).
// Rows are padded to n+1 floats so that a warp reading one column of B or
// of S hits 32 different banks.  The ragged end is handled by construction:
// the last chunk's loops run over its live length only, so no row past s is
// read or written (the Pallas kernel reads a padded block there and, with
// dt zeroed but x, B, C not, gives NaN in interpret mode).  exp is taken
// only where k <= q, where cum_q - cum_k <= 0 (A < 0, dt > 0): nothing
// overflows.  The products run on CUDA cores in float32; wgmma tiles for
// C.B^T and the state products, and a parallel scan over chunks, are later
// work.  Grid (h, b): 192 blocks at the static pass, 24 for a batch-1
// admission.
#include "common.cuh"

namespace {

// floats of shared memory one block uses: S p x (n+1), x Q x p, B and C
// Q x (n+1), the Q x Q intra-chunk matrix, dt, cum, exp(cum) and the state
// weights (Q each).  kernels/ssd.py:smem_bytes mirrors this.
__host__ __device__ inline size_t ssd_smem_floats(int p, int n, int Q) {
  return (size_t)p * (n + 1) + (size_t)Q * p + 2 * (size_t)Q * (n + 1) + (size_t)Q * Q +
         4 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ s0,
           T* __restrict__ y, T* __restrict__ sf, int s, int h, int p, int n, int Q,
           int64_t x_sb, int64_t x_st, int64_t b_sb, int64_t b_st, int64_t c_sb,
           int64_t c_st) {
  extern __shared__ float smem[];
  const int hd = blockIdx.x, row = blockIdx.y;
  const int np = n + 1;
  float* S = smem;              // p x (n+1) carried state
  float* xs = S + p * np;       // Q x p
  float* Bs = xs + Q * p;       // Q x (n+1)
  float* Cs = Bs + Q * np;      // Q x (n+1)
  float* G = Cs + Q * np;       // Q x Q: (C_q . B_k) exp(cum_q - cum_k) dt_k, k <= q
  float* dts = G + Q * Q;       // Q
  float* cum = dts + Q;         // Q inclusive cumulative dt * A
  float* eq = cum + Q;          // Q exp(cum_q)
  float* wk = eq + Q;           // Q exp(cum_last - cum_k) dt_k
  const float a = A[hd];
  const int64_t st_off = ((int64_t)row * h + hd) * p * n;
  for (int i = threadIdx.x; i < p * n; i += blockDim.x)
    S[(i / n) * np + i % n] = s0 != nullptr ? s0[st_off + i] : 0.f;
  const T* xr = x + row * x_sb + (int64_t)hd * p;
  const T* br = B + row * b_sb;
  const T* cr = C + row * c_sb;
  const float* dtr = dt + (int64_t)row * s * h + hd;
  T* yr = y + (int64_t)row * s * h * p + (int64_t)hd * p;
  for (int t0 = 0; t0 < s; t0 += Q) {
    const int L = rt::imin(Q, s - t0);  // live timesteps of this chunk
    __syncthreads();  // the previous chunk's readers are done with the staging
    for (int i = threadIdx.x; i < L * p; i += blockDim.x) {
      const int q = i / p, c = i % p;
      xs[i] = rt::to_f32(xr[(int64_t)(t0 + q) * x_st + c]);
    }
    for (int i = threadIdx.x; i < L * n; i += blockDim.x) {
      const int q = i / n, c = i % n;
      Bs[q * np + c] = rt::to_f32(br[(int64_t)(t0 + q) * b_st + c]);
      Cs[q * np + c] = rt::to_f32(cr[(int64_t)(t0 + q) * c_st + c]);
    }
    for (int q = threadIdx.x; q < L; q += blockDim.x) dts[q] = dtr[(int64_t)(t0 + q) * h];
    __syncthreads();
    if (threadIdx.x == 0) {
      float run = 0.f;
      for (int q = 0; q < L; ++q) {
        run += dts[q] * a;
        cum[q] = run;
      }
    }
    __syncthreads();
    const float last = cum[L - 1];
    for (int q = threadIdx.x; q < L; q += blockDim.x) {
      eq[q] = expf(cum[q]);
      wk[q] = expf(last - cum[q]) * dts[q];
    }
    // intra-chunk matrix, causal entries only
    for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
      const int q = i / L, k = i % L;
      float g = 0.f;
      if (k <= q) {
        const float* cq = Cs + q * np;
        const float* bk = Bs + k * np;
        float dot = 0.f;
        for (int c = 0; c < n; ++c) dot += cq[c] * bk[c];
        g = dot * expf(cum[q] - cum[k]) * dts[k];
      }
      G[q * Q + k] = g;
    }
    __syncthreads();
    // y = intra + inter, from the state carried into this chunk
    for (int i = threadIdx.x; i < L * p; i += blockDim.x) {
      const int q = i / p, c = i % p;
      const float* gq = G + q * Q;
      float intra = 0.f;
      for (int k = 0; k <= q; ++k) intra += gq[k] * xs[k * p + c];
      const float* cq = Cs + q * np;
      const float* sc = S + c * np;
      float inter = 0.f;
      for (int j = 0; j < n; ++j) inter += cq[j] * sc[j];
      yr[(int64_t)(t0 + q) * h * p + c] = rt::from_f32<T>(intra + inter * eq[q]);
    }
    __syncthreads();  // every reader of the old state is done
    const float decay = expf(last);
    for (int i = threadIdx.x; i < p * n; i += blockDim.x) {
      const int c = i / n, j = i % n;
      float acc = 0.f;
      for (int k = 0; k < L; ++k) acc += wk[k] * xs[k * p + c] * Bs[k * np + j];
      S[c * np + j] = decay * S[c * np + j] + acc;
    }
  }
  if (sf != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < p * n; i += blockDim.x)
      sf[st_off + i] = rt::from_f32<T>(S[(i / n) * np + i % n]);
  }
}

}  // namespace

// x: (b, s, h, p) with (h, p) contiguous inside a timestep, element strides
// x_sb between rows and x_st between timesteps; B, C: (b, s, n) with n
// contiguous, strides b_sb/b_st and c_sb/c_st (slices of one projection
// need no copy); dt: (b, s, h) float32 contiguous; A: (h,) float32;
// s0: (b, h, p, n) float32 contiguous initial state or null (zeros).
// y: (b, s, h, p) contiguous; sf: (b, h, p, n) contiguous final state or
// null.  x, B, C, y and sf share one dtype.  chunk: timesteps per chunk.
extern "C" int rt_ssd(const void* x, const void* dt, const void* A, const void* B,
                      const void* C, const void* s0, void* y, void* sf, int b, int s, int h,
                      int p, int n, int chunk, long long x_sb, long long x_st, long long b_sb,
                      long long b_st, long long c_sb, long long c_st, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int Q = rt::imin(chunk, s);
  const size_t smem = ssd_smem_floats(p, n, Q) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T, {
    cudaError_t e = rt::allow_smem(ssd_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    ssd_kernel<T><<<dim3(h, b), rt::kThreads, smem, st>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)B, (const T*)C,
        (const float*)s0, (T*)y, (T*)sf, s, h, p, n, Q, (int64_t)x_sb, (int64_t)x_st,
        (int64_t)b_sb, (int64_t)b_st, (int64_t)c_sb, (int64_t)c_st);
  });
  return (int)cudaGetLastError();
}
