// Mamba-2 SSD backward for Hopper (sm_90a): the gradients of the chunked
// scan (csrc/ssd_tc.cu, csrc/ssd.cu) in four launches, on CUDA cores with
// float32 sums: float32, and bf16 at the widths and chunks the forward
// runs on csrc/ssd.cu (kernels/ssd_bwd.py plan); bf16 at the tensor-core
// widths runs csrc/ssd_bwd_tc.cu.
//
// Replaces no Pallas kernel: the JAX package takes this gradient by
// autodiff of its chunked scan, repro/kernels/ops.py:ssd_chunked_jnp (the
// backend its train driver runs), and the TPU kernel
// repro/kernels/ssd_scan.py:ssd has no backward.  Notation per chunk c of Q
// timesteps (the trailing chunk its L live rows): cum the inclusive cumsum
// of dt A over live rows, S_c the state entering chunk c, W_c the cotangent
// of the state leaving it, E_tk = exp(cum_t - cum_k) for k <= t (exp only
// of exponents <= 0, as the forward), ew_k = exp(cum_last - cum_k).
//
// 1. ssd_bwd_kernel_chunk_states, one block per (row, chunk, head): cum (to
//    an f32 workspace of dt's shape), the forward's chunk state
//    dS_c = sum_k ew_k dt_k x_k B_k^T and G_c = sum_t exp(cum_t) dy_t C_t^T,
//    each p x n, to two f32 workspaces (b, nc, h, p, n).  The backward
//    rebuilds the forward's entry states instead of keeping the forward's
//    workspaces: the autograd forward saves its inputs only.
// 2. ssd_bwd_kernel_state_pass, one thread per state element: forwards
//    S_c over dS_c (S = exp(cum_last) S + dS_c from the initial state),
//    backwards W_c over G_c (W = G_c + exp(cum_last) W from the final
//    state's cotangent), and the initial state's cotangent.  Element-wise.
// 3. ssd_bwd_kernel_chunk_grads, one block per (row, chunk, head), x, dy, B,
//    C, W_c and then S_c staged in shared memory (float32):
//      P_tk = (C_t . B_k) E_tk,  R_tk = (dy_t . x_k) E_tk dt_k,
//      dx_k   = dt_k (sum_t P_tk dy_t + ew_k W B_k)          (written, x's dtype)
//      dB_k  += sum_t R_tk C_t + dt_k ew_k W^T x_k          (per head, f32)
//      dC_t  += sum_k R_tk B_k + exp(cum_t) S_c^T dy_t      (per head, f32)
//      ddt_k  = sum_t P_tk (dy_t . x_k) + ew_k x_k^T W B_k + A da_k
//    with da the reverse cumsum of dcum: +M_tk to t and -M_tk to k for
//    M = P (dy . x) dt_k, exp(cum_t) <dy_t, S_c C_t> to t, -ew_k dt_k
//    x_k^T W B_k to k, and exp(cum_last) <W, S_c> + sum_k ew_k dt_k
//    x_k^T W B_k to the last live row; dA's part sum_k dt_k da_k per
//    (row, chunk, head).
// 4. ssd_bwd_kernel_reduce_bc and ssd_bwd_kernel_reduce_a: dB and dC summed
//    over heads, dA over (row, chunk), each in a fixed order.
// No atomics: two calls give the same bits.  ref.ssd_bwd_chunks is this
// decomposition in plain torch; ref.ssd_bwd the sequential recurrence.
//
// Bound on this card: bytes.  At mamba2-130m's training shape (8 rows of
// 1024, 24 heads, p 64, n 128, chunk 64) the backward must read x, dy, B,
// C, dt and write dx, dB, dC, ddt, ~94 MB (0.028 ms at 3.35 TB/s), for
// ~21 GFLOP (0.021 ms at 989 TFLOP/s).  This design does ~2x that work
// (the chunk states rebuilt, C.B^T per head) on CUDA cores and moves
// ~0.8 GB through its f32 workspaces; csrc/ssd_bwd_tc.cu does the bf16
// route's products on the tensor cores and reads the forward's states.
#include "common.cuh"

namespace {

constexpr int kWarps = rt::kThreads / 32;
constexpr int kGradVecs = 8;  // per-timestep vectors of launch 3

// floats of dynamic shared memory of launches 1 and 3 (kernels/ssd_bwd.py
// smem_bytes mirrors these): rows padded by one float, so that a warp
// reading one column of a tile hits 32 different banks
__host__ __device__ inline size_t states_floats(int Q, int p, int n) {
  return 2 * (size_t)Q * (p + 1) + 2 * (size_t)Q * (n + 1) + 3 * (size_t)Q;
}
__host__ __device__ inline size_t grads_floats(int Q, int p, int n) {
  return 3 * (size_t)Q * (p + 1) + 2 * (size_t)Q * (n + 1) + (size_t)p * (n + 1) +
         3 * (size_t)Q * (Q + 1) + kGradVecs * (size_t)Q + kWarps;
}

// Rows [t0, t0 + L) of a (.., width) operand, element stride st between
// timesteps and width contiguous, into an L x (width + 1) float tile.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int64_t st, int L,
                                      int width) {
  for (int i = threadIdx.x; i < L * width; i += rt::kThreads) {
    const int k = i / width, m = i % width;
    dst[k * (width + 1) + m] = rt::to_f32(src[k * st + m]);
  }
}

// Row sums of an L x (width + 1) tile into out[0..L): a warp per row.
__device__ __forceinline__ void row_sums(const float* tile, int L, int width, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < L; k += kWarps) {
    float acc = 0.f;
    for (int m = lane; m < width; m += 32) acc += tile[k * (width + 1) + m];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[k] = acc;
  }
}

// ---------------------------------------------------------------------------
// 1. cum, the forward's chunk states and the chunk gradients G_c
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_chunk_states(const T* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ A, const T* __restrict__ B,
                            const T* __restrict__ C, const T* __restrict__ dy,
                            float* __restrict__ cum_ws, float* __restrict__ states,
                            float* __restrict__ grads, int s, int h, int p, int n, int Q, int nc,
                            int64_t x_sb, int64_t x_st, int64_t b_sb, int64_t b_st,
                            int64_t c_sb, int64_t c_st) {
  extern __shared__ float smem[];
  const int row = blockIdx.x / nc, c = blockIdx.x % nc, hd = blockIdx.y;
  const int t0 = c * Q, L = rt::imin(Q, s - t0);
  const int ps = p + 1, ns = n + 1;
  float* xs = smem;          // L x (p+1)
  float* ys = xs + Q * ps;   // L x (p+1): dy
  float* Bs = ys + Q * ps;   // L x (n+1)
  float* Cs = Bs + Q * ns;   // L x (n+1)
  float* cum = Cs + Q * ns;  // Q
  float* wk = cum + Q;       // Q: dt_k, then ew_k dt_k
  float* eq = wk + Q;        // Q: exp(cum_t)
  stage(xs, x + row * x_sb + t0 * x_st + (int64_t)hd * p, x_st, L, p);
  stage(ys, dy + ((int64_t)row * s + t0) * h * p + (int64_t)hd * p, (int64_t)h * p, L, p);
  stage(Bs, B + row * b_sb + t0 * b_st, b_st, L, n);
  stage(Cs, C + row * c_sb + t0 * c_st, c_st, L, n);
  const int64_t at0 = ((int64_t)row * s + t0) * h + hd;  // (row, t0, hd) in dt's layout
  for (int k = threadIdx.x; k < L; k += rt::kThreads) wk[k] = dt[at0 + (int64_t)k * h];
  __syncthreads();
  if (threadIdx.x == 0) {
    const float a = A[hd];
    float run = 0.f;
    for (int k = 0; k < L; ++k) {
      run += wk[k] * a;
      cum[k] = run;
    }
  }
  __syncthreads();
  const float last = cum[L - 1];
  for (int k = threadIdx.x; k < L; k += rt::kThreads) {
    cum_ws[at0 + (int64_t)k * h] = cum[k];
    wk[k] *= expf(last - cum[k]);
    eq[k] = expf(cum[k]);
  }
  __syncthreads();
  const int64_t base = (((int64_t)row * nc + c) * h + hd) * p * n;
  for (int i = threadIdx.x; i < p * n; i += rt::kThreads) {
    const int m = i / n, j = i % n;
    float acc_s = 0.f, acc_g = 0.f;
    for (int k = 0; k < L; ++k) {
      acc_s += wk[k] * xs[k * ps + m] * Bs[k * ns + j];
      acc_g += eq[k] * ys[k * ps + m] * Cs[k * ns + j];
    }
    states[base + i] = acc_s;
    grads[base + i] = acc_g;
  }
}

// ---------------------------------------------------------------------------
// 2. the state pass: entry states forwards, W_c backwards
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_state_pass(const float* __restrict__ cum_ws, const float* __restrict__ s0,
                          const float* __restrict__ dfin, float* states, float* grads,
                          float* __restrict__ dinit, int s, int h, int pn, int Q, int nc) {
  const int e = blockIdx.x * rt::kThreads + threadIdx.x;
  const int hd = blockIdx.y, row = blockIdx.z;
  if (e >= pn) return;
  const int64_t hrow = (int64_t)row * h + hd;
  const float* cr = cum_ws + (int64_t)row * s * h + hd;  // cum at timestep t: cr[t * h]
  const int64_t cs = (int64_t)h * pn;                     // chunk stride of the workspaces
  float* st = states + ((int64_t)row * nc * h + hd) * pn + e;
  float* gr = grads + ((int64_t)row * nc * h + hd) * pn + e;
  float S = s0 != nullptr ? s0[hrow * pn + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const float d = st[c * cs];
    st[c * cs] = S;
    S = expf(cr[(int64_t)(rt::imin(s, (c + 1) * Q) - 1) * h]) * S + d;
  }
  float W = dfin != nullptr ? dfin[hrow * pn + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float g = gr[c * cs];
    gr[c * cs] = W;
    W = g + expf(cr[(int64_t)(rt::imin(s, (c + 1) * Q) - 1) * h]) * W;
  }
  if (dinit != nullptr) dinit[hrow * pn + e] = W;
}

// ---------------------------------------------------------------------------
// 3. the chunk gradients
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_chunk_grads(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const T* __restrict__ B,
                           const T* __restrict__ C, const T* __restrict__ dy,
                           const float* __restrict__ cum_ws, const float* __restrict__ states,
                           const float* __restrict__ grads, T* __restrict__ dx,
                           float* __restrict__ ddt, float* __restrict__ dB_part,
                           float* __restrict__ dC_part, float* __restrict__ dA_part, int s,
                           int h, int p, int n, int Q, int nc, int64_t x_sb, int64_t x_st,
                           int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  extern __shared__ float smem[];
  const int row = blockIdx.x / nc, c = blockIdx.x % nc, hd = blockIdx.y;
  const int t0 = c * Q, L = rt::imin(Q, s - t0);
  const int ps = p + 1, ns = n + 1, qs = Q + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xs = smem;           // L x (p+1)
  float* ys = xs + Q * ps;    // L x (p+1): dy
  float* tp = ys + Q * ps;    // L x (p+1): x o (W B), then dy o (S C)
  float* Bs = tp + Q * ps;    // L x (n+1)
  float* Cs = Bs + Q * ns;    // L x (n+1)
  float* sw = Cs + Q * ns;    // p x (n+1): W_c, then S_c
  float* P = sw + p * ns;     // L x (Q+1), [t][k]
  float* R = P + Q * qs;      // L x (Q+1)
  float* PD = R + Q * qs;     // L x (Q+1): P (dy . x)
  float* cum = PD + Q * qs;   // Q each:
  float* dts = cum + Q;
  float* ecum = dts + Q;      // exp(cum_t)
  float* ew = ecum + Q;       // exp(cum_last - cum_k)
  float* xwb = ew + Q;        // x_k . W B_k
  float* dysc = xwb + Q;      // dy_t . S C_t
  float* dcum = dysc + Q;     // dcum, then da
  float* dd = dcum + Q;       // ddt's direct part
  float* red = dd + Q;        // kWarps partial sums of <W, S_c>

  stage(xs, x + row * x_sb + t0 * x_st + (int64_t)hd * p, x_st, L, p);
  stage(ys, dy + ((int64_t)row * s + t0) * h * p + (int64_t)hd * p, (int64_t)h * p, L, p);
  stage(Bs, B + row * b_sb + t0 * b_st, b_st, L, n);
  stage(Cs, C + row * c_sb + t0 * c_st, c_st, L, n);
  const int64_t base = (((int64_t)row * nc + c) * h + hd) * p * n;
  for (int i = threadIdx.x; i < p * n; i += rt::kThreads) sw[(i / n) * ns + i % n] = grads[base + i];
  const int64_t at0 = ((int64_t)row * s + t0) * h + hd;
  for (int k = threadIdx.x; k < L; k += rt::kThreads) {
    cum[k] = cum_ws[at0 + (int64_t)k * h];
    dts[k] = dt[at0 + (int64_t)k * h];
  }
  __syncthreads();
  const float last = cum[L - 1];
  for (int k = threadIdx.x; k < L; k += rt::kThreads) {
    ecum[k] = expf(cum[k]);
    ew[k] = expf(last - cum[k]);
  }
  // P, R and P (dy . x) over the causal pairs, zero above the diagonal
  for (int i = threadIdx.x; i < L * L; i += rt::kThreads) {
    const int t = i / L, k = i % L;
    float pv = 0.f, rv = 0.f, pd = 0.f;
    if (k <= t) {
      const float* ct = Cs + t * ns;
      const float* bk = Bs + k * ns;
      float cb = 0.f;
      for (int j = 0; j < n; ++j) cb += ct[j] * bk[j];
      const float* yt = ys + t * ps;
      const float* xk = xs + k * ps;
      float dxv = 0.f;
      for (int m = 0; m < p; ++m) dxv += yt[m] * xk[m];
      const float e = expf(cum[t] - cum[k]);
      pv = cb * e;
      rv = dxv * e * dts[k];
      pd = pv * dxv;
    }
    P[t * qs + k] = pv;
    R[t * qs + k] = rv;
    PD[t * qs + k] = pd;
  }
  __syncthreads();

  // the W terms: dx (written), x o W B, and dB's part
  T* dxr = dx + ((int64_t)row * s + t0) * h * p + (int64_t)hd * p;
  for (int i = threadIdx.x; i < L * p; i += rt::kThreads) {
    const int k = i / p, m = i % p;
    float acc = 0.f;
    for (int t = k; t < L; ++t) acc += P[t * qs + k] * ys[t * ps + m];
    const float* wm = sw + m * ns;
    const float* bk = Bs + k * ns;
    float wb = 0.f;
    for (int j = 0; j < n; ++j) wb += wm[j] * bk[j];
    dxr[(int64_t)k * h * p + m] = rt::from_f32<T>(dts[k] * (acc + ew[k] * wb));
    tp[k * ps + m] = xs[k * ps + m] * wb;
  }
  float* dbr = dB_part + at0 * n;  // (row, t0, hd) in the (b, s, h, n) partials
  for (int i = threadIdx.x; i < L * n; i += rt::kThreads) {
    const int k = i / n, j = i % n;
    float acc = 0.f;
    for (int t = k; t < L; ++t) acc += R[t * qs + k] * Cs[t * ns + j];
    const float* xk = xs + k * ps;
    float wx = 0.f;
    for (int m = 0; m < p; ++m) wx += sw[m * ns + j] * xk[m];
    dbr[(int64_t)k * h * n + j] = acc + dts[k] * ew[k] * wx;
  }
  __syncthreads();  // every reader of W is done

  // W_c -> S_c in place, summing <W, S_c>; x_k . W B_k
  float ws = 0.f;
  for (int i = threadIdx.x; i < p * n; i += rt::kThreads) {
    float* at = sw + (i / n) * ns + i % n;
    const float sv = states[base + i];
    ws += *at * sv;
    *at = sv;
  }
  for (int off = 16; off > 0; off >>= 1) ws += __shfl_xor_sync(0xffffffffu, ws, off);
  if (lane == 0) red[warp] = ws;
  row_sums(tp, L, p, xwb);
  __syncthreads();

  // the S_c terms: dC's part, dy o S C
  float* dcr = dC_part + at0 * n;
  for (int i = threadIdx.x; i < L * n; i += rt::kThreads) {
    const int t = i / n, j = i % n;
    float acc = 0.f;
    for (int k = 0; k <= t; ++k) acc += R[t * qs + k] * Bs[k * ns + j];
    const float* yt = ys + t * ps;
    float sdy = 0.f;
    for (int m = 0; m < p; ++m) sdy += sw[m * ns + j] * yt[m];
    dcr[(int64_t)t * h * n + j] = acc + ecum[t] * sdy;
  }
  for (int i = threadIdx.x; i < L * p; i += rt::kThreads) {
    const int t = i / p, m = i % p;
    const float* sm = sw + m * ns;
    const float* ct = Cs + t * ns;
    float sc = 0.f;
    for (int j = 0; j < n; ++j) sc += sm[j] * ct[j];
    tp[t * ps + m] = ys[t * ps + m] * sc;
  }
  __syncthreads();
  row_sums(tp, L, p, dysc);
  __syncthreads();

  // per timestep: ddt's direct part and dcum
  for (int t = threadIdx.x; t < L; t += rt::kThreads) {
    float col = 0.f, rowdt = 0.f;
    for (int u = t; u < L; ++u) col += PD[u * qs + t];
    for (int k = 0; k <= t; ++k) rowdt += PD[t * qs + k] * dts[k];
    dd[t] = col + ew[t] * xwb[t];
    dcum[t] = rowdt - dts[t] * col + ecum[t] * dysc[t] - ew[t] * dts[t] * xwb[t];
  }
  __syncthreads();
  const float a = A[hd];
  if (threadIdx.x == 0) {
    float wsum = 0.f, tail = 0.f;
    for (int i = 0; i < kWarps; ++i) wsum += red[i];
    for (int k = 0; k < L; ++k) tail += ew[k] * dts[k] * xwb[k];
    dcum[L - 1] += ecum[L - 1] * wsum + tail;
    float run = 0.f, da_sum = 0.f;
    for (int k = L - 1; k >= 0; --k) {  // da: the reverse cumsum of dcum
      run += dcum[k];
      dcum[k] = run;
      da_sum += dts[k] * run;
    }
    dA_part[((int64_t)row * nc + c) * h + hd] = da_sum;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < L; k += rt::kThreads) ddt[at0 + (int64_t)k * h] = dd[k] + a * dcum[k];
}

// ---------------------------------------------------------------------------
// 4. the sums over heads and over (row, chunk), in a fixed order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_reduce_bc(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                         T* __restrict__ dB, T* __restrict__ dC, int64_t total, int h, int n) {
  const int64_t i = (int64_t)blockIdx.x * rt::kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t rs = i / n;  // (row, t)
  const int j = (int)(i % n);
  const float* pb = dB_part + rs * h * n + j;
  const float* pc = dC_part + rs * h * n + j;
  float sb = 0.f, sc = 0.f;
  for (int hd = 0; hd < h; ++hd) {
    sb += pb[(int64_t)hd * n];
    sc += pc[(int64_t)hd * n];
  }
  dB[i] = rt::from_f32<T>(sb);
  dC[i] = rt::from_f32<T>(sc);
}

__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_reduce_a(const float* __restrict__ dA_part, float* __restrict__ dA, int parts,
                        int h) {
  const int hd = blockIdx.x * rt::kThreads + threadIdx.x;
  if (hd >= h) return;
  float acc = 0.f;
  for (int r = 0; r < parts; ++r) acc += dA_part[(int64_t)r * h + hd];
  dA[hd] = acc;
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* B, const T* C, const float* s0,
           const T* dy, const float* dfin, T* dx, float* ddt, float* dA, T* dB, T* dC,
           float* dinit, float* cum, float* states, float* grads, float* dB_part, float* dC_part,
           float* dA_part, int b, int s, int h, int p, int n, int chunk, long long x_sb,
           long long x_st, long long b_sb, long long b_st, long long c_sb, long long c_st,
           cudaStream_t st) {
  const int Q = rt::imin(chunk, s);
  const int nc = (s + Q - 1) / Q;
  const size_t sm1 = states_floats(Q, p, n) * sizeof(float);
  const size_t sm3 = grads_floats(Q, p, n) * sizeof(float);
  cudaError_t e = rt::allow_smem(ssd_bwd_kernel_chunk_states<T>, sm1);
  if (e != cudaSuccess) return (int)e;
  e = rt::allow_smem(ssd_bwd_kernel_chunk_grads<T>, sm3);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel_chunk_states<T><<<dim3(b * nc, h), rt::kThreads, sm1, st>>>(
      x, dt, A, B, C, dy, cum, states, grads, s, h, p, n, Q, nc, x_sb, x_st, b_sb, b_st, c_sb,
      c_st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int pn = p * n;
  ssd_bwd_kernel_state_pass<<<dim3((pn + rt::kThreads - 1) / rt::kThreads, h, b), rt::kThreads, 0,
                              st>>>(cum, s0, dfin, states, grads, dinit, s, h, pn, Q, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_kernel_chunk_grads<T><<<dim3(b * nc, h), rt::kThreads, sm3, st>>>(
      x, dt, A, B, C, dy, cum, states, grads, dx, ddt, dB_part, dC_part, dA_part, s, h, p, n, Q,
      nc, x_sb, x_st, b_sb, b_st, c_sb, c_st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)b * s * n;
  ssd_bwd_kernel_reduce_bc<T><<<(unsigned)((total + rt::kThreads - 1) / rt::kThreads),
                                rt::kThreads, 0, st>>>(dB_part, dC_part, dB, dC, total, h, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_kernel_reduce_a<<<(h + rt::kThreads - 1) / rt::kThreads, rt::kThreads, 0, st>>>(
      dA_part, dA, b * nc, h);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, s, h, p) with (h, p) contiguous inside a timestep, element strides
// x_sb between rows and x_st between timesteps; B, C: (b, s, n) with n
// contiguous, strides b_sb/b_st and c_sb/c_st; dt: (b, s, h) float32
// contiguous; A: (h,) float32; s0: (b, h, p, n) float32 contiguous initial
// state or null (zeros); dy: (b, s, h, p) contiguous, x's dtype; dfin: (b, h,
// p, n) float32 contiguous cotangent of the final state or null (zeros).
// Out, contiguous: dx (b, s, h, p) and dB, dC (b, s, n) in x's dtype; ddt
// (b, s, h), dA (h,) and dinit (b, h, p, n; null: not written) float32.
// Workspaces, float32 contiguous, nc = ceil(s / min(chunk, s)): cum (b, s,
// h), states and grads (b, nc, h, p, n), dB_part and dC_part (b, s, h, n),
// dA_part (b, nc, h).
extern "C" int rt_ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
                          const void* C, const void* s0, const void* dy, const void* dfin,
                          void* dx, void* ddt, void* dA, void* dB, void* dC, void* dinit,
                          void* cum, void* states, void* grads, void* dB_part, void* dC_part,
                          void* dA_part, int b, int s, int h, int p, int n, int chunk,
                          long long x_sb, long long x_st, long long b_sb, long long b_st,
                          long long c_sb, long long c_st, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T, {
    return launch<T>((const T*)x, (const float*)dt, (const float*)A, (const T*)B, (const T*)C,
                     (const float*)s0, (const T*)dy, (const float*)dfin, (T*)dx, (float*)ddt,
                     (float*)dA, (T*)dB, (T*)dC, (float*)dinit, (float*)cum, (float*)states,
                     (float*)grads, (float*)dB_part, (float*)dC_part, (float*)dA_part, b, s, h,
                     p, n, chunk, x_sb, x_st, b_sb, b_st, c_sb, c_st, st);
  });
  return (int)cudaErrorInvalidValue;
}
