// Mamba-2 SSD backward for Hopper (sm_90a), bf16, on the tensor cores: the
// gradients of the chunked scan (csrc/ssd_tc.cu) in five launches, every
// product on mma.sync m16n8k16 with float32 sums.
//
// Replaces no Pallas kernel: the JAX package takes this gradient by
// autodiff of its chunked scan, repro/kernels/ops.py:ssd_chunked_jnp, and
// the TPU kernel repro/kernels/ssd_scan.py:ssd has no backward.  Taken for
// bf16 x, B, C at p % 16 == 0, n % 16 == 0 and chunks of Q in {16, 32, 64}
// (kernels/ssd_bwd.py plan: where the forward runs ssd_tc.cu); float32, and
// bf16 at other widths or chunks, keep csrc/ssd_bwd.cu.  The decomposition
// and notation are ssd_bwd.cu's (ref.ssd_bwd_chunks): per chunk c of Q
// timesteps (the trailing one its L live rows) cum is the inclusive cumsum
// of dt A, S_c the state entering chunk c, W_c the cotangent of the state
// leaving it, E_tk = exp(cum_t - cum_k) for k <= t, ew_k = exp(cum_last -
// cum_k), P = (C B^T) o E, R = (dy x^T) o E o dt_k.
//
// 1. ssd_bwd_kernel_tc_chunk_states, one block per (row, chunk, head
//    group): cum by the forward's warp scan (or the forward's own, kept),
//    G_c = (dy_c o exp(cum))^T C_c, (p x Q)(Q x n); only where the forward's
//    entry states are not kept, also its chunk states dS_c = (x_c o w)^T B_c.
// 2. ssd_bwd_kernel_tc_state_pass, blocks over (slice of p n, head, row),
//    kPassVec elements a thread in 16-byte vectors, each chunk's vector
//    loaded before the previous one is stored in place: W_c backwards over
//    G_c from the final state's cotangent (not kept: S_c forwards over dS_c
//    from the initial state first), and the initial state's cotangent.
// 3. ssd_bwd_kernel_tc_chunk_grads, one block per (row, chunk, head group):
//    B_c, C_c and, per head, x_c, dy_c staged as bf16 tiles, W_c and then
//    S_c as two bf16 terms each.  C_c B_c^T is computed once a block (as
//    CB^T = B_c C_c^T, each warp its 16 keys against the times after them)
//    and held in registers for the group's heads.  Per head, each warp on its
//    16 keys: DX^T = x dy^T, then P^T and R^T in registers, keys as rows.
//    The products that contract over t take them as A fragments: P^T is
//    formed again from CB^T where dx takes it (the two bf16 terms of each
//    time tile in turn, which keeps the launch within 128 registers), R^T
//    passes once through shared memory (two bf16 terms) and is read back
//    by ldmatrix both ways, as R^T for dB and transposed, as R, for dC.
//    Then
//      dx = dt o (ew o (B W^T) + P^T dy)              (written, bf16)
//      dB = (dt ew) o (x W) + R^T C                   (the group's sum, f32)
//      dC = exp(cum) o (dy S) + R B                   (the group's sum, f32)
//    with x_k . W B_k the row sum of B o (x W) and dy_t . S C_t that of
//    C o (dy S).  ddt's direct part, dcum, its reverse cumsum and dA's part
//    are float32 warp work, as in ssd_bwd.cu.  The heads of a block add their
//    dB and dC in head order into one float32 partial per head group.
// 4. ssd_bwd_kernel_tc_reduce_bc and ssd_bwd_kernel_tc_reduce_a: dB and dC
//    summed over head groups, dA over (row, chunk), each in a fixed order.
//
// Exactness: x, B, C and dy are bf16 and enter every product exactly; every
// float32 operand (dy o exp(cum), x o w, P, R, W_c, S_c) enters as two bf16
// terms (mma.cuh split_bf16), all sums float32.  No atomics and a fixed
// order: two calls give the same bits.  Rows past s are zero in shared
// memory and never written.
//
// Bound on this card: bytes.  At mamba2-130m's training shape (8 rows of
// 1024, 24 heads, p 64, n 128, chunk 64) the backward must read x, dy, B,
// C, dt and write dx, dB, dC, ddt, ~94 MB (0.028 ms at 3.35 TB/s), for
// ~21 GFLOP.  This design moves ~1.0 GB through its float32 workspaces
// (G_c written, read and rewritten as W_c, W_c read twice, the kept S_c
// read, the head-pair partials written, re-read by the second head and by
// the sum; 0.30 ms at 3.35 TB/s, part of it in L2) and does ~50 GFLOP on
// the tensor cores, the two bf16 terms included.
#include "common.cuh"
#include "mma.cuh"
#include "ssd_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace rt::ssd;
constexpr int kHeadGroup = 2;    // heads per block of launches 1 and 3
constexpr int kWarps = rt::kThreads / 32;
constexpr int kPassVec = 4;      // state elements a thread of launch 2 carries

// bytes of dynamic shared memory of launches 1 and 3 (kernels/ssd_bwd.py
// tc_smem_bytes mirrors these)
__host__ __device__ inline size_t state_smem(int Q, int p, int n) {
  return 2 * (2 * (size_t)Q * pad_row(n) + 2 * (size_t)Q * pad_row(p)) +
         4 * 2 * (size_t)kHeadGroup * Q;
}
__host__ __device__ inline size_t grads_smem(int Q, int p, int n) {
  return 2 * (2 * (size_t)Q * pad_row(n) + 2 * (size_t)Q * pad_row(p) +
              2 * (size_t)p * pad_row(n) + 2 * (size_t)Q * pad_row(Q)) +
         4 * (2 * (size_t)kHeadGroup * Q + 3 * (size_t)Q + (size_t)(Q / 16) * Q +
              2 * (size_t)(kWarps / (Q / 16)) * Q + kWarps);
}

// Rows [0, Q) of a bf16 operand (rows past L zero) times scale_k of row k,
// as the two bf16 terms of each float32 product, into two Q x pad_row(d)
// tiles [k][m].
template <int Q>
__device__ __forceinline__ void stage_scaled(bf16* hi, bf16* lo, const bf16* __restrict__ src,
                                             int64_t st, int L, int d, bool vec,
                                             const float* scale) {
  using namespace rt::mma;
  const int chunks = d / 8, stride = pad_row(d);
  for (int i = threadIdx.x; i < Q * chunks; i += rt::kThreads) {
    const int k = i / chunks, ch = i % chunks;
    float f[8];
    unpack8(k < L ? load8(src + k * st + ch * 8, vec) : make_uint4(0, 0, 0, 0), f);
    uint32_t big[4], small[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_bf16(f[2 * j] * scale[k], f[2 * j + 1] * scale[k], big[j], small[j]);
    *reinterpret_cast<uint4*>(hi + k * stride + ch * 8) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(lo + k * stride + ch * 8) =
        make_uint4(small[0], small[1], small[2], small[3]);
  }
}

// dst[m][j] (p x n float32, rows of n) = sum_k (hi + lo)[k][m] op[k][j] over
// the first L rows (16 at a time; rows past L are zero): a warp per 16 x 32
// output tile.
template <int Q>
__device__ __forceinline__ void product_t(float* __restrict__ dst, const bf16* hi, const bf16* lo,
                                          const bf16* op, int L, int p, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, quad = lane & 3;
  const int ps = pad_row(p), ns = pad_row(n);
  const int mt = p / 16, nt = (n + 31) / 32;
  for (int tile = warp; tile < mt * nt; tile += kWarps) {
    const int m0 = (tile / nt) * 16, col0 = (tile % nt) * 32;
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (16 * kk >= L) continue;
      uint32_t ab[4], as[4];
      load_a_t(ab, hi, ps, m0, 16 * kk);
      load_a_t(as, lo, ps, m0, 16 * kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int col16 = col0 + 16 * np;
        if (col16 >= n) continue;
        uint32_t f[4];
        load_b_t(f, op, ns, col16, 16 * kk);
        mma16(acc[2 * np], acc[2 * np + 1], ab, f);
        mma16(acc[2 * np], acc[2 * np + 1], as, f);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 8 * j + 2 * quad;
      if (col >= n) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(dst + (int64_t)(m0 + group + 8 * i) * n + col) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. cum, the chunk gradients G_c and (not kept) the forward's chunk states
// ---------------------------------------------------------------------------
template <int Q>
__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_tc_chunk_states(const bf16* __restrict__ x, const float* __restrict__ dt,
                               const float* __restrict__ A, const bf16* __restrict__ B,
                               const bf16* __restrict__ C, const bf16* __restrict__ dy,
                               float* cum, float* __restrict__ states,
                               float* __restrict__ grads, int kept, int s, int h, int p, int n,
                               int nc, int64_t x_sb, int64_t x_st, int64_t b_sb, int64_t b_st,
                               int64_t c_sb, int64_t c_st, bool vx, bool vb, bool vc, bool vy) {
  using namespace rt::mma;
  constexpr int E = (Q + 31) / 32;  // timesteps a lane scans
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x / nc, c = blockIdx.x % nc, h0 = blockIdx.y * kHeadGroup;
  const int nh = rt::imin(kHeadGroup, h - h0);
  const int t0 = c * Q, L = rt::imin(Q, s - t0);
  const int ns = pad_row(n), ps = pad_row(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* sC = reinterpret_cast<bf16*>(smem);  // Q x (n+8): C_c, [t][j]
  bf16* sB = sC + Q * ns;                   // Q x (n+8): B_c, [k][j] (not kept)
  bf16* sHi = sB + Q * ns;                  // Q x (p+8): big term of dy o exp(cum), then x o w
  bf16* sLo = sHi + Q * ps;                 // Q x (p+8): its small term
  float* sEc = reinterpret_cast<float*>(sLo + Q * ps);  // kHeadGroup x Q: exp(cum_t)
  float* sW = sEc + kHeadGroup * Q;                     // kHeadGroup x Q: w_k

  stage_rows<Q>(sC, C + row * c_sb + t0 * c_st, c_st, L, n, vc);
  if (!kept) stage_rows<Q>(sB, B + row * b_sb + t0 * b_st, b_st, L, n, vb);
  // cum of head h0 + warp: lane holds timesteps lane*E .. lane*E+E-1
  if (warp < nh) {
    const int hd = h0 + warp;
    const float a = A[hd];
    const float* dtr = dt + ((int64_t)row * s + t0) * h + hd;
    float* cr = cum + ((int64_t)row * s + t0) * h + hd;
    float d[E], cu[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane * E + e;
      d[e] = k < L ? dtr[(int64_t)k * h] : 0.f;
    }
    float last;
    if (kept) {  // the forward's cum
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = lane * E + e;
        cu[e] = k < L ? cr[(int64_t)k * h] : 0.f;
      }
      last = cr[(int64_t)(L - 1) * h];
    } else {  // the forward's scan, written for launches 2 and 3
#pragma unroll
      for (int e = 0; e < E; ++e) cu[e] = (e > 0 ? cu[e - 1] : 0.f) + d[e] * a;
      float incl = cu[E - 1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);  // sum over the lanes before
      if (lane == 0) excl = 0.f;
      float mine = 0.f;  // this lane's cum at timestep L - 1, if it holds it
#pragma unroll
      for (int e = 0; e < E; ++e) {
        cu[e] += excl;
        if (lane * E + e == L - 1) mine = cu[e];
      }
      last = __shfl_sync(0xffffffffu, mine, (L - 1) / E);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (lane * E + e < L) cr[(int64_t)(lane * E + e) * h] = cu[e];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane * E + e;
      if (k < Q) {
        sEc[warp * Q + k] = k < L ? expf(cu[e]) : 0.f;
        sW[warp * Q + k] = k < L ? expf(last - cu[e]) * d[e] : 0.f;
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int hh = 0; hh < nh; ++hh) {
    const int hd = h0 + hh;
    const int64_t base = (((int64_t)row * nc + c) * h + hd) * p * n;
    stage_scaled<Q>(sHi, sLo, dy + ((int64_t)row * s + t0) * h * p + (int64_t)hd * p,
                    (int64_t)h * p, L, p, vy, sEc + hh * Q);
    __syncthreads();
    product_t<Q>(grads + base, sHi, sLo, sC, L, p, n);
    __syncthreads();  // every reader of this head's dy o exp(cum) is done
    if (!kept) {
      stage_scaled<Q>(sHi, sLo, x + row * x_sb + t0 * x_st + (int64_t)hd * p, x_st, L, p, vx,
                      sW + hh * Q);
      __syncthreads();
      product_t<Q>(states + base, sHi, sLo, sB, L, p, n);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the state pass: (not kept) entry states forwards, W_c backwards
// ---------------------------------------------------------------------------
template <int Q>
__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_tc_state_pass(const float* __restrict__ cum, const float* __restrict__ s0,
                             const float* __restrict__ dfin, float* states, float* grads,
                             float* __restrict__ dinit, int kept, int s, int h, int pn, int nc) {
  const int e = (blockIdx.x * rt::kThreads + threadIdx.x) * kPassVec;
  const int hd = blockIdx.y, row = blockIdx.z;
  if (e >= pn) return;
  const int64_t hrow = (int64_t)row * h + hd;
  const int64_t cstride = (int64_t)h * pn;                  // chunk stride of the workspaces
  const int64_t first = ((int64_t)row * nc * h + hd) * pn + e;
  const float* cr = cum + (int64_t)row * s * h + hd;        // cum at timestep t: cr[t * h]
  const auto last = [&](int c) { return cr[(int64_t)(rt::imin(s, (c + 1) * Q) - 1) * h]; };
  const auto axpy = [](float a, float4 u, float4 v) {       // a u + v
    return make_float4(a * u.x + v.x, a * u.y + v.y, a * u.z + v.z, a * u.w + v.w);
  };
  if (!kept) {
    // the initial state may be any contiguous view: 4-byte loads
    const float* si = s0 + hrow * pn + e;
    float4 S = s0 != nullptr ? make_float4(si[0], si[1], si[2], si[3])
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    float* ws = states + first;
    float4 d = *reinterpret_cast<const float4*>(ws);
    float lc = last(0);
    for (int c = 0; c < nc; ++c) {
      float4 dn = d;
      float ln = lc;
      if (c + 1 < nc) {  // the next chunk's dS and decay, loaded ahead
        dn = *reinterpret_cast<const float4*>(ws + (c + 1) * cstride);
        ln = last(c + 1);
      }
      *reinterpret_cast<float4*>(ws + c * cstride) = S;
      S = axpy(expf(lc), S, d);
      d = dn;
      lc = ln;
    }
  }
  const float* fi = dfin + hrow * pn + e;
  float4 W = dfin != nullptr ? make_float4(fi[0], fi[1], fi[2], fi[3])
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  float* wg = grads + first;
  float4 g = *reinterpret_cast<const float4*>(wg + (nc - 1) * cstride);
  float lc = last(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    float4 gn = g;
    float ln = lc;
    if (c > 0) {  // the previous chunk's G and decay, loaded ahead
      gn = *reinterpret_cast<const float4*>(wg + (c - 1) * cstride);
      ln = last(c - 1);
    }
    *reinterpret_cast<float4*>(wg + c * cstride) = W;
    W = axpy(expf(lc), W, g);
    g = gn;
    lc = ln;
  }
  if (dinit != nullptr) *reinterpret_cast<float4*>(dinit + hrow * pn + e) = W;
}

// ---------------------------------------------------------------------------
// 3. the chunk gradients
// ---------------------------------------------------------------------------
template <int Q>
__global__ void __launch_bounds__(rt::kThreads, 2)
ssd_bwd_kernel_tc_chunk_grads(const bf16* __restrict__ x, const float* __restrict__ dt,
                              const float* __restrict__ A, const bf16* __restrict__ B,
                              const bf16* __restrict__ C, const bf16* __restrict__ dy,
                              const float* __restrict__ cum, const float* __restrict__ states,
                              const float* __restrict__ grads, bf16* __restrict__ dx,
                              float* __restrict__ ddt, float* __restrict__ dB_part,
                              float* __restrict__ dC_part, float* __restrict__ dA_part, int s,
                              int h, int p, int n, int nc, int64_t x_sb, int64_t x_st,
                              int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st, bool vx,
                              bool vb, bool vc, bool vy) {
  using namespace rt::mma;
  constexpr int MT = Q / 16;         // 16-row tiles of the chunk
  constexpr int NP = kWarps / MT;    // warps that share a row tile, each a part of the columns
  constexpr int E = (Q + 31) / 32;   // timesteps a lane of the scalar warp holds
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x / nc, c = blockIdx.x % nc, g = blockIdx.y, h0 = g * kHeadGroup;
  const int groups = gridDim.y;
  const int nh = rt::imin(kHeadGroup, h - h0);
  const int t0 = c * Q, L = rt::imin(Q, s - t0);
  const int ns = pad_row(n), ps = pad_row(p), qs = pad_row(Q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, quad = lane & 3;
  const int mi = warp % MT, part = warp / MT;  // the warp's 16 rows, its share of the columns
  bf16* sB = reinterpret_cast<bf16*>(smem);  // Q x (n+8): B_c, [k][j]
  bf16* sC = sB + Q * ns;                   // Q x (n+8): C_c, [t][j]
  bf16* sX = sC + Q * ns;                   // Q x (p+8): x_c of one head, [k][m]
  bf16* sY = sX + Q * ps;                   // Q x (p+8): its dy_c, [t][m]
  bf16* sWh = sY + Q * ps;                  // p x (n+8): W_c, then S_c, big term, [m][j]
  bf16* sWl = sWh + p * ns;                 // p x (n+8): its small term
  bf16* sRh = sWl + p * ns;                 // Q x (Q+8): R^T, big term, [k][t]
  bf16* sRl = sRh + Q * qs;                 // Q x (Q+8): its small term
  float* sCum = reinterpret_cast<float*>(sRl + Q * qs);  // kHeadGroup x Q
  float* sDt = sCum + kHeadGroup * Q;       // kHeadGroup x Q
  float* sEw = sDt + kHeadGroup * Q;        // Q: ew_k of the head
  float* sEc = sEw + Q;                     // Q: exp(cum_t)
  float* sCol = sEc + Q;                    // Q: sum_t P_tk (dy_t . x_k)
  float* sRow = sCol + Q;                   // MT x Q: sum_k P_tk (dy_t . x_k) dt_k, a key tile each
  float* sXwb = sRow + MT * Q;              // NP x Q: x_k . W B_k, a column part each
  float* sYsc = sXwb + NP * Q;              // NP x Q: dy_t . S C_t, a column part each
  float* sRed = sYsc + NP * Q;              // kWarps: partial sums of <W_c, S_c>

  // a float32 p x n state into sWh/sWl; with `other`, returns this thread's
  // part of <other, state>
  const auto stage_state = [&](const float* __restrict__ src, const float* __restrict__ other) {
    const int q4 = n / 4;
    float dot = 0.f;
    for (int i = threadIdx.x; i < p * q4; i += rt::kThreads) {
      const int m = i / q4, j = (i % q4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(src + (int64_t)m * n + j);
      if (other != nullptr) {
        const float4 o = *reinterpret_cast<const float4*>(other + (int64_t)m * n + j);
        dot += o.x * v.x + o.y * v.y + o.z * v.z + o.w * v.w;
      }
      uint32_t b0, b1, l0, l1;
      split_bf16(v.x, v.y, b0, l0);
      split_bf16(v.z, v.w, b1, l1);
      *reinterpret_cast<uint2*>(sWh + m * ns + j) = make_uint2(b0, b1);
      *reinterpret_cast<uint2*>(sWl + m * ns + j) = make_uint2(l0, l1);
    }
    return dot;
  };

  stage_rows<Q>(sB, B + row * b_sb + t0 * b_st, b_st, L, n, vb);
  stage_rows<Q>(sC, C + row * c_sb + t0 * c_st, c_st, L, n, vc);
  for (int i = threadIdx.x; i < kHeadGroup * Q; i += rt::kThreads) {
    const int hh = i / Q, k = i % Q;
    const bool live = hh < nh && k < L;
    const int64_t at = ((int64_t)row * s + t0 + k) * h + h0 + hh;
    sCum[i] = live ? cum[at] : 0.f;
    sDt[i] = live ? dt[at] : 0.f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // CB^T = B_c C_c^T for this warp's 16 keys against the times of tiles at
  // and after them, once a block
  float cb[Q / 8][4];
#pragma unroll
  for (int j = 0; j < Q / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
  for (int ks = 0; ks < n / 16; ++ks) {
    uint32_t a[4];
    load_a(a, sB, ns, 16 * mi, 16 * ks);
#pragma unroll
    for (int tt = 0; tt < MT; ++tt) {
      if (tt < mi) continue;
      uint32_t f[4];
      load_b(f, sC, ns, 16 * tt, 16 * ks);
      mma16(cb[2 * tt], cb[2 * tt + 1], a, f);
    }
  }
  // the lane's two rows of the warp's tile: keys k (dx, dB) or times t (dC)
  const int kr[2] = {16 * mi + group, 16 * mi + group + 8};

  for (int hh = 0; hh < nh; ++hh) {
    const int hd = h0 + hh;
    const int64_t base = (((int64_t)row * nc + c) * h + hd) * p * n;
    if (hh > 0) __syncthreads();  // every reader of the previous head's tiles is done
    stage_rows<Q>(sX, x + row * x_sb + t0 * x_st + (int64_t)hd * p, x_st, L, p, vx);
    stage_rows<Q>(sY, dy + ((int64_t)row * s + t0) * h * p + (int64_t)hd * p, (int64_t)h * p, L,
                  p, vy);
    cp_async_commit();
    stage_state(grads + base, nullptr);  // W_c
    const float* cm = sCum + hh * Q;
    const float* dtv = sDt + hh * Q;
    for (int k = threadIdx.x; k < Q; k += rt::kThreads) {
      sEw[k] = k < L ? expf(cm[L - 1] - cm[k]) : 0.f;
      sEc[k] = k < L ? expf(cm[k]) : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // DX^T = x_c dy_c^T for this warp's keys; then P^T, R^T (exp only where
    // t >= k, cum_t - cum_k <= 0), the column and row sums of P o DX
    float dxt[Q / 8][4];
#pragma unroll
    for (int j = 0; j < Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxt[j][e] = 0.f;
    for (int ks = 0; ks < p / 16; ++ks) {
      uint32_t a[4];
      load_a(a, sX, ps, 16 * mi, 16 * ks);
#pragma unroll
      for (int tt = 0; tt < MT; ++tt) {
        if (tt < mi) continue;
        uint32_t f[4];
        load_b(f, sY, ps, 16 * tt, 16 * ks);
        mma16(dxt[2 * tt], dxt[2 * tt + 1], a, f);
      }
    }
    const float ck[2] = {cm[kr[0]], cm[kr[1]]};
    const float tk[2] = {dtv[kr[0]], dtv[kr[1]]};
    // E^T of the lane's element e of the n8 tile j of time tile tt
    const auto decay = [&](int tt, int j, int e) {
      const int t = 16 * tt + 8 * j + 2 * quad + (e & 1);
      return (t >= kr[e >> 1] && t < L) ? expf(cm[t] - ck[e >> 1]) : 0.f;
    };
    float col[2] = {0.f, 0.f};
#pragma unroll
    for (int tt = 0; tt < MT; ++tt) {
      if (tt < mi) continue;
      float rv[2][4], rs[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        rs[j][0] = rs[j][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ee = decay(tt, j, e);
          const float pd = cb[2 * tt + j][e] * ee * dxt[2 * tt + j][e];
          rv[j][e] = dxt[2 * tt + j][e] * ee * tk[e >> 1];
          col[e >> 1] += pd;
          rs[j][e & 1] += pd * tk[e >> 1];
        }
      }
      uint32_t rb[4], rl[4];
      split_bf16(rv[0][0], rv[0][1], rb[0], rl[0]);
      split_bf16(rv[0][2], rv[0][3], rb[1], rl[1]);
      split_bf16(rv[1][0], rv[1][1], rb[2], rl[2]);
      split_bf16(rv[1][2], rv[1][3], rb[3], rl[3]);
      if (tt % NP == part) {  // one warp of the row tile stores each R^T tile
        const int at = kr[0] * qs + 16 * tt + 2 * quad;
        *reinterpret_cast<uint32_t*>(sRh + at) = rb[0];
        *reinterpret_cast<uint32_t*>(sRh + at + 8 * qs) = rb[1];
        *reinterpret_cast<uint32_t*>(sRh + at + 8) = rb[2];
        *reinterpret_cast<uint32_t*>(sRh + at + 8 * qs + 8) = rb[3];
        *reinterpret_cast<uint32_t*>(sRl + at) = rl[0];
        *reinterpret_cast<uint32_t*>(sRl + at + 8 * qs) = rl[1];
        *reinterpret_cast<uint32_t*>(sRl + at + 8) = rl[2];
        *reinterpret_cast<uint32_t*>(sRl + at + 8 * qs + 8) = rl[3];
      }
      // each time's sum over the warp's 16 keys: across the 8 lane groups
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            rs[j][b] += __shfl_xor_sync(0xffffffffu, rs[j][b], off);
      if (part == 0 && group == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) sRow[mi * Q + 16 * tt + 8 * j + 2 * quad + b] = rs[j][b];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // each key's sum over its times: across the quad
      col[i] += __shfl_xor_sync(0xffffffffu, col[i], 1);
      col[i] += __shfl_xor_sync(0xffffffffu, col[i], 2);
    }
    if (part == 0 && quad == 0) {
      sCol[kr[0]] = col[0];
      sCol[kr[1]] = col[1];
    }
    __syncthreads();  // R^T is in shared memory

    const float ew[2] = {sEw[kr[0]], sEw[kr[1]]};
    // dx = dt o (ew o (B_c W_c^T) + P^T dy_c), a part of p's columns a warp
    bf16* dxr = dx + ((int64_t)row * s + t0) * h * p + (int64_t)hd * p;
    for (int col0 = 32 * part; col0 < p; col0 += 32 * NP) {
      float acc[4][4] = {};
      for (int ks = 0; ks < n / 16; ++ks) {
        uint32_t a[4];
        load_a(a, sB, ns, 16 * mi, 16 * ks);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int col16 = col0 + 16 * np;
          if (col16 >= p) continue;
          uint32_t fh[4], fl[4];  // W_c [m][j]: m the output column
          load_b(fh, sWh, ns, col16, 16 * ks);
          load_b(fl, sWl, ns, col16, 16 * ks);
          mma16(acc[2 * np], acc[2 * np + 1], a, fh);
          mma16(acc[2 * np], acc[2 * np + 1], a, fl);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= ew[e >> 1];
#pragma unroll
      for (int tt = 0; tt < MT; ++tt) {
        if (tt < mi) continue;
        // P^T = CB^T o E^T for the times of tile tt, as A fragments (two
        // bf16 terms): the m16n8 layout of two adjacent tiles is an A tile's
        float pv[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[j][e] = cb[2 * tt + j][e] * decay(tt, j, e);
        uint32_t pb[4], pl[4];
        split_bf16(pv[0][0], pv[0][1], pb[0], pl[0]);
        split_bf16(pv[0][2], pv[0][3], pb[1], pl[1]);
        split_bf16(pv[1][0], pv[1][1], pb[2], pl[2]);
        split_bf16(pv[1][2], pv[1][3], pb[3], pl[3]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int col16 = col0 + 16 * np;
          if (col16 >= p) continue;
          uint32_t f[4];  // dy_c [t][m]
          load_b_t(f, sY, ps, col16, 16 * tt);
          mma16(acc[2 * np], acc[2 * np + 1], pb, f);
          mma16(acc[2 * np], acc[2 * np + 1], pl, f);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = col0 + 8 * j + 2 * quad;
        if (cl >= p) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (kr[i] < L)
            *reinterpret_cast<uint32_t*>(dxr + (int64_t)kr[i] * h * p + cl) =
                pack_bf16(tk[i] * acc[j][2 * i], tk[i] * acc[j][2 * i + 1]);
      }
    }

    // dB = (dt ew) o (x_c W_c) + R^T C_c, a part of n's columns a warp;
    // x_k . W B_k from the first product
    {
      const float sc[2] = {tk[0] * ew[0], tk[1] * ew[1]};
      float xw[2] = {0.f, 0.f};
      for (int col0 = 32 * part; col0 < n; col0 += 32 * NP) {
        float acc[4][4] = {};
        for (int ks = 0; ks < p / 16; ++ks) {
          uint32_t a[4];
          load_a(a, sX, ps, 16 * mi, 16 * ks);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int col16 = col0 + 16 * np;
            if (col16 >= n) continue;
            uint32_t fh[4], fl[4];  // W_c [m][j]: j the output column
            load_b_t(fh, sWh, ns, col16, 16 * ks);
            load_b_t(fl, sWl, ns, col16, 16 * ks);
            mma16(acc[2 * np], acc[2 * np + 1], a, fh);
            mma16(acc[2 * np], acc[2 * np + 1], a, fl);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = col0 + 8 * j + 2 * quad;
          if (cl >= n) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 bk =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sB + kr[i] * ns + cl));
            xw[i] += bk.x * acc[j][2 * i] + bk.y * acc[j][2 * i + 1];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= sc[e >> 1];
#pragma unroll
        for (int tt = 0; tt < MT; ++tt) {
          if (tt < mi) continue;
          uint32_t rh[4], rl[4];
          load_a(rh, sRh, qs, 16 * mi, 16 * tt);
          load_a(rl, sRl, qs, 16 * mi, 16 * tt);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int col16 = col0 + 16 * np;
            if (col16 >= n) continue;
            uint32_t f[4];  // C_c [t][j]
            load_b_t(f, sC, ns, col16, 16 * tt);
            mma16(acc[2 * np], acc[2 * np + 1], rh, f);
            mma16(acc[2 * np], acc[2 * np + 1], rl, f);
          }
        }
        // the head group's sum in head order: the first head stores, the
        // next adds to what this thread stored
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = col0 + 8 * j + 2 * quad;
          if (cl >= n) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (kr[i] >= L) continue;
            float2* at = reinterpret_cast<float2*>(
                dB_part + (((int64_t)row * s + t0 + kr[i]) * groups + g) * n + cl);
            float2 v = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
            if (hh > 0) {
              const float2 o = *at;
              v = make_float2(o.x + v.x, o.y + v.y);
            }
            *at = v;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xw[i] += __shfl_xor_sync(0xffffffffu, xw[i], 1);
        xw[i] += __shfl_xor_sync(0xffffffffu, xw[i], 2);
      }
      if (quad == 0) {
        sXwb[part * Q + kr[0]] = xw[0];
        sXwb[part * Q + kr[1]] = xw[1];
      }
    }
    __syncthreads();  // every reader of W_c is done

    {  // S_c over W_c, and <W_c, S_c>
      float ws = stage_state(states + base, grads + base);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ws += __shfl_xor_sync(0xffffffffu, ws, off);
      if (lane == 0) sRed[warp] = ws;
    }
    __syncthreads();

    // dC = exp(cum) o (dy_c S_c) + R B_c, this warp's times, a part of n's
    // columns; dy_t . S C_t from the first product
    {
      const float ec[2] = {sEc[kr[0]], sEc[kr[1]]};
      float ys[2] = {0.f, 0.f};
      for (int col0 = 32 * part; col0 < n; col0 += 32 * NP) {
        float acc[4][4] = {};
        for (int ks = 0; ks < p / 16; ++ks) {
          uint32_t a[4];
          load_a(a, sY, ps, 16 * mi, 16 * ks);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int col16 = col0 + 16 * np;
            if (col16 >= n) continue;
            uint32_t fh[4], fl[4];  // S_c [m][j]
            load_b_t(fh, sWh, ns, col16, 16 * ks);
            load_b_t(fl, sWl, ns, col16, 16 * ks);
            mma16(acc[2 * np], acc[2 * np + 1], a, fh);
            mma16(acc[2 * np], acc[2 * np + 1], a, fl);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = col0 + 8 * j + 2 * quad;
          if (cl >= n) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 ct =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sC + kr[i] * ns + cl));
            ys[i] += ct.x * acc[j][2 * i] + ct.y * acc[j][2 * i + 1];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= ec[e >> 1];
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {
          if (kk > mi) continue;
          uint32_t rh[4], rl[4];  // R = (R^T)^T: times as rows, keys of tile kk
          load_a_t(rh, sRh, qs, 16 * mi, 16 * kk);
          load_a_t(rl, sRl, qs, 16 * mi, 16 * kk);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int col16 = col0 + 16 * np;
            if (col16 >= n) continue;
            uint32_t f[4];  // B_c [k][j]
            load_b_t(f, sB, ns, col16, 16 * kk);
            mma16(acc[2 * np], acc[2 * np + 1], rh, f);
            mma16(acc[2 * np], acc[2 * np + 1], rl, f);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = col0 + 8 * j + 2 * quad;
          if (cl >= n) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (kr[i] >= L) continue;
            float2* at = reinterpret_cast<float2*>(
                dC_part + (((int64_t)row * s + t0 + kr[i]) * groups + g) * n + cl);
            float2 v = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
            if (hh > 0) {
              const float2 o = *at;
              v = make_float2(o.x + v.x, o.y + v.y);
            }
            *at = v;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ys[i] += __shfl_xor_sync(0xffffffffu, ys[i], 1);
        ys[i] += __shfl_xor_sync(0xffffffffu, ys[i], 2);
      }
      if (quad == 0) {
        sYsc[part * Q + kr[0]] = ys[0];
        sYsc[part * Q + kr[1]] = ys[1];
      }
    }
    __syncthreads();

    // per timestep, one warp: ddt's direct part and dcum, then da, the
    // reverse cumsum of dcum, ddt and dA's part (lane holds timesteps
    // lane*E .. lane*E+E-1)
    if (warp == 0) {
      const float a = A[hd];
      float dd[E], dc[E];
      float tail = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = lane * E + e;
        dd[e] = dc[e] = 0.f;
        if (t < L) {
          float rowdt = 0.f, xw = 0.f, ys = 0.f;
          for (int r = 0; r <= t / 16; ++r) rowdt += sRow[r * Q + t];
#pragma unroll
          for (int r = 0; r < NP; ++r) {
            xw += sXwb[r * Q + t];
            ys += sYsc[r * Q + t];
          }
          const float cl = sCol[t], w = sEw[t], d = dtv[t];
          dd[e] = cl + w * xw;
          dc[e] = rowdt - d * cl + sEc[t] * ys - w * d * xw;
          tail += w * d * xw;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) tail += __shfl_xor_sync(0xffffffffu, tail, off);
      float wsum = 0.f;
      for (int i = 0; i < kWarps; ++i) wsum += sRed[i];
#pragma unroll
      for (int e = 0; e < E; ++e)  // the last live row: exp(cum_last) <W, S_c> and the tail
        if (lane * E + e == L - 1) dc[e] += sEc[L - 1] * wsum + tail;
      float run = 0.f;
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        run += dc[e];
        dc[e] = run;
      }
      float incl = run;  // suffix sums over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += up;
      }
      float above = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) above = 0.f;
      float da_sum = 0.f;
      const int64_t at0 = ((int64_t)row * s + t0) * h + hd;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = lane * E + e;
        if (t < L) {
          const float da = dc[e] + above;
          ddt[at0 + (int64_t)t * h] = dd[e] + a * da;
          da_sum += dtv[t] * da;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) da_sum += __shfl_xor_sync(0xffffffffu, da_sum, off);
      if (lane == 0) dA_part[((int64_t)row * nc + c) * h + hd] = da_sum;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. the sums over head groups and over (row, chunk), in a fixed order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_tc_reduce_bc(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                            bf16* __restrict__ dB, bf16* __restrict__ dC, int64_t total,
                            int groups, int n) {
  const int64_t i = ((int64_t)blockIdx.x * rt::kThreads + threadIdx.x) * 4;  // 4 of n a thread
  if (i >= total) return;
  const int64_t rs = i / n;  // (row, t)
  const int j = (int)(i % n);
  const float* pb = dB_part + rs * groups * n + j;
  const float* pc = dC_part + rs * groups * n + j;
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  for (int gg = 0; gg < groups; ++gg) {
    const float4 u = *reinterpret_cast<const float4*>(pb + (int64_t)gg * n);
    const float4 v = *reinterpret_cast<const float4*>(pc + (int64_t)gg * n);
    sb = make_float4(sb.x + u.x, sb.y + u.y, sb.z + u.z, sb.w + u.w);
    sc = make_float4(sc.x + v.x, sc.y + v.y, sc.z + v.z, sc.w + v.w);
  }
  *reinterpret_cast<uint2*>(dB + i) =
      make_uint2(rt::mma::pack_bf16(sb.x, sb.y), rt::mma::pack_bf16(sb.z, sb.w));
  *reinterpret_cast<uint2*>(dC + i) =
      make_uint2(rt::mma::pack_bf16(sc.x, sc.y), rt::mma::pack_bf16(sc.z, sc.w));
}

__global__ void __launch_bounds__(rt::kThreads)
ssd_bwd_kernel_tc_reduce_a(const float* __restrict__ dA_part, float* __restrict__ dA, int parts,
                           int h) {
  const int hd = blockIdx.x * rt::kThreads + threadIdx.x;
  if (hd >= h) return;
  float acc = 0.f;
  for (int r = 0; r < parts; ++r) acc += dA_part[(int64_t)r * h + hd];
  dA[hd] = acc;
}

template <int Q>
int launch(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C,
           const float* s0, const bf16* dy, const float* dfin, bf16* dx, float* ddt, float* dA,
           bf16* dB, bf16* dC, float* dinit, float* cum, float* states, float* grads,
           float* dB_part, float* dC_part, float* dA_part, int kept, int b, int s, int h, int p,
           int n, long long x_sb, long long x_st, long long b_sb, long long b_st, long long c_sb,
           long long c_st, cudaStream_t st) {
  const int nc = (s + Q - 1) / Q;
  const int groups = (h + kHeadGroup - 1) / kHeadGroup;
  const size_t sm1 = state_smem(Q, p, n), sm3 = grads_smem(Q, p, n);
  cudaError_t e = rt::allow_smem(ssd_bwd_kernel_tc_chunk_states<Q>, sm1);
  if (e != cudaSuccess) return (int)e;
  e = rt::allow_smem(ssd_bwd_kernel_tc_chunk_grads<Q>, sm3);
  if (e != cudaSuccess) return (int)e;
  const bool vx = vec_ok(x, x_sb, x_st), vb = vec_ok(B, b_sb, b_st), vc = vec_ok(C, c_sb, c_st);
  const bool vy = vec_ok(dy, (long long)s * h * p, (long long)h * p);
  ssd_bwd_kernel_tc_chunk_states<Q><<<dim3(b * nc, groups), rt::kThreads, sm1, st>>>(
      x, dt, A, B, C, dy, cum, states, grads, kept, s, h, p, n, nc, x_sb, x_st, b_sb, b_st, c_sb,
      c_st, vx, vb, vc, vy);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int pn = p * n;
  const int slices = (pn / kPassVec + rt::kThreads - 1) / rt::kThreads;
  ssd_bwd_kernel_tc_state_pass<Q><<<dim3(slices, h, b), rt::kThreads, 0, st>>>(
      cum, s0, dfin, states, grads, dinit, kept, s, h, pn, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_kernel_tc_chunk_grads<Q><<<dim3(b * nc, groups), rt::kThreads, sm3, st>>>(
      x, dt, A, B, C, dy, cum, states, grads, dx, ddt, dB_part, dC_part, dA_part, s, h, p, n, nc,
      x_sb, x_st, b_sb, b_st, c_sb, c_st, vx, vb, vc, vy);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)b * s * n;
  ssd_bwd_kernel_tc_reduce_bc<<<(unsigned)((total / 4 + rt::kThreads - 1) / rt::kThreads),
                                rt::kThreads, 0, st>>>(dB_part, dC_part, dB, dC, total, groups,
                                                       n);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_kernel_tc_reduce_a<<<(h + rt::kThreads - 1) / rt::kThreads, rt::kThreads, 0, st>>>(
      dA_part, dA, b * nc, h);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 x: (b, s, h, p) with (h, p) contiguous inside a timestep, element
// strides x_sb between rows and x_st between timesteps; B, C: (b, s, n) with
// n contiguous, strides b_sb/b_st and c_sb/c_st; dt: (b, s, h) float32
// contiguous; A: (h,) float32; s0: (b, h, p, n) float32 contiguous initial
// state or null (zeros); dy: (b, s, h, p) bf16 contiguous; dfin: (b, h, p,
// n) float32 contiguous cotangent of the final state or null (zeros).  Out,
// contiguous: dx (b, s, h, p), dB and dC (b, s, n) bf16; ddt (b, s, h), dA
// (h,) and dinit (b, h, p, n; null: not written) float32.  float32
// contiguous, nc = ceil(s / chunk), groups = ceil(h / 2): cum (b, s, h) and
// states (b, nc, h, p, n), with kept the forward's (cum and the entry
// states S_in[c], read only), else workspaces; the workspaces grads (b, nc,
// h, p, n), dB_part and dC_part (b, s, groups, n), dA_part (b, nc, h).  p
// and n multiples of 16; chunk one of the RT_SSD_BWD_TC instances.
extern "C" int rt_ssd_bwd_tc(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, const void* s0, const void* dy, const void* dfin,
                             void* dx, void* ddt, void* dA, void* dB, void* dC, void* dinit,
                             void* cum, void* states, void* grads, void* dB_part, void* dC_part,
                             void* dA_part, int kept, int b, int s, int h, int p, int n,
                             int chunk, long long x_sb, long long x_st, long long b_sb,
                             long long b_st, long long c_sb, long long c_st, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || p % 16 || n % 16 || b > 65535 ||
      h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_SSD_BWD_TC(Q)                                                                       \
  case Q:                                                                                      \
    return launch<Q>((const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,        \
                     (const bf16*)C, (const float*)s0, (const bf16*)dy, (const float*)dfin,    \
                     (bf16*)dx, (float*)ddt, (float*)dA, (bf16*)dB, (bf16*)dC, (float*)dinit,  \
                     (float*)cum, (float*)states, (float*)grads, (float*)dB_part,              \
                     (float*)dC_part, (float*)dA_part, kept, b, s, h, p, n, x_sb, x_st, b_sb,  \
                     b_st, c_sb, c_st, st);
  switch (chunk) {
    RT_SSD_BWD_TC(16)
    RT_SSD_BWD_TC(32)
    RT_SSD_BWD_TC(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_SSD_BWD_TC
}
