// Mamba-2 SSD chunked scan for Hopper (sm_90a), bf16, on the tensor cores:
// the chunk-parallel SSD in three launches.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd for bf16 x, B, C at
// p % 16 == 0, n % 16 == 0 and chunks of Q in {16, 32, 64}
// (kernels/ssd.py plan); float32, and bf16 at other widths or chunks, keep
// csrc/ssd.cu.  The math is ssd.cu's decomposition: chunk c covers Q
// timesteps, cum is the inclusive cumsum of dt A inside it and
// w_k = exp(cum_last - cum_k) dt_k.  Only the state carried between chunks
// is sequential, so the scan splits into three launches on one stream:
//
// 1. ssd_kernel_chunk_state, one block per (row, chunk, head group): cum per
//    head by a warp scan (written to an f32 workspace of dt's shape), then
//    dS_c = (x_c o w)^T B_c, (p x Q)(Q x n) on mma.sync m16n8k16, written f32
//    to a workspace (b, nc, h, p, n).
// 2. ssd_kernel_state_pass, blocks over (slice of p n, head, row): in order
//    over the chunks S_in[c] = S (written over dS_c), S = exp(cum_last) S +
//    dS_c, from the initial state or zeros; the final state in x's dtype.
//    Element-wise float32: no product, no atomics.
// 3. ssd_kernel_chunk_out, one block per (row, chunk, head group):
//    CB = C_c B_c^T once per block, held in registers and shared by its
//    heads; per head G = CB o exp(cum_q - cum_k) dt_k for k <= q (exp only
//    there, where cum_q - cum_k <= 0: nothing overflows), 0 elsewhere, and
//    y = G X_c + exp(cum_q) (C_c S_in[c]^T), both on mma.sync, summed in
//    float32 and rounded to bf16 once.
//
// Exactness: x, B and C are bf16 and enter the products exactly; every
// float32 operand (x o w, G, S_in) enters as two bf16 terms (mma.cuh
// split_bf16), which carry it to about 2^-17 of itself.  The state stays
// float32 in every workspace.  The trailing chunk reads and writes its live
// rows only (rows past s are zero in shared memory), so no row past s is
// touched.  No atomics and a fixed order: two calls give the same bits, and
// a row's output depends on that row's inputs only.  Rows of x, B or C that
// are not 16-byte aligned (a projection of odd width) load as 2-byte
// elements in the same kernels, with the same values.
//
// Bound on this card: bytes.  At the static serve pass (8 rows of 881
// tokens, 24 heads, p 64, n 128, chunk 64) the scan must read x, B, C, dt
// and write y and the final state, ~49 MB (0.0151 ms at 3.35 TB/s), for
// ~6.3 GFLOP.  This design moves more: the f32 chunk-state workspace
// (88 MB there) is written once by launch 1, read and rewritten by
// launch 2 and read by launch 3, ~352 MB, ~0.105 ms: its own floor, ~7x
// the bound.  Carrying S in registers through a sequential output launch,
// so that the workspace goes away, is later work.
#include "common.cuh"
#include "mma.cuh"
#include "ssd_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::ssd::load8;
using rt::ssd::pad_row;
using rt::ssd::stage_rows;
using rt::ssd::unpack8;
using rt::ssd::vec_ok;
constexpr int kHeadGroup = 2;    // heads per block of launches 1 and 3
constexpr int kWarps = rt::kThreads / 32;
constexpr int kPassVec = 4;      // state elements a thread of launch 2 carries

// bytes of dynamic shared memory of launches 1 and 3 (kernels/ssd.py
// tc_smem_bytes mirrors these)
__host__ __device__ inline size_t state_smem(int Q, int p, int n) {
  return 2 * ((size_t)Q * pad_row(n) + 2 * (size_t)Q * pad_row(p)) + 4 * (size_t)kHeadGroup * Q;
}
__host__ __device__ inline size_t out_smem(int Q, int p, int n) {
  return 2 * (2 * (size_t)Q * pad_row(n) + (size_t)Q * pad_row(p) + 2 * (size_t)p * pad_row(n)) +
         4 * 2 * (size_t)kHeadGroup * Q;
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------
template <int Q>
__global__ void __launch_bounds__(rt::kThreads)
ssd_kernel_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ B,
                       float* __restrict__ cum_ws, float* __restrict__ states, int s, int h,
                       int p, int n, int nc, int64_t x_sb, int64_t x_st, int64_t b_sb,
                       int64_t b_st, bool vx, bool vb) {
  using namespace rt::mma;
  constexpr int E = (Q + 31) / 32;  // timesteps a lane scans
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x / nc, c = blockIdx.x % nc, h0 = blockIdx.y * kHeadGroup;
  const int nh = rt::imin(kHeadGroup, h - h0);
  const int t0 = c * Q, L = rt::imin(Q, s - t0);
  const int ns = pad_row(n), ps = pad_row(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* sB = reinterpret_cast<bf16*>(smem);  // Q x (n+8): B_c, [k][j]
  bf16* sXb = sB + Q * ns;                  // Q x (p+8): big term of x o w, [k][m]
  bf16* sXs = sXb + Q * ps;                 // Q x (p+8): its small term
  float* sW = reinterpret_cast<float*>(sXs + Q * ps);  // kHeadGroup x Q: w_k

  stage_rows<Q>(sB, B + row * b_sb + t0 * b_st, b_st, L, n, vb);
  // cum and w of head h0 + warp: lane holds timesteps lane*E .. lane*E+E-1
  if (warp < nh) {
    const int hd = h0 + warp;
    const float a = A[hd];
    const float* dtr = dt + ((int64_t)row * s + t0) * h + hd;
    float d[E], cu[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane * E + e;
      d[e] = k < L ? dtr[(int64_t)k * h] : 0.f;
      cu[e] = (e > 0 ? cu[e - 1] : 0.f) + d[e] * a;
    }
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
    const float last = __shfl_sync(0xffffffffu, mine, (L - 1) / E);
    float* cr = cum_ws + ((int64_t)row * s + t0) * h + hd;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane * E + e;
      if (k < Q) sW[warp * Q + k] = k < L ? expf(last - cu[e]) * d[e] : 0.f;
      if (k < L) cr[(int64_t)k * h] = cu[e];
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int mt = p / 16, nt = (n + 31) / 32;  // 16 x 32 output tiles of dS
  const int group = lane >> 2, quad_t = lane & 3;
  for (int hh = 0; hh < nh; ++hh) {
    const int hd = h0 + hh;
    // x o w as two bf16 terms, [k][m]
    const bf16* xr = x + row * x_sb + t0 * x_st + (int64_t)hd * p;
    const float* w = sW + hh * Q;
    const int chunks = p / 8;
    for (int i = threadIdx.x; i < Q * chunks; i += rt::kThreads) {
      const int k = i / chunks, ch = i % chunks;
      float f[8];
      unpack8(k < L ? load8(xr + k * x_st + ch * 8, vx) : make_uint4(0, 0, 0, 0), f);
      uint32_t big[4], small[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_bf16(f[2 * j] * w[k], f[2 * j + 1] * w[k], big[j], small[j]);
      *reinterpret_cast<uint4*>(sXb + k * ps + ch * 8) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(sXs + k * ps + ch * 8) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
    __syncthreads();
    float* dst = states + (((int64_t)row * nc + c) * h + hd) * p * n;
    for (int tile = warp; tile < mt * nt; tile += kWarps) {
      const int mi = tile / nt, col0 = (tile % nt) * 32;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        if (16 * kk >= L) continue;  // rows past L are zero
        uint32_t ab[4], as[4];  // A = (x o w)^T: read [k][m] transposed
        const int ar = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
        const int ac = 2 * mi + ((lane >> 3) & 1);
        ldmatrix_x4_trans(ab, sXb + ar * ps + ac * 8);
        ldmatrix_x4_trans(as, sXs + ar * ps + ac * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int col16 = col0 + 16 * np;
          if (col16 >= n) continue;
          uint32_t bf[4];  // B_c [k][j], read transposed
          ldmatrix_x4_trans(bf, sB + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * ns +
                                    (col16 / 8 + (lane >> 4)) * 8);
          mma_bf16(acc[2 * np], ab, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], ab, bf[2], bf[3]);
          mma_bf16(acc[2 * np], as, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], as, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 8 * j + 2 * quad_t;
        if (col >= n) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = 16 * mi + group + 8 * i;
          *reinterpret_cast<float2*>(dst + (int64_t)m * n + col) =
              make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
        }
      }
    }
    __syncthreads();  // every reader of this head's x o w is done
  }
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------
template <int Q>
__global__ void __launch_bounds__(rt::kThreads)
ssd_kernel_state_pass(const float* __restrict__ cum_ws, const float* __restrict__ s0,
                      float* states, bf16* __restrict__ sf, int s, int h, int pn, int nc) {
  const int e = (blockIdx.x * rt::kThreads + threadIdx.x) * kPassVec;
  const int hd = blockIdx.y, row = blockIdx.z;
  if (e >= pn) return;
  const int64_t hrow = (int64_t)row * h + hd;
  // the initial state may be any contiguous view: 4-byte loads
  const float* si = s0 + hrow * pn + e;
  float4 S = s0 != nullptr ? make_float4(si[0], si[1], si[2], si[3])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  float* ws = states + ((int64_t)row * nc * h + hd) * pn + e;
  const int64_t cstride = (int64_t)h * pn;
  const float* cr = cum_ws + (int64_t)row * s * h + hd;
  float4 d = *reinterpret_cast<const float4*>(ws);
  float lc = cr[(int64_t)(rt::imin(s, Q) - 1) * h];
  for (int c = 0; c < nc; ++c) {
    float4 dn = d;
    float ln = lc;
    if (c + 1 < nc) {  // the next chunk's dS and decay, loaded ahead
      dn = *reinterpret_cast<const float4*>(ws + (c + 1) * cstride);
      ln = cr[(int64_t)(rt::imin(s, (c + 2) * Q) - 1) * h];
    }
    *reinterpret_cast<float4*>(ws + c * cstride) = S;
    const float decay = expf(lc);
    S = make_float4(decay * S.x + d.x, decay * S.y + d.y, decay * S.z + d.z, decay * S.w + d.w);
    d = dn;
    lc = ln;
  }
  if (sf != nullptr) {
    uint2 v = make_uint2(rt::mma::pack_bf16(S.x, S.y), rt::mma::pack_bf16(S.z, S.w));
    *reinterpret_cast<uint2*>(sf + hrow * pn + e) = v;
  }
}

// ---------------------------------------------------------------------------
// 3. output
// ---------------------------------------------------------------------------
template <int Q>
__global__ void __launch_bounds__(rt::kThreads, 2)
ssd_kernel_chunk_out(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const bf16* __restrict__ B, const bf16* __restrict__ C,
                     const float* __restrict__ cum_ws, const float* __restrict__ states,
                     bf16* __restrict__ y, int s, int h, int p, int n, int nc, int64_t x_sb,
                     int64_t x_st, int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st,
                     bool vx, bool vb, bool vc) {
  using namespace rt::mma;
  constexpr int MT = Q / 16;         // 16-row tiles of the chunk
  constexpr int NP = kWarps / MT;    // warps that share a row tile, each a part of p
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x / nc, c = blockIdx.x % nc, h0 = blockIdx.y * kHeadGroup;
  const int nh = rt::imin(kHeadGroup, h - h0);
  const int t0 = c * Q, L = rt::imin(Q, s - t0);
  const int ns = pad_row(n), ps = pad_row(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, quad_t = lane & 3;
  bf16* sC = reinterpret_cast<bf16*>(smem);  // Q x (n+8): C_c, [q][j]
  bf16* sB = sC + Q * ns;                   // Q x (n+8): B_c, [k][j]
  bf16* sX = sB + Q * ns;                   // Q x (p+8): x_c of one head, [k][m]
  // p x (n+8) float32: S_in[c] of one head, [m][j]; with rows of n + 8
  // floats a warp's float2 fragment loads take two wavefronts, the least
  float* sS = reinterpret_cast<float*>(sX + Q * ps);
  float* sCum = sS + p * ns;                // kHeadGroup x Q
  float* sDt = sCum + kHeadGroup * Q;       // kHeadGroup x Q

  // a head's x_c and S_in[c] (cp.async, committed; the caller waits)
  const auto stage_head = [&](int hd) {
    stage_rows<Q>(sX, x + row * x_sb + t0 * x_st + (int64_t)hd * p, x_st, L, p, vx);
    const float* s_in = states + (((int64_t)row * nc + c) * h + hd) * p * n;
    const int q4 = n / 4;
    for (int i = threadIdx.x; i < p * q4; i += rt::kThreads) {
      const int m = i / q4, j = (i % q4) * 4;
      cp_async_16(sS + m * ns + j, s_in + (int64_t)m * n + j, true);
    }
    cp_async_commit();
  };
  stage_rows<Q>(sC, C + row * c_sb + t0 * c_st, c_st, L, n, vc);
  stage_rows<Q>(sB, B + row * b_sb + t0 * b_st, b_st, L, n, vb);
  stage_head(h0);
  for (int i = threadIdx.x; i < kHeadGroup * Q; i += rt::kThreads) {
    const int hh = i / Q, k = i % Q;
    const bool live = hh < nh && k < L;
    const int64_t at = ((int64_t)row * s + t0 + k) * h + h0 + hh;
    sCum[i] = live ? cum_ws[at] : 0.f;
    sDt[i] = live ? dt[at] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // CB for this warp's 16 rows: keys of the row tile and before it only
  const int mi = warp % MT, part = warp / MT;
  float cb[Q / 8][4];
#pragma unroll
  for (int j = 0; j < Q / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
  for (int ks = 0; ks < n / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, sC + (16 * mi + (lane & 15)) * ns + (2 * ks + (lane >> 4)) * 8);
#pragma unroll
    for (int np = 0; np < MT; ++np) {
      if (np > mi) continue;
      uint32_t kf[4];  // B_c [k][j]: keys 16np..+15, state chunks 2ks, 2ks+1
      ldmatrix_x4(kf, sB + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * ns +
                          (2 * ks + ((lane >> 3) & 1)) * 8);
      mma_bf16(cb[2 * np], a, kf[0], kf[1]);
      mma_bf16(cb[2 * np + 1], a, kf[2], kf[3]);
    }
  }

  for (int hh = 0; hh < nh; ++hh) {
    const int hd = h0 + hh;
    if (hh > 0) {
      __syncthreads();  // every reader of the previous head's tiles is done
      stage_head(hd);
      cp_async_wait<0>();
      __syncthreads();
    }
    const float* cm = sCum + hh * Q;
    const float* dd = sDt + hh * Q;
    float eq[2];  // exp(cum_q) of the lane's two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = 16 * mi + group + 8 * i;
      eq[i] = q < L ? expf(cm[q]) : 0.f;
    }
    bf16* yr = y + ((int64_t)row * s + t0) * h * p + (int64_t)hd * p;
    for (int col0 = 32 * part; col0 < p; col0 += 32 * NP) {
      float ai[4][4], ae[4][4];  // intra G X and inter C S_in^T, columns col0..col0+31
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ai[j][e] = ae[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        if (kk > mi) continue;
        // G of this warp's rows for keys 16kk..+15 as the A fragments of
        // its two bf16 terms (the m16n8 layout of cb is that of an A tile)
        float g[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 16 * mi + group + 8 * (e >> 1);
            const int k = 16 * kk + 8 * j + 2 * quad_t + (e & 1);
            g[j][e] = (k <= q && q < L) ? cb[2 * kk + j][e] * expf(cm[q] - cm[k]) * dd[k] : 0.f;
          }
        uint32_t gb[4], gs[4];
        split_bf16(g[0][0], g[0][1], gb[0], gs[0]);
        split_bf16(g[0][2], g[0][3], gb[1], gs[1]);
        split_bf16(g[1][0], g[1][1], gb[2], gs[2]);
        split_bf16(g[1][2], g[1][3], gb[3], gs[3]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int col16 = col0 + 16 * np;
          if (col16 >= p) continue;
          uint32_t vf[4];  // x_c [k][m], read transposed
          ldmatrix_x4_trans(vf, sX + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * ps +
                                    (col16 / 8 + (lane >> 4)) * 8);
          mma_bf16(ai[2 * np], gb, vf[0], vf[1]);
          mma_bf16(ai[2 * np + 1], gb, vf[2], vf[3]);
          mma_bf16(ai[2 * np], gs, vf[0], vf[1]);
          mma_bf16(ai[2 * np + 1], gs, vf[2], vf[3]);
        }
      }
      for (int ks = 0; ks < n / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, sC + (16 * mi + (lane & 15)) * ns + (2 * ks + (lane >> 4)) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int col16 = col0 + 16 * np;
          if (col16 >= p) continue;
          // B fragments of S_in [m][j] (k = j, n = m) for columns col16..+7
          // and +8..+15, each f32 pair split into its two bf16 terms
          uint32_t sb[4], ss[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const float2 v = *reinterpret_cast<const float2*>(
                sS + (col16 + group + 8 * (f >> 1)) * ns + 16 * ks + 8 * (f & 1) + 2 * quad_t);
            split_bf16(v.x, v.y, sb[f], ss[f]);
          }
          mma_bf16(ae[2 * np], a, sb[0], sb[1]);
          mma_bf16(ae[2 * np + 1], a, sb[2], sb[3]);
          mma_bf16(ae[2 * np], a, ss[0], ss[1]);
          mma_bf16(ae[2 * np + 1], a, ss[2], ss[3]);
        }
      }
      // y = intra + exp(cum_q) inter, rounded to bf16 once; live rows only
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 8 * j + 2 * quad_t;
        if (col >= p) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = 16 * mi + group + 8 * i;
          if (q < L)
            *reinterpret_cast<uint32_t*>(yr + (int64_t)q * h * p + col) =
                pack_bf16(ai[j][2 * i] + eq[i] * ae[j][2 * i],
                          ai[j][2 * i + 1] + eq[i] * ae[j][2 * i + 1]);
        }
      }
    }
  }
}

template <int Q>
int launch(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C,
           const float* s0, bf16* y, bf16* sf, float* cum, float* states, int b, int s, int h,
           int p, int n, long long x_sb, long long x_st, long long b_sb, long long b_st,
           long long c_sb, long long c_st, cudaStream_t st) {
  const int nc = (s + Q - 1) / Q;
  const int groups = (h + kHeadGroup - 1) / kHeadGroup;
  const size_t sm1 = state_smem(Q, p, n), sm3 = out_smem(Q, p, n);
  cudaError_t e = rt::allow_smem(ssd_kernel_chunk_state<Q>, sm1);
  if (e != cudaSuccess) return (int)e;
  e = rt::allow_smem(ssd_kernel_chunk_out<Q>, sm3);
  if (e != cudaSuccess) return (int)e;
  const bool vx = vec_ok(x, x_sb, x_st), vb = vec_ok(B, b_sb, b_st), vc = vec_ok(C, c_sb, c_st);
  ssd_kernel_chunk_state<Q><<<dim3(b * nc, groups), rt::kThreads, sm1, st>>>(
      x, dt, A, B, cum, states, s, h, p, n, nc, x_sb, x_st, b_sb, b_st, vx, vb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int pn = p * n;
  const int slices = (pn / kPassVec + rt::kThreads - 1) / rt::kThreads;
  ssd_kernel_state_pass<Q><<<dim3(slices, h, b), rt::kThreads, 0, st>>>(cum, s0, states, sf, s,
                                                                         h, pn, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_kernel_chunk_out<Q><<<dim3(b * nc, groups), rt::kThreads, sm3, st>>>(
      x, dt, B, C, cum, states, y, s, h, p, n, nc, x_sb, x_st, b_sb, b_st, c_sb, c_st, vx, vb,
      vc);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 x: (b, s, h, p) with (h, p) contiguous inside a timestep, element
// strides x_sb between rows and x_st between timesteps; B, C: (b, s, n)
// with n contiguous, strides b_sb/b_st and c_sb/c_st; dt: (b, s, h) float32
// contiguous; A: (h,) float32; s0: (b, h, p, n) float32 contiguous initial
// state or null (zeros).  y: (b, s, h, p) bf16 contiguous; sf: (b, h, p, n)
// bf16 contiguous final state or null.  Workspaces, float32 contiguous:
// cum (b, s, h) and states (b, ceil(s / chunk), h, p, n).  p and n multiples
// of 16; chunk one of the RT_SSD_TC instances.
extern "C" int rt_ssd_tc(const void* x, const void* dt, const void* A, const void* B,
                         const void* C, const void* s0, void* y, void* sf, void* cum,
                         void* states, int b, int s, int h, int p, int n, int chunk,
                         long long x_sb, long long x_st, long long b_sb, long long b_st,
                         long long c_sb, long long c_st, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || p % 16 || n % 16 || b > 65535 ||
      h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_SSD_TC(Q)                                                                          \
  case Q:                                                                                     \
    return launch<Q>((const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,       \
                     (const bf16*)C, (const float*)s0, (bf16*)y, (bf16*)sf, (float*)cum,      \
                     (float*)states, b, s, h, p, n, x_sb, x_st, b_sb, b_st, c_sb, c_st, st);
  switch (chunk) {
    RT_SSD_TC(16)
    RT_SSD_TC(32)
    RT_SSD_TC(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_SSD_TC
}
