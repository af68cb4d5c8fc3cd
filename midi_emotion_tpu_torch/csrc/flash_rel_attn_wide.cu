// Flash relative attention past the built head widths, forward and every
// backward decomposition, for Hopper (sm_90a).
//
// The kernels of flash_rel_attn_fwd.cu (1), flash_rel_attn_bwd.cu (4),
// flash_rel_attn_bwd_q.cu (5, 6, 8) and flash_rel_attn_bwd_kv.cu (7, 9)
// are instantiated per d_head and hold a query tile's operands at the whole
// width in registers and shared memory: kernels 1 and 4 up to d_head 256,
// kernels 5-9 up to 128. Their wrappers (ops/flash_attention.py) launch
// the kernels of this file for a wider head, so each replaces the same
// Pallas TPU kernel as its narrow counterpart
// (midi_emotion_tpu/ops/pallas_attention.py: _flash_kernel, _bwd_merged_kernel,
// _bwd_dq_de_kernel, _bwd_dq_de_dist_kernel, _bwd_dkdv_dq_kernel,
// _bwd_de_dqrel_kernel, _bwd_dkdv_kernel), which take d_head as one block.
// The math (c = scale, s = c (q_i . k_j + Srel[i, j]), Srel[i, j] = q_i .
// E[max_seq - 1 - (i - j)] for j <= i and 0 above the diagonal):
//
//     forward:  O_i = sum_j softmax_j(s[i, j]) V_j,  lse_i = m_i + log l_i
//     backward: P = exp(s - lse), dS' = c P (dO_i . V_j - dsum_i)
//               dV_j = sum_i P dO_i,   dK_j = sum_i dS' q_i,
//               dQ_i = sum_j dS' k_j  (key term)
//                    + sum_{j <= i} dS' E[max_seq - 1 - (i - j)]  (relative term)
//               dE[max_seq - 1 - d] = sum_i dS'[i, i - d] q_i
//
// with the same masks and contracts as the narrow kernels (a row whose keys
// are all masked: O = 0, lse = +1e30, zero gradients).
//
// Design: d_head is never held whole. Every kernel steps over 64 x 64
// score tiles (256 threads), with two sides:
//   * the score side contracts over d_head: S = Q K^T with the band Q
//     E_band^T, and dP = dO V^T. It streams d_head through shared memory in
//     chunks (the operand rows of a tile and the 127 band rows its 64 x 64
//     distances reach) and sums in f32 registers across chunks, so its
//     shared memory does not grow with d_head;
//   * the output side runs over d_head: a block computes the output columns
//     of one part of 128 (grid z), recomputing the score side, and keeps only
//     its part's columns of V (forward) or of K, E, Q and dO (backward)
//     resident beside the tile's P or dS'.
// Each output element has one owning block, and every sum runs in a fixed
// order: no atomics, deterministic results. Four sweeps:
//   * query-major, key by key column (forward; dQ's key term and its
//     relative term through the band): a block per (query tile, b h, part);
//   * query-major by distance (dQ's relative term as dS_d E_rev, the
//     distance-domain form of kernels 6 and 8): the same block walks
//     distance tiles, where the bias is a plain product and the keys
//     i - d form the band;
//   * key-major (dK, dV): a block per (key tile, b h, part);
//   * distance-major (dE): a block per (distance tile, b h, part) writes an
//     f32 partial per (b, h), which a reduction sums over (b, h) in order.
// Kernel -> sweeps: 1 the forward; 4 key-major, query-major by column (both
// terms) and distance-major; 5 query-major by column and distance-major;
// 6 query-major with the key term by column and the relative term by
// distance, and distance-major; 7 key-major and query-major (key term);
// 8 query-major by distance and distance-major; 9 key-major.
//
// Two paths, one per dtype. f32 (the checks' path, held to 1e-4): the CUDA
// cores, chunks of 32 columns, a thread 4 x 4 scores and
// 4 x 8 outputs. bf16 (the training and serving path, namespace tc): the
// tensor cores (mma.sync m16n8k16, f32 sums) on bf16 chunks of 64 columns
// and bf16 output parts, a warp 16 rows of each product; the skew, masks,
// softmax and dS' in f32 in the f32 path's thread layout, through f32
// tiles in shared memory; P and dS' rounded to bf16 for the output
// products, as the TPU kernels cast them.
//
// Bound on the H100: operations. The score side is recomputed for each part
// (d_head / 128 times) and each sweep: that is the cost of this simple
// design, measured in PERF.md. Kernels 1 and 4 in bf16 no longer pay it:
// up to 16 parts each runs on a thread-block cluster of one CTA a part
// that computes each tile pair's score side once, split by columns, on
// wgmma fed by TMA, and sums the parts' partials through distributed
// shared memory: cl::wide_fwd_tc_cluster_kernel (the forward, a cluster
// per query tile) and cl::wide_bwd_tc_cluster_kernel (the merged backward,
// a cluster per (b, h) and split of its key tiles, S and dP exchanged, each
// CTA's own columns of dV, dK, dQ and dE after; both below). Kernels 5-9,
// f32, and bf16 past 16 parts keep the sweeps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

constexpr int BT = 64;           // rows and columns of a score tile
constexpr int BAND = 2 * BT - 1; // band rows a tile's 64 x 64 pairs reach
constexpr int KC = 32;           // d_head columns a score chunk stages
constexpr int LD = KC + 1;       // staged row stride (floats): conflict-free columns
constexpr int PW = 128;          // output columns a block computes
constexpr int WLD = BT + 1;      // P / dS' tile row stride
constexpr int NT = 256;          // threads: 16 x 16, a thread 4 x 4 scores

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// staged row u reads global row first + step * u, zeros outside [lo, hi)
struct Rows {
  int first, step, lo, hi;
};

// n rows of `width` columns (col0.. of rows D wide) into dst[u * ld + k];
// columns at or past `ncols` land as zeros
template <int WIDTH>
__device__ __forceinline__ void stage(float* dst, int ld, int n, const float* __restrict__ src,
                                      int D, Rows m, int col0, int ncols) {
  for (int x = threadIdx.x; x < n * WIDTH; x += NT) {
    const int u = x / WIDTH, k = x - u * WIDTH;
    const int row = m.first + m.step * u;
    float val = 0.f;
    if (row >= m.lo && row < m.hi && k < ncols) val = src[(size_t)row * D + col0 + k];
    dst[u * ld + k] = val;
  }
}

// the score side's staged chunk: A (64 query rows), X (64 rows: keys, or
// the E rows of 64 distances), Y (the band: 127 E rows by distance, or 127
// keys), A2 (64 dO rows), B2 (V: 64 key rows by column, 127 band keys by
// distance)
constexpr int SCORE_FLOATS = (BT + BT + BAND + BT + BAND) * LD;

struct Score {
  float* A;
  float* X;
  float* Y;
  float* A2;
  float* B2;
  __device__ explicit Score(float* sm)
      : A(sm), X(sm + BT * LD), Y(sm + 2 * BT * LD), A2(sm + (2 * BT + BAND) * LD),
        B2(sm + (3 * BT + BAND) * LD) {}
};

// s[a][b] += A[r] . (X[c] + Y[r - c + 63]) over a chunk, r = ty + 16 a,
// c = tx + 16 b; with DP, dp[a][b] += A2[r] . V (V[c] by key column, the
// band V[r - c + 63] by distance)
template <bool DIST, bool DP>
__device__ __forceinline__ void score_chunk(float (&s)[4][4], float (&dp)[4][4], const Score& sc,
                                            int ty, int tx) {
  const int yb = ty - tx + BT - 1;
#pragma unroll 4
  for (int k = 0; k < KC; ++k) {
    float a[4], x[4], y[7];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sc.A[(ty + 16 * i) * LD + k];
      x[i] = sc.X[(tx + 16 * i) * LD + k];
    }
#pragma unroll
    for (int t = 0; t < 7; ++t) y[t] = sc.Y[(yb + 16 * (t - 3)) * LD + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], x[j] + y[i - j + 3], s[i][j]);
    if (DP) {
      float a2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a2[i] = sc.A2[(ty + 16 * i) * LD + k];
      if (DIST) {
        float v[7];
#pragma unroll
        for (int t = 0; t < 7; ++t) v[t] = sc.B2[(yb + 16 * (t - 3)) * LD + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a2[i], v[i - j + 3], dp[i][j]);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = sc.B2[(tx + 16 * j) * LD + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a2[i], v[j], dp[i][j]);
      }
    }
  }
}

// The whole score side of one tile pair: the raw q.(k + E) sums into s and,
// with DP, dO.v into dp. By key column (DIST false): query rows i0.., keys
// t0.., the band by distance i0 - t0 - 63 + u. By distance (DIST true):
// query rows i0.., distances t0.., the band by key i0 - t0 - 63 + u.
template <bool DIST, bool DP>
__device__ __forceinline__ void score_tile(float (&s)[4][4], float (&dp)[4][4], const Score& sc,
                                           const float* q, const float* k, const float* v,
                                           const float* e, const float* dout, int Tn, int D,
                                           int ms, int i0, int t0,
                                           int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
  const Rows qrows{i0, 1, 0, Tn};
  const Rows band_e{ms - 1 - i0 + t0 + BT - 1, -1, 0, ms};  // E row of distance i0 - t0 - 63 + u
  const Rows tile_e{ms - 1 - t0, -1, ms - Tn, ms};         // E row of distance t0 + c < T
  const Rows tile_k{t0, 1, 0, Tn};
  const Rows band_k{i0 - t0 - (BT - 1), 1, 0, Tn};          // key i0 - t0 - 63 + u
  for (int kc = 0; kc < D; kc += KC) {
    __syncthreads();  // every thread is done with the previous chunk or tile
    stage<KC>(sc.A, LD, BT, q, D, qrows, kc, KC);
    if (DIST) {
      stage<KC>(sc.X, LD, BT, e, D, tile_e, kc, KC);
      stage<KC>(sc.Y, LD, BAND, k, D, band_k, kc, KC);
    } else {
      stage<KC>(sc.X, LD, BT, k, D, tile_k, kc, KC);
      stage<KC>(sc.Y, LD, BAND, e, D, band_e, kc, KC);
    }
    if (DP) {
      stage<KC>(sc.A2, LD, BT, dout, D, qrows, kc, KC);
      if (DIST)
        stage<KC>(sc.B2, LD, BAND, v, D, band_k, kc, KC);
      else
        stage<KC>(sc.B2, LD, BT, v, D, tile_k, kc, KC);
    }
    __syncthreads();
    score_chunk<DIST, DP>(s, dp, sc, ty, tx);
  }
}

// pair (query i, key j) visible by key column
__device__ __forceinline__ bool visible_col(int i, int j, int Tn, const uint8_t* pad_b,
                                            int causal) {
  return i < Tn && j < Tn && !(pad_b != nullptr && pad_b[j]) && !(causal && j > i);
}

// pair (query i, distance d) visible by distance: key i - d, always j <= i
__device__ __forceinline__ bool visible_dist(int i, int d, int Tn, const uint8_t* pad_b) {
  const int j = i - d;
  return i < Tn && d < Tn && j >= 0 && !(pad_b != nullptr && pad_b[j]);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// forward (kernel 1 past d_head 256)
// ---------------------------------------------------------------------------

constexpr int FWD_FLOATS = (SCORE_FLOATS > BT * PW ? SCORE_FLOATS : BT * PW) + BT * WLD;

__global__ void __launch_bounds__(NT)
wide_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ e,
                const uint8_t* __restrict__ pad, float* __restrict__ o,
                float* __restrict__ lse, int H, int Tn, int D, int ms, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Score sc(sm);
  float* vs = sm;  // [BT][PW]: the part's V columns, after the score side
  float* ws = sm + (SCORE_FLOATS > BT * PW ? SCORE_FLOATS : BT * PW);  // [BT][WLD]: P
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BT;  // heaviest query tile first
  const int bh = blockIdx.y, b = bh / H;
  const int p0 = blockIdx.z * PW, ncols = min(PW, D - p0);
  const size_t base = (size_t)bh * Tn * D;
  const uint8_t* pad_b = pad == nullptr ? nullptr : pad + (size_t)b * Tn;

  float acc[4][8], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  }
  const int k_end = causal ? min(Tn, i0 + BT) : Tn;
  for (int j0 = 0; j0 < k_end; j0 += BT) {
    float s[4][4], unused[4][4];
    score_tile<false, false>(s, unused, sc, q + base, k + base, v + base, e, q + base, Tn, D,
                             ms, i0, j0, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = visible_col(i, j0 + tx + 16 * c, Tn, pad_b, causal) ? s[a][c] * scale
                                                                      : -INFINITY;
        rmax = fmaxf(rmax, s[a][c]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(rmax));
      const bool none = m_new == -INFINITY;  // no key of this row seen yet
      const float alpha = none ? 1.f : expf(m[a] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = none ? 0.f : expf(s[a][c] - m_new);
        rsum += s[a][c];
      }
      l[a] = l[a] * alpha + half_warp_sum(rsum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();  // the score side's tiles are read: V takes their place
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) ws[(ty + 16 * a) * WLD + tx + 16 * c] = s[a][c];
    stage<PW>(vs, PW, BT, v + base, D, Rows{j0, 1, 0, Tn}, p0, ncols);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float w[4], x[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) w[a] = ws[(ty + 16 * a) * WLD + c];
#pragma unroll
      for (int n = 0; n < 8; ++n) x[n] = vs[c * PW + tx + 16 * n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[a][n] = fmaf(w[a], x[n], acc[a][n]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= Tn) continue;
    const float inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = tx + 16 * n;
      if (col < ncols) o[base + (size_t)i * D + p0 + col] = acc[a][n] * inv;
    }
    if (blockIdx.z == 0 && tx == 0)
      lse[(size_t)bh * Tn + i] = l[a] > 0.f ? m[a] + logf(l[a]) : 1e30f;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct Bwd {
  const void* q;
  const void* k;
  const void* v;
  const void* e;
  const uint8_t* pad;
  const void* dout;
  const float* lse;
  const float* dsum;
  void* dq;
  void* dk;
  void* dv;
  void* de;
  float* de_part;  // [B * H, T, D] f32
  int B, H, Tn, D, ms, causal;
  float scale;
};

// P and dS' of one tile pair from its raw score sums, in place: s -> P,
// dp -> dS'; r = ty + 16 a holds query i0 + r, whose lse and dsum are given
template <bool DIST>
__device__ __forceinline__ void p_ds(float (&s)[4][4], float (&dp)[4][4], const float (&lse)[4],
                                     const float (&dsum)[4], int i0, int t0, int Tn,
                                     const uint8_t* pad_b, int causal, float scale, int ty,
                                     int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = t0 + tx + 16 * c;
      const bool vis = DIST ? visible_dist(i, t, Tn, pad_b) : visible_col(i, t, Tn, pad_b, causal);
      const float p = vis ? expf(s[a][c] * scale - lse[a]) : 0.f;
      s[a][c] = p;
      dp[a][c] = scale * p * (dp[a][c] - dsum[a]);
    }
  }
}

__device__ __forceinline__ void row_stats(const Bwd& p, int bh, int i0, int ty, float (&lse)[4],
                                          float (&dsum)[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    const bool ok = i < p.Tn;
    lse[a] = ok ? p.lse[(size_t)bh * p.Tn + i] : 1e30f;
    dsum[a] = ok ? p.dsum[(size_t)bh * p.Tn + i] : 0.f;
  }
}

__device__ __forceinline__ void put_tile(float* ws, const float (&x)[4][4], int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) ws[(ty + 16 * a) * WLD + tx + 16 * c] = x[a][c];
}

// query-major: dQ's columns of one part. KEY: sum_j dS' k_j; RELCOL: the
// relative term through the band, by key column; RELDIST: the relative term
// by distance, dS_d E_rev
template <bool KEY, bool RELCOL, bool RELDIST>
struct DqLayout {
  static constexpr int COL_PART = ((KEY ? BT : 0) + (RELCOL ? BAND : 0)) * PW;
  static constexpr int PART = COL_PART > BT * PW ? COL_PART : BT * PW;
  static constexpr int STAGE = SCORE_FLOATS > PART ? SCORE_FLOATS : PART;
  static constexpr int FLOATS = STAGE + BT * WLD;
};

template <bool KEY, bool RELCOL, bool RELDIST>
__global__ void __launch_bounds__(NT) wide_dq_kernel(Bwd p) {
  using L = DqLayout<KEY, RELCOL, RELDIST>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Score sc(sm);
  float* ws = sm + L::STAGE;  // [BT][WLD]: dS'
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int bh = blockIdx.y, b = bh / p.H;
  const int Tn = p.Tn, D = p.D, ms = p.ms;
  const int p0 = blockIdx.z * PW, ncols = min(PW, D - p0);
  const size_t base = (size_t)bh * Tn * D;
  const float* q = static_cast<const float*>(p.q) + base;
  const float* k = static_cast<const float*>(p.k) + base;
  const float* v = static_cast<const float*>(p.v) + base;
  const float* dout = static_cast<const float*>(p.dout) + base;
  const float* e = static_cast<const float*>(p.e);
  const uint8_t* pad_b = p.pad == nullptr ? nullptr : p.pad + (size_t)b * Tn;
  float lse[4], dsum[4];
  row_stats(p, bh, i0, ty, lse, dsum);
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[a][n] = 0.f;

  if (KEY || RELCOL) {
    float* kp = sm;                          // [BT][PW]: the part's K columns
    float* ep = sm + (KEY ? BT * PW : 0);    // [BAND][PW]: the part's band E columns
    const int k_end = p.causal ? min(Tn, i0 + BT) : Tn;
    for (int j0 = 0; j0 < k_end; j0 += BT) {
      float s[4][4], ds[4][4];
      score_tile<false, true>(s, ds, sc, q, k, v, e, dout, Tn, D, ms, i0, j0, ty, tx);
      p_ds<false>(s, ds, lse, dsum, i0, j0, Tn, pad_b, p.causal, p.scale, ty, tx);
      __syncthreads();
      put_tile(ws, ds, ty, tx);
      if (KEY) stage<PW>(kp, PW, BT, k, D, Rows{j0, 1, 0, Tn}, p0, ncols);
      if (RELCOL)
        stage<PW>(ep, PW, BAND, e, D, Rows{ms - 1 - i0 + j0 + BT - 1, -1, 0, ms}, p0, ncols);
      __syncthreads();
      if (KEY) {
#pragma unroll 4
        for (int c = 0; c < BT; ++c) {
          float w[4], x[8];
#pragma unroll
          for (int a = 0; a < 4; ++a) w[a] = ws[(ty + 16 * a) * WLD + c];
#pragma unroll
          for (int n = 0; n < 8; ++n) x[n] = kp[c * PW + tx + 16 * n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[a][n] = fmaf(w[a], x[n], acc[a][n]);
        }
      }
      if (RELCOL) {
        // band row u is distance i0 - j0 - 63 + u: key column c = r + 63 - u
        for (int u = 0; u < BAND; ++u) {
          float y[8];
#pragma unroll
          for (int n = 0; n < 8; ++n) y[n] = ep[u * PW + tx + 16 * n];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int c = ty + 16 * a + BT - 1 - u;
            if (c < 0 || c >= BT) continue;
            const float w = ws[(ty + 16 * a) * WLD + c];
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[a][n] = fmaf(w, y[n], acc[a][n]);
          }
        }
      }
    }
  }
  if (RELDIST) {
    float* ep = sm;  // [BT][PW]: the part's columns of the E rows of 64 distances
    const int d_end = min(Tn, i0 + BT);  // d <= i
    for (int d0 = 0; d0 < d_end; d0 += BT) {
      float s[4][4], ds[4][4];
      score_tile<true, true>(s, ds, sc, q, k, v, e, dout, Tn, D, ms, i0, d0, ty, tx);
      p_ds<true>(s, ds, lse, dsum, i0, d0, Tn, pad_b, p.causal, p.scale, ty, tx);
      __syncthreads();
      put_tile(ws, ds, ty, tx);
      stage<PW>(ep, PW, BT, e, D, Rows{ms - 1 - d0, -1, ms - Tn, ms}, p0, ncols);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BT; ++c) {
        float w[4], x[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) w[a] = ws[(ty + 16 * a) * WLD + c];
#pragma unroll
        for (int n = 0; n < 8; ++n) x[n] = ep[c * PW + tx + 16 * n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[a][n] = fmaf(w[a], x[n], acc[a][n]);
      }
    }
  }
  float* dq = static_cast<float*>(p.dq) + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= Tn) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = tx + 16 * n;
      if (col < ncols) dq[(size_t)i * D + p0 + col] = acc[a][n];
    }
  }
}

// key-major: dK and dV's columns of one part for the keys of one tile
constexpr int DKDV_FLOATS =
    (SCORE_FLOATS > 2 * BT * PW ? SCORE_FLOATS : 2 * BT * PW) + 2 * BT * WLD;

__global__ void __launch_bounds__(NT) wide_dkdv_kernel(Bwd p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Score sc(sm);
  float* qp = sm;                   // [BT][PW]: the part's Q columns
  float* dop = sm + BT * PW;        // [BT][PW]: the part's dO columns
  float* wp = sm + (SCORE_FLOATS > 2 * BT * PW ? SCORE_FLOATS : 2 * BT * PW);  // P
  float* wd = wp + BT * WLD;        // dS'
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int j0 = blockIdx.x * BT;   // the first key tiles see the most queries
  const int bh = blockIdx.y, b = bh / p.H;
  const int Tn = p.Tn, D = p.D, ms = p.ms;
  const int p0 = blockIdx.z * PW, ncols = min(PW, D - p0);
  const size_t base = (size_t)bh * Tn * D;
  const float* q = static_cast<const float*>(p.q) + base;
  const float* k = static_cast<const float*>(p.k) + base;
  const float* v = static_cast<const float*>(p.v) + base;
  const float* dout = static_cast<const float*>(p.dout) + base;
  const float* e = static_cast<const float*>(p.e);
  const uint8_t* pad_b = p.pad == nullptr ? nullptr : p.pad + (size_t)b * Tn;
  float dk[4][8], dv[4][8];  // key rows ty + 16 a, columns tx + 16 n
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n) dk[a][n] = dv[a][n] = 0.f;
  for (int i0 = p.causal ? j0 : 0; i0 < Tn; i0 += BT) {
    float lse[4], dsum[4], s[4][4], ds[4][4];
    row_stats(p, bh, i0, ty, lse, dsum);
    score_tile<false, true>(s, ds, sc, q, k, v, e, dout, Tn, D, ms, i0, j0, ty, tx);
    p_ds<false>(s, ds, lse, dsum, i0, j0, Tn, pad_b, p.causal, p.scale, ty, tx);
    __syncthreads();
    put_tile(wp, s, ty, tx);
    put_tile(wd, ds, ty, tx);
    stage<PW>(qp, PW, BT, q, D, Rows{i0, 1, 0, Tn}, p0, ncols);
    stage<PW>(dop, PW, BT, dout, D, Rows{i0, 1, 0, Tn}, p0, ncols);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BT; ++r) {
      float pw[4], dw[4], x[8], y[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pw[a] = wp[r * WLD + ty + 16 * a];
        dw[a] = wd[r * WLD + ty + 16 * a];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        x[n] = qp[r * PW + tx + 16 * n];
        y[n] = dop[r * PW + tx + 16 * n];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          dk[a][n] = fmaf(dw[a], x[n], dk[a][n]);
          dv[a][n] = fmaf(pw[a], y[n], dv[a][n]);
        }
    }
  }
  float* dkp = static_cast<float*>(p.dk) + base;
  float* dvp = static_cast<float*>(p.dv) + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= Tn) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = tx + 16 * n;
      if (col < ncols) {
        dkp[(size_t)j * D + p0 + col] = dk[a][n];
        dvp[(size_t)j * D + p0 + col] = dv[a][n];
      }
    }
  }
}

// distance-major: dE's columns of one part for 64 distances, an f32
// partial per (b, h): de_part[bh, d, :] = sum_i dS'[i, i - d] q_i
constexpr int DE_FLOATS = (SCORE_FLOATS > BT * PW ? SCORE_FLOATS : BT * PW) + BT * WLD;

__global__ void __launch_bounds__(NT) wide_de_kernel(Bwd p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Score sc(sm);
  float* qp = sm;  // [BT][PW]: the part's Q columns
  float* wd = sm + (SCORE_FLOATS > BT * PW ? SCORE_FLOATS : BT * PW);  // dS' by distance
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d0 = blockIdx.x * BT;  // the first distance tiles see the most queries
  const int bh = blockIdx.y, b = bh / p.H;
  const int Tn = p.Tn, D = p.D, ms = p.ms;
  const int p0 = blockIdx.z * PW, ncols = min(PW, D - p0);
  const size_t base = (size_t)bh * Tn * D;
  const float* q = static_cast<const float*>(p.q) + base;
  const float* k = static_cast<const float*>(p.k) + base;
  const float* v = static_cast<const float*>(p.v) + base;
  const float* dout = static_cast<const float*>(p.dout) + base;
  const float* e = static_cast<const float*>(p.e);
  const uint8_t* pad_b = p.pad == nullptr ? nullptr : p.pad + (size_t)b * Tn;
  float de[4][8];  // distance rows ty + 16 a, columns tx + 16 n
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n) de[a][n] = 0.f;
  for (int i0 = d0; i0 < Tn; i0 += BT) {  // i >= d
    float lse[4], dsum[4], s[4][4], ds[4][4];
    row_stats(p, bh, i0, ty, lse, dsum);
    score_tile<true, true>(s, ds, sc, q, k, v, e, dout, Tn, D, ms, i0, d0, ty, tx);
    p_ds<true>(s, ds, lse, dsum, i0, d0, Tn, pad_b, p.causal, p.scale, ty, tx);
    __syncthreads();
    put_tile(wd, ds, ty, tx);
    stage<PW>(qp, PW, BT, q, D, Rows{i0, 1, 0, Tn}, p0, ncols);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float w[4], x[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) w[a] = wd[r * WLD + ty + 16 * a];
#pragma unroll
      for (int n = 0; n < 8; ++n) x[n] = qp[r * PW + tx + 16 * n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < 8; ++n) de[a][n] = fmaf(w[a], x[n], de[a][n]);
    }
  }
  float* part = p.de_part + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int d = d0 + ty + 16 * a;
    if (d >= Tn) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = tx + 16 * n;
      if (col < ncols) part[(size_t)d * D + p0 + col] = de[a][n];
    }
  }
}

// dE[m, c] = sum over (b, h), in order, of de_part[bh, max_seq - 1 - m, c]
// for the distances a sequence reaches (< T); 0 for the others
template <typename T>
__global__ void wide_de_reduce_kernel(const float* __restrict__ de_part, T* __restrict__ de,
                                      int BH, int Tn, int D, int ms) {
  const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= (size_t)ms * D) return;
  const int m = (int)(x / D), c = (int)(x - (size_t)m * D);
  const int d = ms - 1 - m;
  float acc = 0.f;
  if (d < Tn)
    for (int bh = 0; bh < BH; ++bh) acc += de_part[((size_t)bh * Tn + d) * D + c];
  de[x] = from_f<T>(acc);
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int floats, cudaStream_t s, const Bwd& p) {
  const int smem = floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool KEY, bool RELCOL, bool RELDIST>
cudaError_t launch_dq(const Bwd& p, dim3 grid, cudaStream_t s) {
  return launch(wide_dq_kernel<KEY, RELCOL, RELDIST>, grid,
                DqLayout<KEY, RELCOL, RELDIST>::FLOATS, s, p);
}

cudaError_t launch_de(const Bwd& p, dim3 grid, cudaStream_t s) {
  cudaError_t err = launch(wide_de_kernel, grid, DE_FLOATS, s, p);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)p.ms * p.D;
  wide_de_reduce_kernel<float><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      p.de_part, static_cast<float*>(p.de), p.B * p.H, p.Tn, p.D, p.ms);
  return cudaGetLastError();
}

cudaError_t bwd(const Bwd& p, int kernel, cudaStream_t s) {
  const dim3 grid((p.Tn + BT - 1) / BT, p.B * p.H, (p.D + PW - 1) / PW);
  cudaError_t err = cudaSuccess;
  const bool dkdv = kernel == 4 || kernel == 7 || kernel == 9;
  if (dkdv && (err = launch(wide_dkdv_kernel, grid, DKDV_FLOATS, s, p)) != cudaSuccess)
    return err;
  switch (kernel) {
    case 4:
    case 5: err = launch_dq<true, true, false>(p, grid, s); break;
    case 6: err = launch_dq<true, false, true>(p, grid, s); break;
    case 7: err = launch_dq<true, false, false>(p, grid, s); break;
    case 8: err = launch_dq<false, false, true>(p, grid, s); break;
    default: break;
  }
  if (err != cudaSuccess) return err;
  if (kernel == 4 || kernel == 5 || kernel == 6 || kernel == 8) err = launch_de(p, grid, s);
  return err;
}


// ---------------------------------------------------------------------------
// bf16: the same sweeps with every product on the tensor cores
// ---------------------------------------------------------------------------
//
// The score side's chunks (64 columns of d_head) and the output side's
// parts land in shared memory as bf16; a warp computes a 16-row slice of
// each product with mma.sync m16n8k16 (f32 sums): S and the band (64 x
// 128: the 127 distances, or keys, a tile pair reaches) by chunk, then
// through an f32 tile in shared memory into the CUDA-core kernels' 4 x 4
// thread layout, where the skew, the masks, the softmax and dS' run as
// above; P and dS' are rounded to bf16 (as the TPU kernels cast them) into
// the output products' A operand, row-major, transposed (dK, dV, dE) or
// skewed by band row (dQ's relative term by key column).

namespace tc {

using bf = __nv_bfloat16;

constexpr int KT = 64;          // d_head columns a score chunk stages
constexpr int LS = KT + 8;      // bf16 row stride over 64 columns: conflict-free fragments
constexpr int LB = 2 * BT + 8;  // bf16 row stride over 128 columns
constexpr int LF = 2 * BT + 1;  // f32 row stride of a band tile

// shared memory, byte offsets
constexpr int STG = 0;  // bf16 chunks (Q, X, dO: 64 rows; Y, V: 128), then the output parts
constexpr int TS = STG + (3 * BT + 2 * 2 * BT) * LS * 2;  // f32 S [64][WLD]
constexpr int TR = TS + BT * WLD * 4;                     // f32 band [64][LF]
constexpr int TP = TR + BT * LF * 4;                      // f32 dP [64][WLD] or its band [64][LF]
constexpr int WB = TP + BT * LF * 4;                      // bf16 [64][LS]: P or dS'
constexpr int WT = WB + BT * LS * 2;                      // bf16 [64][LS]: dS' transposed
constexpr int PT = WT + BT * LS * 2;                      // bf16 [64][LS]: P transposed
constexpr int AP = PT + BT * LS * 2;                      // bf16 [64][LB]: dS' by band row
constexpr int ROWS = AP + BT * LB * 2;                    // f32 [3][64]: alpha, l, m
constexpr int BYTES = ROWS + 3 * BT * 4;
static_assert(BYTES <= 232448, "a block's shared memory");
static_assert(2 * PW * LS <= (3 * BT + 4 * BT) * LS && PW * (LS + LB) <= (3 * BT + 4 * BT) * LS,
              "the output parts fit the chunks' place");

__device__ __forceinline__ uint32_t ld32(const bf* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[j] += A[m0 .. m0 + 15][0, K) B[n0 + 8 j .. n0 + 8 j + 7][0, K)^T, j < NJ:
// A and B k-contiguous bf16 rows of strides lda and ldb; acc in mma.sync's
// C layout (lane: rows m0 + lane / 4 and + 8, columns 2 (lane % 4) and + 1)
template <int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4], const bf* A, int lda, const bf* B,
                                         int ldb, int K, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf* a = A + (m0 + g) * lda + k0 + 2 * t;
    const uint32_t a0 = ld32(a), a1 = ld32(a + 8 * lda), a2 = ld32(a + 8), a3 = ld32(a + 8 * lda + 8);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf* b = B + (n0 + 8 * j + g) * ldb + k0 + 2 * t;
      mma16816(acc[j], a0, a1, a2, a3, ld32(b), ld32(b + 8));
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc (C layout, rows m0.., columns n0..) into an f32 tile of row stride ld
template <int NJ>
__device__ __forceinline__ void put_acc(float* dst, int ld, const float (&acc)[NJ][4], int m0,
                                        int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float* d = dst + (m0 + g) * ld + n0 + 8 * j + 2 * t;
    d[0] = acc[j][0];
    d[1] = acc[j][1];
    d[8 * ld] = acc[j][2];
    d[8 * ld + 1] = acc[j][3];
  }
}

// n rows of WIDTH bf16 columns (col0.. of rows D wide) into dst[u * ld + k],
// 16 bytes a copy; zeros outside the rows' [lo, hi) and past ncols
template <int WIDTH>
__device__ __forceinline__ void stage_rows(bf* dst, int ld, int n, const bf* __restrict__ src,
                                           int D, Rows m, int col0, int ncols) {
  constexpr int V = WIDTH / 8;
  for (int x = threadIdx.x; x < n * V; x += NT) {
    const int u = x / V, k = (x - u * V) * 8;
    const int row = m.first + m.step * u;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row >= m.lo && row < m.hi && k < ncols)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * D + col0 + k);
    *reinterpret_cast<uint4*>(dst + u * ld + k) = val;
  }
}

// the same, transposed: dst[k * ld + u], the k-contiguous B operand of a
// product that sums over the n rows; 16 bytes a load, 8 stores, neighbour
// threads on neighbour rows so the stores do not share a bank
template <int WIDTH>
__device__ __forceinline__ void stage_cols(bf* dst, int ld, int n, const bf* __restrict__ src,
                                           int D, Rows m, int col0, int ncols) {
  constexpr int V = WIDTH / 8;
  for (int x = threadIdx.x; x < n * V; x += NT) {
    const int k = (x / n) * 8, u = x - (k / 8) * n;
    const int row = m.first + m.step * u;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row >= m.lo && row < m.hi && k < ncols)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * D + col0 + k);
    const bf* h = reinterpret_cast<const bf*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(k + i) * ld + u] = h[i];
  }
}

// score_tile's contract on the tensor cores: the raw sums q.(k + E) and,
// with DP, dO.v, in the 4 x 4 thread layout (r = ty + 16 a, c = tx + 16 b)
template <bool DIST, bool DP>
__device__ __forceinline__ void score_tile(float (&s)[4][4], float (&dp)[4][4], char* sm,
                                           const bf* q, const bf* k, const bf* v, const bf* e,
                                           const bf* dout, int Tn, int D, int ms, int i0,
                                           int t0) {
  bf* A = reinterpret_cast<bf*>(sm + STG);
  bf* X = A + BT * LS;
  bf* A2 = X + BT * LS;
  bf* Y = A2 + BT * LS;
  bf* B2 = Y + 2 * BT * LS;
  float* S = reinterpret_cast<float*>(sm + TS);
  float* R = reinterpret_cast<float*>(sm + TR);
  float* P2 = reinterpret_cast<float*>(sm + TP);
  const int warp = threadIdx.x >> 5, m0 = 16 * (warp & 3), half = warp >> 2;
  constexpr int NP = DIST ? 8 : 4;  // dP: by distance the 128-row band, else 64 keys
  float as[4][4], ar[8][4], ap[NP][4];
  zero(as);
  zero(ar);
  zero(ap);
  const Rows qrows{i0, 1, 0, Tn};
  const Rows band_e{ms - 1 - i0 + t0 + BT - 1, -1, 0, ms};  // E row of distance i0 - t0 - 63 + u
  const Rows tile_e{ms - 1 - t0, -1, ms - Tn, ms};         // E row of distance t0 + c < T
  const Rows tile_k{t0, 1, 0, Tn};
  const Rows band_k{i0 - t0 - (BT - 1), 1, 0, Tn};          // key i0 - t0 - 63 + u
  for (int kc = 0; kc < D; kc += KT) {
    __syncthreads();  // every warp is done with the previous chunk or the output parts
    stage_rows<KT>(A, LS, BT, q, D, qrows, kc, KT);
    stage_rows<KT>(X, LS, BT, DIST ? e : k, D, DIST ? tile_e : tile_k, kc, KT);
    stage_rows<KT>(Y, LS, 2 * BT, DIST ? k : e, D, DIST ? band_k : band_e, kc, KT);
    if (DP) {
      stage_rows<KT>(A2, LS, BT, dout, D, qrows, kc, KT);
      stage_rows<KT>(B2, LS, DIST ? 2 * BT : BT, v, D, DIST ? band_k : tile_k, kc, KT);
    }
    __syncthreads();
    mma_rows<4>(as, A, LS, X, LS, KT, m0, 32 * half);
    mma_rows<8>(ar, A, LS, Y, LS, KT, m0, 64 * half);
    if (DP) mma_rows<NP>(ap, A2, LS, B2, LS, KT, m0, 8 * NP * half);
  }
  put_acc(S, WLD, as, m0, 32 * half);
  put_acc(R, LF, ar, m0, 64 * half);
  if (DP) put_acc(P2, DIST ? LF : WLD, ap, m0, 8 * NP * half);
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = ty + 16 * a, c = tx + 16 * b, u = r - c + BT - 1;
      s[a][b] = S[r * WLD + c] + R[r * LF + u];
      dp[a][b] = DP ? (DIST ? P2[r * LF + u] : P2[r * WLD + c]) : 0.f;
    }
}

// a 4 x 4 thread tile of P or dS' in bf16: row-major into wb, transposed
// into wt, by band row into ap (ap[r][r - c + 63]; the row's other 64
// entries zeroed), where given
__device__ __forceinline__ void put_w(bf* wb, bf* wt, bf* ap, const float (&x)[4][4], int ty,
                                      int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = ty + 16 * a, c = tx + 16 * b;
      const bf val = __float2bfloat16(x[a][b]);
      if (wb != nullptr) wb[r * LS + c] = val;
      if (wt != nullptr) wt[c * LS + r] = val;
      if (ap != nullptr) {
        ap[r * LB + r - c + BT - 1] = val;
        ap[r * LB + ((r - c + 2 * BT - 1) & (2 * BT - 1))] = __float2bfloat16(0.f);
      }
    }
}

// acc (C layout, tile rows m0.., part columns n0..) times scale[row] into
// rows row0 + r < nrows of dst (row stride D, the part's columns from p0)
template <typename O>
__device__ __forceinline__ void store_acc(O* dst, int D, int p0, int ncols, int row0, int nrows,
                                          const float (&acc)[8][4], int m0, int n0,
                                          const float* scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + g + 8 * h;
    if (row0 + r >= nrows) continue;
    const float sc = scale == nullptr ? 1.f : scale[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= ncols) continue;
      O* d = dst + (size_t)(row0 + r) * D + p0 + col;
      const float x0 = acc[j][2 * h] * sc, x1 = acc[j][2 * h + 1] * sc;
      if constexpr (sizeof(O) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(x0, x1);
      } else {
        d[0] = x0;
        d[1] = x1;
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
wide_fwd_tc_kernel(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v,
           const bf* __restrict__ e, const uint8_t* __restrict__ pad, bf* __restrict__ o,
           float* __restrict__ lse, int H, int Tn, int D, int ms, int causal, float scale) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  bf* pb = reinterpret_cast<bf*>(sm + WB);
  bf* vt = reinterpret_cast<bf*>(sm + STG);  // [PW][LS]: the part's V columns by key
  float* alpha_s = reinterpret_cast<float*>(sm + ROWS);
  float* inv_s = alpha_s + BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, warp = tid >> 5;
  const int m0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BT;  // heaviest query tile first
  const int bh = blockIdx.y, b = bh / H;
  const int p0 = blockIdx.z * PW, ncols = min(PW, D - p0);
  const size_t base = (size_t)bh * Tn * D;
  const uint8_t* pad_b = pad == nullptr ? nullptr : pad + (size_t)b * Tn;

  float acc[8][4], m[4], l[4];
  zero(acc);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  const int k_end = causal ? min(Tn, i0 + BT) : Tn;
  for (int j0 = 0; j0 < k_end; j0 += BT) {
    float s[4][4], unused[4][4];
    score_tile<false, false>(s, unused, sm, q + base, k + base, v + base, e, q + base, Tn, D, ms,
                             i0, j0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = visible_col(i, j0 + tx + 16 * c, Tn, pad_b, causal) ? s[a][c] * scale
                                                                      : -INFINITY;
        rmax = fmaxf(rmax, s[a][c]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(rmax));
      const bool none = m_new == -INFINITY;  // no key of this row seen yet
      const float alpha = none ? 1.f : expf(m[a] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = none ? 0.f : expf(s[a][c] - m_new);
        rsum += s[a][c];
      }
      l[a] = l[a] * alpha + half_warp_sum(rsum);
      m[a] = m_new;
      if (tx == 0) alpha_s[ty + 16 * a] = alpha;
    }
    put_w(pb, nullptr, nullptr, s, ty, tx);
    stage_cols<PW>(vt, LS, BT, v + base, D, Rows{j0, 1, 0, Tn}, p0, ncols);
    __syncthreads();
    const float al0 = alpha_s[m0 + (tid & 31) / 4], al1 = alpha_s[m0 + (tid & 31) / 4 + 8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    mma_rows<8>(acc, pb, LS, vt, LS, BT, m0, n0);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (tx == 0) inv_s[ty + 16 * a] = l[a] > 0.f ? 1.f / l[a] : 0.f;
    if (blockIdx.z == 0 && tx == 0 && i < Tn)
      lse[(size_t)bh * Tn + i] = l[a] > 0.f ? m[a] + logf(l[a]) : 1e30f;
  }
  __syncthreads();
  store_acc(o + base, D, p0, ncols, i0, Tn, acc, m0, n0, inv_s);
}

template <bool KEY, bool RELCOL, bool RELDIST>
__global__ void __launch_bounds__(NT) wide_dq_tc_kernel(Bwd p) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  bf* wb = reinterpret_cast<bf*>(sm + WB);
  bf* ap = reinterpret_cast<bf*>(sm + AP);
  bf* part = reinterpret_cast<bf*>(sm + STG);  // the output parts, by part column
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, warp = tid >> 5;
  const int m0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int bh = blockIdx.y, b = bh / p.H;
  const int Tn = p.Tn, D = p.D, ms = p.ms;
  const int p0 = blockIdx.z * PW, ncols = min(PW, D - p0);
  const size_t base = (size_t)bh * Tn * D;
  const bf* q = static_cast<const bf*>(p.q) + base;
  const bf* k = static_cast<const bf*>(p.k) + base;
  const bf* v = static_cast<const bf*>(p.v) + base;
  const bf* dout = static_cast<const bf*>(p.dout) + base;
  const bf* e = static_cast<const bf*>(p.e);
  const uint8_t* pad_b = p.pad == nullptr ? nullptr : p.pad + (size_t)b * Tn;
  float lse[4], dsum[4];
  row_stats(p, bh, i0, ty, lse, dsum);
  float acc[8][4];
  zero(acc);
  if (KEY || RELCOL) {
    bf* kt = part;                           // [PW][LS]: K's part columns by key
    bf* et = part + (KEY ? PW * LS : 0);     // [PW][LB]: E's part columns by band row
    const int k_end = p.causal ? min(Tn, i0 + BT) : Tn;
    for (int j0 = 0; j0 < k_end; j0 += BT) {
      float s[4][4], ds[4][4];
      score_tile<false, true>(s, ds, sm, q, k, v, e, dout, Tn, D, ms, i0, j0);
      p_ds<false>(s, ds, lse, dsum, i0, j0, Tn, pad_b, p.causal, p.scale, ty, tx);
      put_w(KEY ? wb : nullptr, nullptr, RELCOL ? ap : nullptr, ds, ty, tx);
      if (KEY) stage_cols<PW>(kt, LS, BT, k, D, Rows{j0, 1, 0, Tn}, p0, ncols);
      if (RELCOL)
        stage_cols<PW>(et, LB, 2 * BT, e, D, Rows{ms - 1 - i0 + j0 + BT - 1, -1, 0, ms}, p0,
                       ncols);
      __syncthreads();
      if (KEY) mma_rows<8>(acc, wb, LS, kt, LS, BT, m0, n0);
      if (RELCOL) mma_rows<8>(acc, ap, LB, et, LB, 2 * BT, m0, n0);
    }
  }
  if (RELDIST) {
    bf* et = part;  // [PW][LS]: the part columns of the E rows of 64 distances
    const int d_end = min(Tn, i0 + BT);
    for (int d0 = 0; d0 < d_end; d0 += BT) {
      float s[4][4], ds[4][4];
      score_tile<true, true>(s, ds, sm, q, k, v, e, dout, Tn, D, ms, i0, d0);
      p_ds<true>(s, ds, lse, dsum, i0, d0, Tn, pad_b, p.causal, p.scale, ty, tx);
      put_w(wb, nullptr, nullptr, ds, ty, tx);
      stage_cols<PW>(et, LS, BT, e, D, Rows{ms - 1 - d0, -1, ms - Tn, ms}, p0, ncols);
      __syncthreads();
      mma_rows<8>(acc, wb, LS, et, LS, BT, m0, n0);
    }
  }
  store_acc(static_cast<bf*>(p.dq) + base, D, p0, ncols, i0, Tn, acc, m0, n0, nullptr);
}

__global__ void __launch_bounds__(NT) wide_dkdv_tc_kernel(Bwd p) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  bf* wt = reinterpret_cast<bf*>(sm + WT);
  bf* pt = reinterpret_cast<bf*>(sm + PT);
  bf* qt = reinterpret_cast<bf*>(sm + STG);  // [PW][LS]: Q's part columns by query
  bf* dot = qt + PW * LS;                    // [PW][LS]: dO's
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, warp = tid >> 5;
  const int m0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  const int j0 = blockIdx.x * BT;  // the first key tiles see the most queries
  const int bh = blockIdx.y, b = bh / p.H;
  const int Tn = p.Tn, D = p.D, ms = p.ms;
  const int p0 = blockIdx.z * PW, ncols = min(PW, D - p0);
  const size_t base = (size_t)bh * Tn * D;
  const bf* q = static_cast<const bf*>(p.q) + base;
  const bf* k = static_cast<const bf*>(p.k) + base;
  const bf* v = static_cast<const bf*>(p.v) + base;
  const bf* dout = static_cast<const bf*>(p.dout) + base;
  const bf* e = static_cast<const bf*>(p.e);
  const uint8_t* pad_b = p.pad == nullptr ? nullptr : p.pad + (size_t)b * Tn;
  float dk[8][4], dv[8][4];  // key rows m0.., part columns n0..
  zero(dk);
  zero(dv);
  for (int i0 = p.causal ? j0 : 0; i0 < Tn; i0 += BT) {
    float lse[4], dsum[4], s[4][4], ds[4][4];
    row_stats(p, bh, i0, ty, lse, dsum);
    score_tile<false, true>(s, ds, sm, q, k, v, e, dout, Tn, D, ms, i0, j0);
    p_ds<false>(s, ds, lse, dsum, i0, j0, Tn, pad_b, p.causal, p.scale, ty, tx);
    put_w(nullptr, wt, nullptr, ds, ty, tx);
    put_w(nullptr, pt, nullptr, s, ty, tx);
    stage_cols<PW>(qt, LS, BT, q, D, Rows{i0, 1, 0, Tn}, p0, ncols);
    stage_cols<PW>(dot, LS, BT, dout, D, Rows{i0, 1, 0, Tn}, p0, ncols);
    __syncthreads();
    mma_rows<8>(dk, wt, LS, qt, LS, BT, m0, n0);
    mma_rows<8>(dv, pt, LS, dot, LS, BT, m0, n0);
  }
  store_acc(static_cast<bf*>(p.dk) + base, D, p0, ncols, j0, Tn, dk, m0, n0, nullptr);
  store_acc(static_cast<bf*>(p.dv) + base, D, p0, ncols, j0, Tn, dv, m0, n0, nullptr);
}

__global__ void __launch_bounds__(NT) wide_de_tc_kernel(Bwd p) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  bf* wt = reinterpret_cast<bf*>(sm + WT);
  bf* qt = reinterpret_cast<bf*>(sm + STG);  // [PW][LS]: Q's part columns by query
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, warp = tid >> 5;
  const int m0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  const int d0 = blockIdx.x * BT;  // the first distance tiles see the most queries
  const int bh = blockIdx.y, b = bh / p.H;
  const int Tn = p.Tn, D = p.D, ms = p.ms;
  const int p0 = blockIdx.z * PW, ncols = min(PW, D - p0);
  const size_t base = (size_t)bh * Tn * D;
  const bf* q = static_cast<const bf*>(p.q) + base;
  const bf* k = static_cast<const bf*>(p.k) + base;
  const bf* v = static_cast<const bf*>(p.v) + base;
  const bf* dout = static_cast<const bf*>(p.dout) + base;
  const bf* e = static_cast<const bf*>(p.e);
  const uint8_t* pad_b = p.pad == nullptr ? nullptr : p.pad + (size_t)b * Tn;
  float de[8][4];  // distance rows m0.., part columns n0..
  zero(de);
  for (int i0 = d0; i0 < Tn; i0 += BT) {  // i >= d
    float lse[4], dsum[4], s[4][4], ds[4][4];
    row_stats(p, bh, i0, ty, lse, dsum);
    score_tile<true, true>(s, ds, sm, q, k, v, e, dout, Tn, D, ms, i0, d0);
    p_ds<true>(s, ds, lse, dsum, i0, d0, Tn, pad_b, p.causal, p.scale, ty, tx);
    put_w(nullptr, wt, nullptr, ds, ty, tx);
    stage_cols<PW>(qt, LS, BT, q, D, Rows{i0, 1, 0, Tn}, p0, ncols);
    __syncthreads();
    mma_rows<8>(de, wt, LS, qt, LS, BT, m0, n0);
  }
  store_acc(p.de_part + base, D, p0, ncols, d0, Tn, de, m0, n0, nullptr);
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, cudaStream_t s, const Bwd& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, BYTES, s>>>(p);
  return cudaGetLastError();
}

cudaError_t bwd(const Bwd& p, int kernel, cudaStream_t s) {
  const dim3 grid((p.Tn + BT - 1) / BT, p.B * p.H, (p.D + PW - 1) / PW);
  cudaError_t err = cudaSuccess;
  const bool dkdv = kernel == 4 || kernel == 7 || kernel == 9;
  if (dkdv && (err = launch(wide_dkdv_tc_kernel, grid, s, p)) != cudaSuccess) return err;
  switch (kernel) {
    case 4:
    case 5: err = launch(wide_dq_tc_kernel<true, true, false>, grid, s, p); break;
    case 6: err = launch(wide_dq_tc_kernel<true, false, true>, grid, s, p); break;
    case 7: err = launch(wide_dq_tc_kernel<true, false, false>, grid, s, p); break;
    case 8: err = launch(wide_dq_tc_kernel<false, false, true>, grid, s, p); break;
    default: break;
  }
  if (err != cudaSuccess) return err;
  if (kernel == 4 || kernel == 5 || kernel == 6 || kernel == 8) {
    if ((err = launch(wide_de_tc_kernel, grid, s, p)) != cudaSuccess) return err;
    const size_t n = (size_t)p.ms * p.D;
    wide_de_reduce_kernel<bf><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        p.de_part, static_cast<bf*>(p.de), p.B * p.H, p.Tn, p.D, p.ms);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace tc


// ---------------------------------------------------------------------------
// bf16 forward (kernel 1) on wgmma: a thread-block cluster per query tile
// ---------------------------------------------------------------------------
//
// tc::wide_fwd_tc_kernel recomputes the score side in each of its d_head /
// 128 blocks of a query tile. Here the CTAs of one cluster share that work:
// CTA r (of np = d_head / 128, the cluster) owns d_head columns
// 128 r .. 128 r + 127 and copies only those columns of Q, K, V and the E
// band (TMA boxes of 8 slabs in the 32-byte-swizzled slab layout of
// hopper_sm90.cuh, K and V in a two-stage ring, the band's 64-row chunks in
// a ring of three, under mbarriers, one producer warp). Per key tile its
// warpgroup computes, as kernel 1 does at d_head 128, the partial scores
// S_r = Q_r K_r^T (m64n64) and the band Q_r E_band,r^T (two m64n64) by
// wgmma over its 8 k16 steps, skews the band through a per-warp scratch
// and publishes S_r + Srel_r (64 x 64 f32) in its shared memory, double
// buffered. Each consumer warp then signals warp w of every CTA (an
// mbarrier a warp and buffer, arrived on from each rank with release at
// cluster scope), waits for its own, and reads its 16 rows of every rank's
// partial through distributed shared memory, summing them in rank order:
// every CTA holds bitwise the same scores, so the same m, l and P, with no
// atomics. It then runs the online softmax as kernel 1 does and O_r += P
// V_r (m64n128, P from registers) for its own columns; rank 0 writes lse.
// One signal a tile suffices: warp w writes buffer kt % 2 again at tile kt
// + 2 only after its signal of tile kt + 1 has come from every rank, which
// each sends after reading tile kt.
//
// The remote reads are most of what the exchange costs, (np - 1) x 16 KB
// a CTA and tile through distributed shared memory, whose rate is low
// beside local shared memory (scripts/torch_wide_fwd_ablation.py times
// the kernel without them; PERF.md). From SCATTER_PARTS parts on the sum
// is a reduce-scatter and an all-gather instead: rank n np / 8 alone sums
// column group n (8 keys) in rank order and publishes it, and a second
// signal lets the others read it: about 2 x 16 KB a CTA and tile, and
// bitwise the same sums. Below that the second signal costs more than the
// reads it saves.
//
// Clusters up to 8 CTAs are portable; 9 to 16 (d_head 1152 to 2048) are
// launched with cudaFuncAttributeNonPortableClusterSizeAllowed, which the
// H100 takes. Past 16 parts the bf16 forward stays on tc::wide_fwd_tc_kernel.

namespace cl {

using namespace sm90;
using bf = __nv_bfloat16;

constexpr int BQ = 64;               // query rows per CTA: one warpgroup's wgmma tile
constexpr int BK = 64;               // keys per tile
constexpr int EB = BQ + BK;          // band rows staged per key tile (the first one unused)
constexpr int PW = 128;              // d_head columns a CTA owns
constexpr int KS = PW / 16;          // k16 steps (and slabs) over a part
constexpr int NCW = 4;               // consumer warps: one warpgroup
constexpr int NTH = 32 * (NCW + 1);  // + the producer warp
constexpr int WB = 80;               // band columns a warp reads: its rows' 79 distances
constexpr int WBS = WB + 8;          // row stride of a warp's band scratch (floats)
constexpr int NST = 2;               // K, V ring stages
constexpr int NE = NST + 1;          // the E ring, in chunks of 64 rows
constexpr int MAX_PARTS = 16;        // the largest cluster the H100 takes
constexpr int SCATTER_PARTS = 5;     // from this many parts: reduce-scatter, then all-gather
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int TILE = BQ * PW * 2;           // a 64-row bf16 tile of a part, in slabs
constexpr int STAGE = 2 * TILE;             // K, V
constexpr int ST_AT = TILE;                 // Q first
constexpr int E_AT = ST_AT + NST * STAGE;
constexpr int SCR_AT = E_AT + NE * TILE;
constexpr int XB = NCW * 32 * (BK / 8) * 16;  // a tile's partial scores: float4 [8][128 threads]
constexpr int X_AT = SCR_AT + NCW * 16 * WBS * 4;
constexpr int Y_AT = X_AT + 2 * XB;    // the summed groups a rank owns, as X
constexpr int BAR_AT = Y_AT + 2 * XB;
constexpr int TOTAL = BAR_AT + 8 * (2 * NST + 1 + 4 * NCW) + 1024;  // + room to align to 1024
static_assert(TILE % 1024 == 0 && XB % 1024 == 0, "slabs stay 1024-byte aligned");
static_assert(TOTAL <= 232448, "a CTA's shared memory");

struct Maps {
  CUtensorMap q, k, v, e;  // q, k, v: [B*H][T][dh], e: [max_seq][dh], in slabs, 8 a box
};

// ---- clusters: distributed shared memory and cluster-scope mbarriers
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// every thread of every CTA of the cluster: release, then acquire
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}
// the address of a shared-memory location in CTA `rank`'s copy
__device__ __forceinline__ uint32_t peer(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// mbar_wait with acquire at cluster scope: the arrivals came from other CTAs
__device__ __forceinline__ void wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " .reg .u32 n;\n"
      " mov.u32 n, 0;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " add.u32 n, n, 1;\n"
      " setp.ge.u32 p, n, 67108864;\n"
      " @p trap;\n"
      " bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ float4 ld_peer(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// One cluster per (query tile, b h), the heaviest query tiles first (grid
// (np, B * H, query tiles)); CTA `rank` computes O's columns 128 rank ..
// 128 rank + 127. Warp 4 is the producer, warps 0-3 the consumer
// warpgroup, warp w owning rows 16 w .. 16 w + 15 of every accumulator, as
// in flash_rel_attn_fwd.cu's tc::flash_fwd_tc_kernel.
__global__ void __launch_bounds__(NTH, 1)
wide_fwd_tc_cluster_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ pad,
                           bf* __restrict__ o, float* __restrict__ lse, int H, int T_len, int D,
                           int max_seq, int causal, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_AT);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;
  uint64_t* xbar = qbar + 1;  // [2][NCW]: warp w's rows of buffer kt % 2 published by every rank
  uint64_t* ybar = xbar + 2 * NCW;  // [2][NCW]: the same for the summed groups
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int g = lane >> 2, t = lane & 3;
  const int rank = cluster_rank(), np = cluster_size();
  const int c2 = rank * KS;  // the part's first slab

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tile first
  const int bh = blockIdx.y, b = bh / H;
  const int k_end = causal ? min(T_len, q0 + BQ) : T_len;
  const int n_kt = (k_end + BK - 1) / BK;
  auto stage = [&](int s) { return ST_AT + s * STAGE; };  // K, then V
  auto chunk = [&](int c) { return E_AT + (c % NE) * TILE; };
  // E chunk c: rows from e0 + 64 c (see tc::flash_fwd_tc_kernel)
  const int e0 = max_seq - EB - (q0 - (BK - 1));

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    mbar_init(qbar, 1);
    for (int x = 0; x < 4 * NCW; ++x) mbar_init(&xbar[x], np);
    mbar_init_fence();
  }
  cluster_sync();  // every rank's barriers exist before any rank arrives on them

  if (warp == NCW) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(qbar, TILE);
      tma_load(smem, &maps.q, 0, q0, c2, bh, qbar);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NST, k0 = kt * BK;
        if (kt >= NST) mbar_wait(&empty[s], (kt / NST - 1) & 1);
        // K, V and the band's new chunk (both chunks for the first tile)
        mbar_expect_tx(&full[s], (kt == 0 ? 4 : 3) * TILE);
        unsigned char* st = smem + stage(s);
        tma_load(st, &maps.k, 0, k0, c2, bh, &full[s]);
        tma_load(st + TILE, &maps.v, 0, k0, c2, bh, &full[s]);
        if (kt == 0) tma_load(smem + chunk(0), &maps.e, 0, e0, c2, 0, &full[s]);
        tma_load(smem + chunk(kt + 1), &maps.e, 0, e0 + 64 * (kt + 1), c2, 0, &full[s]);
      }
    }
    __syncwarp();
  } else {
    float* scr = reinterpret_cast<float*>(smem + SCR_AT) + warp * 16 * WBS;
    const int ub = 16 * warp;  // the warp's first row
    float oacc[PW / 2];
#pragma unroll
    for (int x = 0; x < PW / 2; ++x) oacc[x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (log2 units)
    mbar_wait(qbar, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % NST, k0 = kt * BK, xb = kt & 1;
      uint32_t live[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = k0 + 32 * hf + lane;
        live[hf] = __ballot_sync(0xffffffffu,
                                 key < T_len && !(pad != nullptr && pad[(size_t)b * T_len + key]));
      }
      const bool masked = (causal && k0 + BK - 1 > q0 + ub) || (live[0] & live[1]) != 0xffffffffu;
      const uint32_t st = base + stage(s);
      mbar_wait(&full[s], (kt / NST) & 1);

      // the part's S_r = Q_r K_r^T and band Q_r E_band,r^T
      float sacc[BK / 2], bacc[2][BK / 2];
      const uint32_t c_lo = base + chunk(kt), c_hi = base + chunk(kt + 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t da = desc_k(base + kk * TILE / KS);
        mma_ss<BK, 0, 0>(sacc, da, desc_k(st + kk * TILE / KS), kk > 0);
        mma_ss<BK, 0, 0>(bacc[0], da, desc_k(c_lo + kk * TILE / KS), kk > 0);
        mma_ss<BK, 0, 0>(bacc[1], da, desc_k(c_hi + kk * TILE / KS), kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs<BK / 2>(sacc);
      fence_regs<BK / 2>(bacc[0]);
      fence_regs<BK / 2>(bacc[1]);

      // the skew, as kernel 1's: row r, key j reads scratch column 16 - r + j
#pragma unroll
      for (int c = 0; c < EB / 8; ++c) {
        const int cc = c - (6 - 2 * warp);
        if (cc >= 0 && cc < WB / 8) {
          const float* bc = bacc[c / 8] + 4 * (c % 8);
          *reinterpret_cast<float2*>(scr + g * WBS + 8 * cc + 2 * t) = make_float2(bc[0], bc[1]);
          *reinterpret_cast<float2*>(scr + (g + 8) * WBS + 8 * cc + 2 * t) =
              make_float2(bc[2], bc[3]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = g + 8 * (x >> 1), j = 8 * n + 2 * t + (x & 1);
          sacc[4 * n + x] += scr[r * WBS + 16 - r + j];
        }
      __syncwarp();  // the scratch is read before the next tile writes it

      // publish S_r + Srel_r, signal warp w of every rank, sum in rank order
      const uint32_t xmine = base + X_AT + xb * XB + tid * 16;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        *reinterpret_cast<float4*>(smem + X_AT + xb * XB + (n * NCW * 32 + tid) * 16) =
            make_float4(sacc[4 * n], sacc[4 * n + 1], sacc[4 * n + 2], sacc[4 * n + 3]);
      __syncwarp();
      uint64_t* xw = xbar + xb * NCW + warp;
      if (lane < np) arrive_peer(peer(smem_u32(xw), lane));
      wait_cluster(xw, (kt >> 1) & 1);
      float tot[BK / 2];  // the whole score, summed over the ranks in rank order
      if (np < SCATTER_PARTS) {  // every rank sums every column group
        for (int r = 0; r < np; ++r) {
          float4 v[BK / 8];
          if (r == rank) {
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
              v[n] = make_float4(sacc[4 * n], sacc[4 * n + 1], sacc[4 * n + 2], sacc[4 * n + 3]);
          } else {
            const uint32_t at = peer(xmine, r);
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) v[n] = ld_peer(at + n * NCW * 32 * 16);
          }
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            const float* w4 = reinterpret_cast<const float*>(&v[n]);
#pragma unroll
            for (int x = 0; x < 4; ++x) tot[4 * n + x] = r == 0 ? w4[x] : tot[4 * n + x] + w4[x];
          }
        }
      } else {
        // column group n (8 keys) is summed by rank owner(n) = n np / 8 alone,
        // in rank order, published as Y, and read from there by the others:
        // (np - 1) x 16 KB of remote reads a tile become about 2 x 16 KB
        const uint32_t ymine = xmine - X_AT + Y_AT;
        for (int r = 0; r < np; ++r) {
          float4 v[BK / 8];
          const uint32_t at = peer(xmine, r);
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            if (((n * np) >> 3) != rank) continue;
            v[n] = r == rank ? make_float4(sacc[4 * n], sacc[4 * n + 1], sacc[4 * n + 2],
                                           sacc[4 * n + 3])
                             : ld_peer(at + n * NCW * 32 * 16);
          }
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            if (((n * np) >> 3) != rank) continue;
            const float* w4 = reinterpret_cast<const float*>(&v[n]);
#pragma unroll
            for (int x = 0; x < 4; ++x) tot[4 * n + x] = r == 0 ? w4[x] : tot[4 * n + x] + w4[x];
          }
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          if (((n * np) >> 3) == rank)
            *reinterpret_cast<float4*>(smem + Y_AT + xb * XB + (n * NCW * 32 + tid) * 16) =
                make_float4(tot[4 * n], tot[4 * n + 1], tot[4 * n + 2], tot[4 * n + 3]);
        __syncwarp();
        uint64_t* yw = ybar + xb * NCW + warp;
        if (lane < np) arrive_peer(peer(smem_u32(yw), lane));
        wait_cluster(yw, (kt >> 1) & 1);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const int owner = (n * np) >> 3;
          if (owner == rank) continue;
          const float4 v = ld_peer(peer(ymine, owner) + n * NCW * 32 * 16);
          tot[4 * n] = v.x;
          tot[4 * n + 1] = v.y;
          tot[4 * n + 2] = v.z;
          tot[4 * n + 3] = v.w;
        }
      }

      // from here on kernel 1's tile step: masks, the online softmax, O += P V
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = g + 8 * (x >> 1), j = 8 * n + 2 * t + (x & 1);
          const int i = q0 + ub + r;
          float sc = tot[4 * n + x] * scale_log2;
          if (masked && (!((live[j >> 5] >> (j & 31)) & 1) || (causal && k0 + j > i)))
            sc = -INFINITY;
          sacc[4 * n + x] = sc;
          mx[x >> 1] = fmaxf(mx[x >> 1], sc);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      }
      float mu[2], alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mu[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];  // a row with no visible key yet
        alpha[hh] = exp2f(m[hh] - mu[hh]);
        m[hh] = mx[hh];
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int x = 0; x < PW / 2; ++x) oacc[x] *= alpha[(x >> 1) & 1];
      uint32_t pa[BK / 16][4];  // P as bf16 A fragments, one set per k16 step
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        float p[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          p[x] = exp2f(sacc[4 * n + x] - mu[x >> 1]);
          l[x >> 1] += p[x];
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      // O_r += P V_r: V [keys][128] read MN-major (a k16 step is 16 key rows)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<PW, 1>(oacc, pa[kk], desc_mn(st + TILE + kk * 512, TILE / KS));
      wg_commit();
      wg_wait0();
      fence_regs<PW / 2>(oacc);
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    const size_t obase = (size_t)bh * T_len * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = q0 + ub + g + 8 * hh;
      if (i >= T_len) continue;
      const bool any = l[hh] > 0.f;
      const float inv = any ? 1.f / l[hh] : 0.f;
      bf* orow = o + obase + (size_t)i * D + rank * PW;
#pragma unroll
      for (int c = 0; c < PW / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t) =
            pack_bf16(oacc[4 * c + 2 * hh] * inv, oacc[4 * c + 2 * hh + 1] * inv);
      if (t == 0 && rank == 0)
        lse[(size_t)bh * T_len + i] = any ? m[hh] * LN2 + logf(l[hh]) : 1e30f;
    }
  }
  cluster_sync();  // no CTA leaves while another may read its partials
}

// The forward past d_head 256 in bf16, d_head a multiple of 128 in 2 to
// MAX_PARTS parts: one cluster of D / 128 CTAs per (query tile, b h).
cudaError_t fwd(const void* q, const void* k, const void* v, const void* e, const void* pad,
                void* o, void* lse, int B, int H, int T_len, int D, int max_seq, int causal,
                float scale, cudaStream_t stream) {
  const int np = D / PW;
  Maps maps;
  cudaError_t err;
  if ((err = sm90_host::slab_map(&maps.q, q, B * H, T_len, D, BQ, KS)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.k, k, B * H, T_len, D, BK, KS)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.v, v, B * H, T_len, D, BK, KS)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.e, e, 1, max_seq, D, BK, KS)) != cudaSuccess)
    return err;
  auto kernel = wide_fwd_tc_cluster_kernel;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TOTAL)) !=
      cudaSuccess)
    return err;
  if (np > 8 && (err = cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
    return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = np;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(np, B * H, (T_len + BQ - 1) / BQ);
  cfg.blockDim = dim3(NTH, 1, 1);
  cfg.dynamicSmemBytes = TOTAL;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, static_cast<const uint8_t*>(pad),
                           static_cast<bf*>(o), static_cast<float*>(lse), H, T_len, D, max_seq,
                           causal, LOG2E * scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 backward (kernel 4) on wgmma: a thread-block cluster per key-tile sweep
// ---------------------------------------------------------------------------
//
// tc::bwd runs three sweeps (key-major, query-major, distance-major), and
// each recomputes the whole score side (S, the band, dP) in every one of
// its d_head / 128 blocks. Here one cluster of np = d_head / 128 CTAs
// computes each tile pair's score side once, split by columns, and every
// output of the pair from it. Ownership is the narrow kernel 4's
// (flash_rel_attn_bwd.cu): a cluster sweeps key tiles kt = s, s + S, ...
// of one (b, h) (split s of S, alternate key tiles for the causal
// balance) and, inside, the query tiles that see them; dK and dV of the key
// tile stay in registers; dQ and dE accumulate in f32 partials that belong
// to split s alone, which two small kernels sum in split order (no atomics).
//
// CTA r owns d_head columns 128 r .. 128 r + 127 and copies only those of
// K and V (per key tile), Q and dO (per pair, a two-stage ring) and the E
// band (in 64-row chunks, a ring of four: consecutive query tiles' bands
// share a chunk), by TMA under mbarriers, thread 0 refilling each slot
// right after the barrier that ends its last reader (a ninth, producer
// warp would cap every thread at 168 registers, where the kernel spills).
// Two warpgroups, warp w of each owning rows 16 w .. 16 w + 15 of every
// 64-row accumulator. Per tile pair:
//   * A: warpgroup 0 computes S_r = Q_r K_r^T and the band Q_r E_band,r^T
//     (m64n64 each, over the part's 8 k16 steps), skews the band into Srel
//     through a per-warp scratch and adds it; warpgroup 1 computes dP_r =
//     dO_r V_r^T. Both publish (S_r + Srel_r and dP_r, 2 x 64 x 64 f32, one
//     buffer) and signal row group w of every rank;
//   * the exchange: warpgroup h reads key columns 32 h .. 32 h + 31 of
//     both partials of every rank through distributed shared memory and
//     sums them in rank order (all-pull below SCATTER_PARTS parts; from
//     there a reduce-scatter in place, rank n np / 8 summing column group
//     n, and an all-gather), so every CTA holds bitwise the same S and dP;
//     P = exp(s - lse) and dS' = c P (dP - dsum) in f32, 0 where masked,
//     rounded to bf16 into shared tiles with dS' also scattered by distance
//     into dsd, as the narrow kernel does; then a signal that the buffer
//     may be written again;
//   * B, the CTA's own columns only: warpgroup 0 dV_r += P^T dO_r and dQ_r
//     = (the partial's rows) + dS' K_r + dsd E_band,r, written back;
//     warpgroup 1 dK_r += dS'^T Q_r and the dE block the query tile
//     finishes, dsd[:, 64..]^T Q_r plus the block carried from the previous
//     query tile and the partial's rows, written back; then dsd[:, ..63]^T
//     Q_r is the block carried to the next query tile.
// A split's first key tile writes its partial rows without reading them:
// it reaches every row any later key tile of the split reaches.
//
// Measured on the H100 (PERF.md, by scripts/torch_wide_bwd_ablation.py):
// the exchange takes about a quarter of the call and reading the partial
// rows back a sixth; the rest is each warpgroup running a pair's phases in
// turn, with nothing of the next pair under them.

namespace bw {

constexpr int THREADS = 32 * 2 * NCW;    // two warpgroups
constexpr int SLAB = BQ * 32;            // a slab of a 64-row tile: 2048 bytes
constexpr int NQ = 2;                    // Q, dO ring stages
constexpr int NCH = 4;                   // the E ring, in chunks of 64 rows
constexpr int HW = 48;                   // band columns a warp reads per 32 keys: 47 distances
constexpr int HWS = HW + 8;              // row stride of a warp's skew scratch (floats)
constexpr int MAX_SPLIT = 2;             // clusters a (b, h), at most
constexpr int R = PW / 2;                // a thread's registers of a 64 x 128 f32 accumulator
constexpr int XN = 32 * 16;              // 512: column group n (8 keys) of a row group's partial
constexpr int XW = 2 * (BK / 8) * 32 * 16;  // 8192: a row group's S and dP partials
constexpr int QD_AT = 0;                      // [NQ]: Q, dO
constexpr int EC_AT = QD_AT + NQ * 2 * TILE;  // [NCH] E chunks
constexpr int KV_AT = EC_AT + NCH * TILE;     // K, V
constexpr int P_AT = KV_AT + 2 * TILE;       // P [64 q][64 k] in 4 slabs
constexpr int DS_AT = P_AT + 4 * SLAB;       // dS', the same
constexpr int DSD_AT = DS_AT + 4 * SLAB;     // dS' by distance [64 q][128 v] in 8 slabs
constexpr int XP_AT = DSD_AT + 8 * SLAB;     // [row group][S, dP][column group n][lane] float4
constexpr int BARS_AT = XP_AT + NCW * XW;
constexpr int NBAR = NQ + 1 + 3 * NCW;
constexpr int SMEM = BARS_AT + 8 * NBAR + 1024;  // + room to align to 1024
static_assert(SMEM <= 232448, "a CTA's shared memory");
static_assert(16 * HWS * 4 <= XW / 2, "a warp's skew scratch fits its row group's S buffer");

}  // namespace bw

struct BwdMaps {
  CUtensorMap q, k, v, d, e;  // q, k, v, dO: [B*H][T][dh]; e: [max_seq][dh], in slabs, 8 a box
};

struct BwdArgs {
  const uint8_t* pad;
  const float* lse;
  const float* dsum;
  bf* dk;
  bf* dv;
  float* dq_part;  // [S][B*H][T][dh]
  float* de_part;  // [S][B*H][T][dh], row = distance
  int H, T_len, D, max_seq, causal, nsplit;
  float scale, scale_log2;
};

// rows row0 + step * rl (rl = 16 wq + g + 8 hh, this thread's accumulator
// rows) of an f32 [T][dh] partial, the part's columns c0..: into a (add:
// onto a); rows outside [0, T) read as zeros
__device__ __forceinline__ void part_rows_in(float (&a)[bw::R], const float* src, int row0,
                                             int step, int T_len, int D, int c0, int wq, bool add) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + step * (16 * wq + g + 8 * hh);
    const bool ok = row >= 0 && row < T_len;
#pragma unroll
    for (int c = 0; c < PW / 8; ++c) {
      const float2 x = ok ? *reinterpret_cast<const float2*>(src + (size_t)row * D + c0 + 8 * c +
                                                             2 * t)
                          : make_float2(0.f, 0.f);
      a[4 * c + 2 * hh] = add ? a[4 * c + 2 * hh] + x.x : x.x;
      a[4 * c + 2 * hh + 1] = add ? a[4 * c + 2 * hh + 1] + x.y : x.y;
    }
  }
}

// a (m64n128 accumulator layout) into those rows of the partial
__device__ __forceinline__ void part_rows_out(float* dst, const float (&a)[bw::R], int row0,
                                              int step, int T_len, int D, int c0, int wq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + step * (16 * wq + g + 8 * hh);
    if (row < 0 || row >= T_len) continue;
    float* at = dst + (size_t)row * D + c0 + 2 * t;
#pragma unroll
    for (int c = 0; c < PW / 8; ++c)
      *reinterpret_cast<float2*>(at + 8 * c) = make_float2(a[4 * c + 2 * hh], a[4 * c + 2 * hh + 1]);
  }
}

// Thread 0's copies, in the pairs' order: the K and V of a key tile once
// the last key tile is done (one stage), and a pair's Q, dO and its band's
// new E chunk (both chunks at a key tile's first pair) once the pair NQ
// back is done. Band row v of pair (q0, k0) is E row r0 + v, at distance
// q0 - k0 + 64 - v; the next query tile's band starts 64 rows lower, so its
// rows 64.. are this band's rows ..63.
struct BwdProducer {
  const BwdMaps* maps;
  unsigned char* smem;
  int bh, c2, nsplit, n_tiles, causal, max_seq;
  int kt0, kt, qt;               // the cluster's first key tile; the next pair to copy
  int n_kt, n_kv, n_pairs, cnt;  // key tiles of the cluster, K/V, pairs and E chunks copied

  __device__ __forceinline__ void produce(int pairs_done, int kts_done) {
    using namespace bw;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS_AT);
    uint64_t* kvfull = full + NQ;
    if (n_kv == kts_done && n_kv < n_kt) {
      const int k0 = (kt0 + n_kv * nsplit) * BK;
      mbar_expect_tx(kvfull, 2 * TILE);
      tma_load(smem + KV_AT, &maps->k, 0, k0, c2, bh, kvfull);
      tma_load(smem + KV_AT + TILE, &maps->v, 0, k0, c2, bh, kvfull);
      ++n_kv;
    }
    while (kt < n_tiles && n_pairs < pairs_done + NQ) {
      const int s = n_pairs % NQ, q0 = qt * BQ, k0 = kt * BK, qt0 = causal ? kt : 0;
      const int r0 = max_seq - EB - (q0 - k0 - (BK - 1));
      mbar_expect_tx(&full[s], (qt == qt0 ? 4 : 3) * TILE);
      unsigned char* st = smem + QD_AT + s * 2 * TILE;
      tma_load(st, &maps->q, 0, q0, c2, bh, &full[s]);
      tma_load(st + TILE, &maps->d, 0, q0, c2, bh, &full[s]);
      if (qt == qt0)
        tma_load(smem + EC_AT + (cnt++ % NCH) * TILE, &maps->e, 0, r0 + BQ, c2, 0, &full[s]);
      tma_load(smem + EC_AT + (cnt++ % NCH) * TILE, &maps->e, 0, r0, c2, 0, &full[s]);
      ++n_pairs;
      if (++qt == n_tiles) {
        kt += nsplit;
        qt = causal ? kt : 0;
      }
    }
  }
};

// One consumer warpgroup's sweep (see the note above): WG 0 computes S and
// the band, then dV and dQ; WG 1 dP, then dK and dE. Each runs its own loop,
// so neither holds the other's accumulators.
template <int WG>
__device__ __forceinline__ void bwd_consumer(const BwdMaps& maps, const BwdArgs& a,
                                             unsigned char* smem, uint32_t base, int wq, int rank,
                                             int np, int bh, int sp) {
  using namespace bw;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = bh / a.H, T_len = a.T_len, D = a.D, c0 = rank * PW;
  const int n_tiles = (T_len + BK - 1) / BK, BH = gridDim.y / a.nsplit;
  const size_t rbase = (size_t)bh * T_len, obase = rbase * D;
  const size_t part = ((size_t)sp * BH + bh) * T_len * D;
  float* dqa = a.dq_part + part;
  float* dea = a.de_part + part;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS_AT);
  uint64_t* kvfull = full + NQ;
  uint64_t* xfull = kvfull + 1;  // [NCW]: row group w published by both warpgroups of every rank
  uint64_t* xsum = xfull + NCW;   // [NCW]: (reduce-scatter) every rank's owned groups summed
  uint64_t* xfree = xsum + NCW;   // [NCW]: row group w's buffer read by every rank
  const uint32_t p_t = base + P_AT, ds_t = base + DS_AT, dsd_t = base + DSD_AT;
  unsigned char* xrow = smem + XP_AT + wq * XW;  // this row group's S, then dP buffer
  // this warpgroup's column groups 4 WG .. 4 WG + 3 (keys 32 WG ..) of both
  const uint32_t xs = base + XP_AT + wq * XW + 4 * WG * XN + lane * 16;

  const int qt_first = a.causal ? sp : 0, n_kt = (n_tiles - sp + a.nsplit - 1) / a.nsplit;
  BwdProducer prod = {&maps, smem, bh, rank * KS, a.nsplit, n_tiles, a.causal, a.max_seq,
                      sp, sp, qt_first, n_kt, 0, 0, 0};
  if (WG == 0 && tid == 0) prod.produce(0, 0);
  float acc[R];   // WG 0: dV of the key tile, WG 1: dK (rows = keys)
  float work[R];  // WG 0: dQ of the pair; WG 1: the dE block carried between query tiles
  int p = 0, cnt = 0, lower = 0, kti = 0;
  for (int kt = sp; kt < n_tiles; kt += a.nsplit, ++kti) {
    const int k0 = kt * BK, qt0 = a.causal ? kt : 0;
    const bool first_kt = kt == sp;  // the partial rows are not yet written
    const int key = k0 + 32 * WG + lane;
    const uint32_t live = __ballot_sync(
        0xffffffffu, key < T_len && !(a.pad != nullptr && a.pad[(size_t)b * T_len + key]));
#pragma unroll
    for (int x = 0; x < R; ++x) acc[x] = work[x] = 0.f;
    mbar_wait(kvfull, kti & 1);
    const uint32_t k_t = base + KV_AT, v_t = k_t + TILE;
    for (int qt = qt0; qt < n_tiles; ++qt, ++p) {
      const int s = p % NQ, q0 = qt * BQ;
      const bool last_q = qt == n_tiles - 1;
      const int upper = qt == qt0 ? cnt++ % NCH : lower;  // band rows 64..127
      lower = cnt++ % NCH;                                // band rows 0..63
      const uint32_t q_t = base + QD_AT + s * 2 * TILE, do_t = q_t + TILE;
      const uint32_t lo_t = base + EC_AT + lower * TILE, up_t = base + EC_AT + upper * TILE;
      float lse_r[2], dsum_r[2];  // rows g and g + 8 of the warp (lse in log2 units)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = q0 + 16 * wq + g + 8 * hh;
        lse_r[hh] = i < T_len ? a.lse[rbase + i] * LOG2E : 0.f;
        dsum_r[hh] = i < T_len ? a.dsum[rbase + i] : 0.f;
      }
      mbar_wait(&full[s], (p / NQ) & 1);

      // ---- phase A: this warpgroup's product over the part's columns
      {
        float sc[BK / 2];
        if (WG == 0) {
          float bacc[2][BK / 2];  // band rows 0..63, 64..127
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const uint64_t da = desc_k(q_t + kk * SLAB);
            mma_ss<BK, 0, 0>(sc, da, desc_k(k_t + kk * SLAB), kk > 0);
            mma_ss<BK, 0, 0>(bacc[0], da, desc_k(lo_t + kk * SLAB), kk > 0);
            mma_ss<BK, 0, 0>(bacc[1], da, desc_k(up_t + kk * SLAB), kk > 0);
          }
          wg_commit();
          wg_wait0();
          fence_regs<BK / 2>(sc);
          fence_regs<BK / 2>(bacc[0]);
          fence_regs<BK / 2>(bacc[1]);
          // every rank has read this row group's buffer of the previous pair
          if (p > 0) wait_cluster(&xfree[wq], (p - 1) & 1);
          // the skew, 32 keys at a time through the S buffer: row r, key
          // 32 hf + j reads band column 64 - (16 wq + r) + 32 hf + j, which
          // lands at scratch column 16 - r + j
          float* scr = reinterpret_cast<float*>(xrow);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int cb = 6 - 2 * wq + 4 * hf;  // the first band chunk of 8 the half reads
#pragma unroll
            for (int c = 0; c < 2 * BK / 8; ++c) {
              const int cc = c - cb;
              if (cc >= 0 && cc < HW / 8) {
                const float* bc = bacc[c / 8] + 4 * (c % 8);
                *reinterpret_cast<float2*>(scr + g * HWS + 8 * cc + 2 * t) = make_float2(bc[0], bc[1]);
                *reinterpret_cast<float2*>(scr + (g + 8) * HWS + 8 * cc + 2 * t) =
                    make_float2(bc[2], bc[3]);
              }
            }
            __syncwarp();
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const int r = g + 8 * (x >> 1), j = 8 * n + 2 * t + (x & 1);
                sc[4 * (4 * hf + n) + x] += scr[r * HWS + 16 - r + j];
              }
            __syncwarp();  // the scratch is read before the partial takes its place
          }
        } else {
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            mma_ss<BK, 0, 0>(sc, desc_k(do_t + kk * SLAB), desc_k(v_t + kk * SLAB), kk > 0);
          wg_commit();
          wg_wait0();
          fence_regs<BK / 2>(sc);
          if (p > 0) wait_cluster(&xfree[wq], (p - 1) & 1);
        }
        // publish: S_r + Srel_r (WG 0) or dP_r (WG 1), column group n at n XN
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          *reinterpret_cast<float4*>(xrow + WG * (XW / 2) + n * XN + lane * 16) =
              make_float4(sc[4 * n], sc[4 * n + 1], sc[4 * n + 2], sc[4 * n + 3]);
        __syncwarp();
        if (lane < np) arrive_peer(peer(smem_u32(&xfull[wq]), lane));
      }

      // ---- the exchange: this warpgroup's 4 column groups of S and dP,
      // summed over the ranks in rank order
      float ts[16], tp[16];
      wait_cluster(&xfull[wq], p & 1);
      if (np < SCATTER_PARTS) {
        for (int r = 0; r < np; ++r) {
          const uint32_t at = peer(xs, r);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float4 u = ld_peer(at + n * XN), v = ld_peer(at + XW / 2 + n * XN);
            const float us[4] = {u.x, u.y, u.z, u.w}, vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              ts[4 * n + x] = r == 0 ? us[x] : ts[4 * n + x] + us[x];
              tp[4 * n + x] = r == 0 ? vs[x] : tp[4 * n + x] + vs[x];
            }
          }
        }
      } else {
        // column group 4 WG + n is summed by rank owner = (4 WG + n) np / 8
        // alone, in rank order, written over its own partial and read from
        // there by the others
        for (int r = 0; r < np; ++r) {
          const uint32_t at = peer(xs, r);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if ((((4 * WG + n) * np) >> 3) != rank) continue;
            const float4 u = ld_peer(at + n * XN), v = ld_peer(at + XW / 2 + n * XN);
            const float us[4] = {u.x, u.y, u.z, u.w}, vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              ts[4 * n + x] = r == 0 ? us[x] : ts[4 * n + x] + us[x];
              tp[4 * n + x] = r == 0 ? vs[x] : tp[4 * n + x] + vs[x];
            }
          }
        }
        unsigned char* mine = xrow + 4 * WG * XN + lane * 16;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if ((((4 * WG + n) * np) >> 3) == rank) {
            *reinterpret_cast<float4*>(mine + n * XN) =
                make_float4(ts[4 * n], ts[4 * n + 1], ts[4 * n + 2], ts[4 * n + 3]);
            *reinterpret_cast<float4*>(mine + XW / 2 + n * XN) =
                make_float4(tp[4 * n], tp[4 * n + 1], tp[4 * n + 2], tp[4 * n + 3]);
          }
        __syncwarp();
        if (lane < np) arrive_peer(peer(smem_u32(&xsum[wq]), lane));
        wait_cluster(&xsum[wq], p & 1);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int owner = ((4 * WG + n) * np) >> 3;
          if (owner == rank) continue;
          const uint32_t at = peer(xs, owner);
          const float4 u = ld_peer(at + n * XN), v = ld_peer(at + XW / 2 + n * XN);
          ts[4 * n] = u.x;
          ts[4 * n + 1] = u.y;
          ts[4 * n + 2] = u.z;
          ts[4 * n + 3] = u.w;
          tp[4 * n] = v.x;
          tp[4 * n + 1] = v.y;
          tp[4 * n + 2] = v.z;
          tp[4 * n + 3] = v.w;
        }
      }

      // P and dS' of this warpgroup's keys, as the narrow kernel's phase A
      {
        const bool masked = q0 + 16 * wq + 15 >= T_len || live != 0xffffffffu ||
                            (a.causal && k0 + 32 * WG + 31 > q0 + 16 * wq);
        const bf zero = __float2bfloat16(0.f);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int il = 16 * wq + g + 8 * hh, i = q0 + il;
            const int jw = 8 * n + 2 * t, jl = 32 * WG + jw;  // key in the warpgroup, the tile
            float pr[2], ds[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int e = 4 * n + 2 * hh + x;
              const bool ok = !masked || (i < T_len && ((live >> (jw + x)) & 1) &&
                                          !(a.causal && k0 + jl + x > i));
              pr[x] = ok ? exp2f(ts[e] * a.scale_log2 - lse_r[hh]) : 0.f;
              ds[x] = pr[x] * (tp[e] - dsum_r[hh]) * a.scale;
            }
            const uint32_t at = (jl >> 4) * SLAB + sw32(il, jl & 15);
            *reinterpret_cast<uint32_t*>(smem + P_AT + at) = pack_bf16(pr[0], pr[1]);
            const uint32_t dsb = pack_bf16(ds[0], ds[1]);
            *reinterpret_cast<uint32_t*>(smem + DS_AT + at) = dsb;
            const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dsb);
            // distance i - (k0 + jl + x) sits at band column 64 - il + jl + x
            const int v = 64 - il + jl, dist = i - (k0 + jl);
            *reinterpret_cast<bf*>(smem + DSD_AT + (v >> 4) * SLAB + sw32(il, v & 15)) =
                dist >= 0 ? d2.x : zero;
            *reinterpret_cast<bf*>(smem + DSD_AT + ((v + 1) >> 4) * SLAB + sw32(il, (v + 1) & 15)) =
                dist - 1 >= 0 ? d2.y : zero;
          }
      }
      fence_async_smem();
      __syncwarp();  // the warp's reads of every rank's buffer are done (their values used)
      if (lane < np) arrive_peer(peer(smem_u32(&xfree[wq]), lane));
      named_barrier(1, 32 * 2 * NCW);  // P, dS' and dsd are in place

      // ---- phase B: the CTA's own columns
      if (WG == 0) {
        wg_fence();
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq)  // dV += P^T dO
          mma_ss<PW, 1, 1>(acc, desc_mn(p_t + 512 * kq, SLAB), desc_mn(do_t + 512 * kq, SLAB));
        wg_commit();
        // the split's dQ rows of the query tile so far, read under dV's product
        if (first_kt) {
#pragma unroll
          for (int x = 0; x < R; ++x) work[x] = 0.f;
        } else {
          part_rows_in(work, dqa, q0, 1, T_len, D, c0, wq, false);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // dQ += dS' K
          mma_ss<PW, 0, 1>(work, desc_k(ds_t + kk * SLAB), desc_mn(k_t + 512 * kk, SLAB));
#pragma unroll
        for (int kv = 0; kv < EB / 16; ++kv)  // + dsd E_band
          mma_ss<PW, 0, 1>(work, desc_k(dsd_t + kv * SLAB),
                           desc_mn((kv < 4 ? lo_t : up_t) + 512 * (kv & 3), SLAB));
        wg_commit();
        wg_wait0();
        fence_regs<R>(acc);
        fence_regs<R>(work);
        part_rows_out(dqa, work, q0, 1, T_len, D, c0, wq);
      } else {
        wg_fence();
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq)  // dK += dS'^T Q
          mma_ss<PW, 1, 1>(acc, desc_mn(ds_t + 512 * kq, SLAB), desc_mn(q_t + 512 * kq, SLAB));
        wg_commit();
        // the dE block the query tile finishes (band rows 64 + rl: distance
        // q0 - k0 - rl) gets the partial's rows, read under dK's product
        if (!first_kt) part_rows_in(work, dea, q0 - k0, -1, T_len, D, c0, wq, true);
        wg_fence();
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq)
          mma_ss<PW, 1, 1>(work, desc_mn(dsd_t + 4 * SLAB + 512 * kq, SLAB),
                           desc_mn(q_t + 512 * kq, SLAB));
        wg_commit();
        wg_wait0();
        fence_regs<R>(acc);
        fence_regs<R>(work);
        part_rows_out(dea, work, q0 - k0, -1, T_len, D, c0, wq);
        // band rows 0..63: the next query tile's finished block
        wg_fence();
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq)
          mma_ss<PW, 1, 1>(work, desc_mn(dsd_t + 512 * kq, SLAB), desc_mn(q_t + 512 * kq, SLAB),
                           kq > 0);
        wg_commit();
        wg_wait0();
        fence_regs<R>(work);
        if (last_q) {  // no next query tile: the block is done (distance q0 + 64 - k0 - rl)
          if (!first_kt) part_rows_in(work, dea, q0 + BQ - k0, -1, T_len, D, c0, wq, true);
          part_rows_out(dea, work, q0 + BQ - k0, -1, T_len, D, c0, wq);
        }
      }
      if (last_q) {  // the key tile's dV (WG 0) or dK (WG 1), cast to bf16
        bf* out = (WG == 0 ? a.dv : a.dk) + obase;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = k0 + 16 * wq + g + 8 * hh;
          if (j >= T_len) continue;
          bf* row = out + (size_t)j * D + c0 + 2 * t;
#pragma unroll
          for (int c = 0; c < PW / 8; ++c)
            *reinterpret_cast<uint32_t*>(row + 8 * c) =
                pack_bf16(acc[4 * c + 2 * hh], acc[4 * c + 2 * hh + 1]);
        }
      }
      named_barrier(1, 32 * 2 * NCW);  // every product of the pair is done with its tiles
      if (WG == 0 && tid == 0) prod.produce(p + 1, kti + last_q);
    }
  }
}

// One cluster of np = D / 128 CTAs per (b h, split), grid (np, B * H *
// nsplit); warpgroup 0 (with thread 0's copies) and warpgroup 1.
__global__ void __launch_bounds__(bw::THREADS, 1)
wide_bwd_tc_cluster_kernel(const __grid_constant__ BwdMaps maps, const __grid_constant__ BwdArgs a) {
  using namespace bw;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS_AT);  // [NQ], then K/V's
  uint64_t* xbars = full + NQ + 1;  // xfull, xsum, xfree: [NCW] each
  const int tid = threadIdx.x, warp = warp_index();
  const int rank = cluster_rank(), np = cluster_size();
  const int sp = blockIdx.y % a.nsplit, bh = blockIdx.y / a.nsplit;

  if (tid == 0) {
    for (int s = 0; s < NQ + 1; ++s) mbar_init(&full[s], 1);
    for (int x = 0; x < 3 * NCW; ++x) mbar_init(&xbars[x], 2 * np);
    mbar_init_fence();
  }
  // dsd's entries no pair reaches stay zero
  for (int x = tid; x < 8 * SLAB / 16; x += THREADS)
    reinterpret_cast<uint4*>(smem + DSD_AT)[x] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  cluster_sync();  // every rank's barriers exist before any rank arrives on them
  if (warp < NCW)
    bwd_consumer<0>(maps, a, smem, base, warp, rank, np, bh, sp);
  else
    bwd_consumer<1>(maps, a, smem, base, warp - NCW, rank, np, bh, sp);
  cluster_sync();  // no CTA leaves while another may read its partials
}

// dQ = the splits' partials summed in split order, cast once; split s
// holds the query tiles its key tiles reach (causal: from tile s on). 4
// values a thread (n is a multiple of 128).
__global__ void bwd_dq_reduce_kernel(const float* __restrict__ part, bf* __restrict__ dq, size_t n,
                                     int T_len, int D, int nsplit, int causal) {
  const size_t x = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (x >= n) return;
  const int qt = (int)((x / D) % T_len) / BQ;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nsplit && !(causal && s > qt); ++s) {
    const float4 v = *reinterpret_cast<const float4*>(part + s * n + x);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<uint2*>(dq + x) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}

// dE[m, c] = for the distance d = max_seq - 1 - m < T, the partials of
// every split that reaches d (split s: d <= 64 (tiles - s)), by split, then
// (b, h); 0 for the others
__global__ void bwd_de_reduce_kernel(const float* __restrict__ part, bf* __restrict__ de, int BH,
                                     int T_len, int D, int max_seq, int nsplit) {
  const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= (size_t)max_seq * D) return;
  const int m = (int)(x / D), c = (int)(x - (size_t)m * D), d = max_seq - 1 - m;
  const int n_tiles = (T_len + BK - 1) / BK;
  float acc = 0.f;
  if (d < T_len)
    for (int s = 0; s < nsplit && d <= BK * (n_tiles - s); ++s)
      for (int bh = 0; bh < BH; ++bh) acc += part[(((size_t)s * BH + bh) * T_len + d) * D + c];
  de[x] = __float2bfloat16(acc);
}

// Clusters a (b, h): two, on alternate key tiles, where the card holds
// both of every (b, h) at once; else one.
inline cudaError_t bwd_splits(int BH, int n_tiles, int np, int* nsplit) {
  static int clusters[64][MAX_PARTS + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (clusters[dev][np] == 0) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = np;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(np, 1, 1);
    cfg.blockDim = dim3(bw::THREADS, 1, 1);
    cfg.dynamicSmemBytes = bw::SMEM;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaOccupancyMaxActiveClusters(&clusters[dev][np], wide_bwd_tc_cluster_kernel,
                                              &cfg)) != cudaSuccess)
      return err;
  }
  *nsplit = n_tiles >= 2 && bw::MAX_SPLIT * BH <= clusters[dev][np] ? bw::MAX_SPLIT : 1;
  return cudaSuccess;
}

// Kernel 4's backward past d_head 256 in bf16, d_head a multiple of 128 in 2
// to MAX_PARTS parts; scratch: f32 [2 MAX_SPLIT][B * H][T][dh], the splits'
// dQ partials, then their dE partials.
cudaError_t bwd(const Bwd& p, cudaStream_t stream) {
  const int np = p.D / PW, BH = p.B * p.H, n_tiles = (p.Tn + BK - 1) / BK;
  BwdMaps maps;
  cudaError_t err;
  if ((err = sm90_host::slab_map(&maps.q, p.q, BH, p.Tn, p.D, BQ, KS)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.k, p.k, BH, p.Tn, p.D, BK, KS)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.v, p.v, BH, p.Tn, p.D, BK, KS)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.d, p.dout, BH, p.Tn, p.D, BQ, KS)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.e, p.e, 1, p.ms, p.D, BQ, KS)) != cudaSuccess)
    return err;
  auto kernel = wide_bwd_tc_cluster_kernel;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bw::SMEM)) != cudaSuccess)
    return err;
  if (np > 8 && (err = cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
    return err;
  int nsplit = 1;
  if ((err = bwd_splits(BH, n_tiles, np, &nsplit)) != cudaSuccess) return err;
  const size_t n = (size_t)BH * p.Tn * p.D;
  BwdArgs a = {p.pad, p.lse, p.dsum, static_cast<bf*>(p.dk), static_cast<bf*>(p.dv),
               p.de_part, p.de_part + nsplit * n, p.H, p.Tn, p.D, p.ms, p.causal, nsplit,
               p.scale, p.scale * LOG2E};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = np;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(np, BH * nsplit, 1);
  cfg.blockDim = dim3(bw::THREADS, 1, 1);
  cfg.dynamicSmemBytes = bw::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, maps, a)) != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq_reduce_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
      a.dq_part, static_cast<bf*>(p.dq), n, p.Tn, p.D, nsplit, p.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t m = (size_t)p.ms * p.D;
  bwd_de_reduce_kernel<<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(
      a.de_part, static_cast<bf*>(p.de), BH, p.Tn, p.D, p.ms, nsplit);
  return cudaGetLastError();
}

}  // namespace cl

}  // namespace

extern "C" {

// Kernel 1 past d_head 256. The arguments of flash_rel_attn_fwd; dh: a
// positive multiple of 32 (f32) or 64 (bf16); the wrappers pass multiples of
// 128, which bf16 runs on cl::wide_fwd_tc_cluster_kernel up to 16 parts
// (d_head 2048) and on tc::wide_fwd_tc_kernel past them. Returns a
// cudaError_t: 0 when the launch was accepted. Launches on `stream` and does
// not synchronise.
int flash_rel_attn_wide_fwd(const void* q, const void* k, const void* v, const void* e,
                            const void* pad, void* o, void* lse, int B, int H, int T_len,
                            int dh, int max_seq, int causal, int dtype, float scale,
                            void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq || dh <= 0 || dh % KC != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T_len + BT - 1) / BT, B * H, (dh + PW - 1) / PW);
  const int smem = FWD_FLOATS * (int)sizeof(float);
  const uint8_t* pad8 = static_cast<const uint8_t*>(pad);
  cudaError_t err;
  if (dtype == 0) {
    auto kernel = wide_fwd_kernel;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)) != cudaSuccess)
      return err;
    kernel<<<grid, NT, smem, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                  static_cast<const float*>(v), static_cast<const float*>(e),
                                  pad8, static_cast<float*>(o), static_cast<float*>(lse), H,
                                  T_len, dh, max_seq, causal, scale);
  } else if (dtype == 1 && dh % cl::PW == 0 && dh / cl::PW <= cl::MAX_PARTS) {
    return cl::fwd(q, k, v, e, pad, o, lse, B, H, T_len, dh, max_seq, causal, scale, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (dh % tc::KT != 0) return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(tc::wide_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    tc::BYTES)) != cudaSuccess)
      return err;
    tc::wide_fwd_tc_kernel<<<grid, NT, tc::BYTES, s>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(e), pad8, static_cast<bf*>(o), static_cast<float*>(lse), H, T_len,
        dh, max_seq, causal, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The backward of kernel `kernel` (4, 5, 6, 7, 8 or 9) past its built
// d_head: dq, dk, dv, de as that kernel's wrapper returns them (dq is dQ,
// dQ's key term for 7 and its relative term for 8), the ones it does not
// compute null; de_part: f32 scratch [B * H, T, dh] for 4, 5, 6 and 8, but
// [4 * B * H, T, dh] for 4 in bf16 with dh a multiple of 128 up to 16
// parts (2048), which runs on cl::wide_bwd_tc_cluster_kernel (its splits'
// dQ and dE partials). The other arguments as flash_rel_attn_bwd's; dh: a
// positive multiple of 32 (f32) or 64 (bf16).
int flash_rel_attn_wide_bwd(const void* q, const void* k, const void* v, const void* e,
                            const void* pad, const void* dout, const void* lse, const void* dsum,
                            void* dq, void* dk, void* dv, void* de, void* de_part, int B, int H,
                            int T_len, int dh, int max_seq, int causal, int dtype, float scale,
                            int kernel, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq || dh <= 0 || dh % KC != 0 ||
      kernel < 4 || kernel > 9)
    return cudaErrorInvalidValue;
  const bool want_dkdv = kernel == 4 || kernel == 7 || kernel == 9;
  const bool want_dq = kernel != 9;
  const bool want_de = kernel == 4 || kernel == 5 || kernel == 6 || kernel == 8;
  if ((want_dkdv && (dk == nullptr || dv == nullptr)) || (want_dq && dq == nullptr) ||
      (want_de && (de == nullptr || de_part == nullptr)))
    return cudaErrorInvalidValue;
  Bwd p = {q, k, v, e, static_cast<const uint8_t*>(pad), dout,
           static_cast<const float*>(lse), static_cast<const float*>(dsum), dq, dk, dv, de,
           static_cast<float*>(de_part), B, H, T_len, dh, max_seq, causal, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd(p, kernel, s);
  if (dtype == 1 && kernel == 4 && dh % cl::PW == 0 && dh / cl::PW <= cl::MAX_PARTS)
    return cl::bwd(p, s);
  if (dtype == 1) return dh % tc::KT != 0 ? cudaErrorInvalidValue : tc::bwd(p, kernel, s);
  return cudaErrorInvalidValue;
}

const char* flash_rel_attn_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
