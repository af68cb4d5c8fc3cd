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
// design, measured in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// Kernel 1 past d_head 256. The arguments of flash_rel_attn_fwd; dh: a
// positive multiple of 32 (f32) or 64 (bf16); the wrappers pass multiples of
// 128. Returns a
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
// compute null; de_part: f32 scratch [B * H, T, dh] for 4, 5, 6 and 8. The
// other arguments as flash_rel_attn_bwd's; dh: a positive multiple of 32
// (f32) or 64 (bf16).
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
  if (dtype == 1) return dh % tc::KT != 0 ? cudaErrorInvalidValue : tc::bwd(p, kernel, s);
  return cudaErrorInvalidValue;
}

const char* flash_rel_attn_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
