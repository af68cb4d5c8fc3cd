// Flash relative attention, backward: the query-major sweeps, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of midi_emotion_tpu/ops/pallas_attention.py,
// one mode each:
//   * COLUMN, _bwd_dq_de_kernel (BWD_IMPL="fused", DQDE_IMPL="column",
//     launched by _bwd_dq_de_call): dQ and dE, the relative term's adjoint
//     formed by key column (the unskew of dS' into its distance band);
//   * DIST, _bwd_dq_de_dist_kernel (BWD_IMPL="fused", DQDE_IMPL="dist",
//     launched by _bwd_dq_de_dist_call): dQ and dE, dQ's key term from the
//     key-column dS' and the relative terms from dS recomputed in the
//     distance domain;
//   * REL, _bwd_de_dqrel_kernel (BWD_IMPL="split", launched by
//     _bwd_de_dqrel_call): the distance domain alone, dQ_rel and dE.
// With c = 1/sqrt(d_head) (the caller's scale), the forward's saved lse,
// dsum_i = dO_i . O_i, and the distance d = i - j (the notation of flash_rel_attn_bwd.cu):
//
//     dS'[i,j]  = c P[i,j] (dO_i . V_j - dsum_i)
//     dQ_qk_i   = sum_j dS'[i,j] k_j                         (COLUMN, DIST)
//     dQ_rel_i  = sum_{d >= 0} dS'[i,i-d] E[ms-1-d]
//     dE[ms-1-d] = sum_i dS'[i,i-d] q_i                       (d >= 0 only)
//
// The relative bias is 0 above the diagonal even in the non-causal
// (regression) model, so its adjoint is too: no d < 0 reaches dQ_rel or dE.
// In the distance domain the relative bias of row i at distance d is
// q_i . E[ms-1-d], a plain product with no skew (the docstring of
// _bwd_dq_de_dist_kernel derives it), and the key terms are read at
// j = i - d. The TPU's XLA-side flips of K, V, the pad mask and E existed
// because Mosaic could not lower the reversed shear; here the kernel reads
// key i - d directly.
//
// bf16, COLUMN and DIST (the `fused` training path): tensor cores. Bound on
// the H100: operations. Per visible tile pair the products are S = Q K^T,
// dP = dO V^T, the band Q E_band^T, dQ += dS' K, dQ += dsd E_band and
// dE += dsd^T Q, every one an mma.sync m16n8k16 with bf16 operands and f32
// sums (wgmma not tried; see flash_rel_attn_bwd.cu, whose phase A and
// products this path shares). 8 warps a block, per tile pair:
//   phase A, warp (query rows 16 (w % 4), keys 32 (w / 4)): S, dP and the
//     band over the 48 distances its rows and keys reach; the band skewed
//     into Srel through a per-warp f32 scratch; P = exp(s - lse) and dS' =
//     c P (dP - dsum) by key column, dS' rounded to bf16 as the TPU kernel
//     rounds ds, into a shared tile. Then the distance-domain tile dsd
//     (row i, column u = i - j + BK - 1, 0 where i - j < 0):
//       COLUMN scatters the rounded key-column dS' into it (the unskew);
//       DIST forms it by distance, as _bwd_dq_de_dist_kernel does: the
//       bias by distance is the band product itself, q.E[ms-1-d] with no
//       skew; q.k and dO.v at j = i - d are read from the warp's f32 S and
//       dP fragments skewed through the scratch; p_d and dsd = c p_d (dp_d
//       - dsum) in f32, dsd rounded to bf16;
//   phase B, warp (16-row block w / 2, channel half w % 2): dQ += dS' K +
//     dsd E_band, in f32 registers across the query tile's key tiles and
//     written once; dE += dsd^T Q for two 16-distance blocks into this
//     block's f32 partial by distance. Key tiles ascend, so the band moves
//     64 distances down a pair and a warp's lower dE block is the next
//     pair's upper one: it stays in registers, and each partial row is
//     read and written once a query tile.
// Two blocks share a (b, h), on alternate query tiles (at B 8, H 16, 256
// blocks, two an SM at d_head <= 48), each with its own dE partial
// [SPLIT*B*H, T, dh]; de_reduce_kernel sums them in block order, so two
// calls give bitwise-equal dE. K, V, Q, dO, lse, dsum and an E ring of
// 64-row chunks (a pair copies one) come by cp.async, into two ring stages
// where two blocks an SM still fit, the next pair's copies under this
// pair's products; rows are padded by 16 bytes for ldmatrix.
//
// f32 (the checks' path, held to 1e-4; TF32 keeps about three digits) and
// REL in both types: the CUDA cores, simple and correct first:
//   * tiles of 64 rows (32 at d_head 128, so the f32 staging fits a
//     block's shared memory) and 4 threads a row;
//   * one block per (b, h) sweeps its query tiles and,
//     inside, the key tiles they see. A query tile owns its dQ, kept in
//     registers and written once. dE crosses every tile, so it accumulates
//     in an f32 partial [B*H, T, dh] indexed by distance that only this block
//     touches, and a second kernel reduces the partials over B*H in a fixed
//     order: no atomics, nothing summed in bf16, a deterministic result;
//   * per tile pair the block stages K, V and the band of BQ + BK - 1 E rows
//     (zero for negative distances) as f32 in shared memory, beside the
//     query tile's Q and dO, then runs, with its threads remapped:
//       A (COLUMN, DIST), thread = (query row, 16 keys): P and dS' by key
//         column into a shared [BQ][BK] tile; COLUMN also scatters each
//         dS'[i,j] with j <= i into the shared band tile [BQ][BAND] at
//         u = i - j + BK - 1 - (q0 - k0): the unskew;
//       A_d (DIST, REL), thread = (query row, 16 distances): P and dS'
//         recomputed by distance into the band tile;
//       C, thread = (query row, dh/4 columns): dQ += dS' K (COLUMN, DIST)
//         and dQ += band . E (every mode);
//       D, thread = (distance, dh/4 columns): dE partial += band^T Q;
//   * causal: key tiles above a query tile are never visited; the band
//     phases run only for tiles at or below the diagonal.
// CUDA-core f32 FMAs fed from shared memory bound it, and the 8 warps a
// block gives each SM (B * H blocks: one wave at B 8, H 16).
//
// The device functions of the bf16 path that kernel 4 has too are copied
// from flash_rel_attn_bwd.cu (namespace tc there), so that this file
// includes no header of the repository and its build hash covers
// everything it compiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Tile sides by d_head: 64 rows, or 32 at d_head 128, where 64-row f32 tiles
// would pass the 232,448 bytes of shared memory a block may use. The threads
// follow the tile: 4 a row.
template <int DH>
struct Tile {
  static constexpr int BQ = DH > 96 ? 32 : 64;  // query rows per tile
  static constexpr int BK = BQ;                  // keys per tile
  static constexpr int BAND = BQ + BK - 1;       // distinct distances i - j in one tile pair
  static constexpr int NT = 4 * BQ;              // threads per block: 4 per row
  static constexpr int PS = BK + 1;              // row stride of the P and dS' tiles
  static constexpr int BS = BAND + 2;            // row stride of a band tile (distinct banks)
};

enum Mode { COLUMN = 0, DIST = 1, REL = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
__host__ __device__ constexpr int row_stride() { return DH + 4; }  // 16-byte aligned rows

template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int BQ = Tile<DH>::BQ, BK = Tile<DH>::BK, BAND = Tile<DH>::BAND, PS = Tile<DH>::PS,
                BS = Tile<DH>::BS;
  return (size_t)((2 * BK + 2 * BQ + BAND) * row_stride<DH>() + BQ * PS + BQ * BS + 2 * BQ +
                  BK) *
         sizeof(float);
}

// s = q_i . (k_j + E row), dp = dO_i . v_j over DH columns of shared rows
template <int DH>
__device__ __forceinline__ void score_dot(const float* qr, const float* dor, const float* kp,
                                          const float* ep, const float* vp, float& s,
                                          float& dp) {
  const float4* kr = reinterpret_cast<const float4*>(kp);
  const float4* er = reinterpret_cast<const float4*>(ep);
  const float4* vr = reinterpret_cast<const float4*>(vp);
  s = 0.f;
  dp = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    const float4 kk = kr[d4], ee = er[d4], vv = vr[d4];
    s = fmaf(qr[4 * d4 + 0], kk.x + ee.x, s);
    s = fmaf(qr[4 * d4 + 1], kk.y + ee.y, s);
    s = fmaf(qr[4 * d4 + 2], kk.z + ee.z, s);
    s = fmaf(qr[4 * d4 + 3], kk.w + ee.w, s);
    dp = fmaf(dor[4 * d4 + 0], vv.x, dp);
    dp = fmaf(dor[4 * d4 + 1], vv.y, dp);
    dp = fmaf(dor[4 * d4 + 2], vv.z, dp);
    dp = fmaf(dor[4 * d4 + 3], vv.w, dp);
  }
}

template <typename T, int DH, int MODE>
__global__ void __launch_bounds__(Tile<DH>::NT)
flash_rel_attn_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ e,
                            const uint8_t* __restrict__ pad, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dsum,
                            T* __restrict__ dq, float* __restrict__ de_part, int H, int T_len,
                            int max_seq, int causal, float scale) {
  static_assert(DH % 16 == 0, "each of 4 threads takes a float4-aligned quarter row");
  constexpr int BQ = Tile<DH>::BQ, BK = Tile<DH>::BK, BAND = Tile<DH>::BAND, NT = Tile<DH>::NT,
                PS = Tile<DH>::PS, BS = Tile<DH>::BS;
  constexpr int RS = row_stride<DH>();
  constexpr int CH = DH / 4;  // columns per thread in phases C and D
  constexpr bool KEY_COLUMN = MODE != REL;  // phase A and dQ's key term
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][RS]
  float* vs = ks + BK * RS;                      // [BK][RS]
  float* qs = vs + BK * RS;                      // [BQ][RS]
  float* dos = qs + BQ * RS;                     // [BQ][RS]
  float* es = dos + BQ * RS;                     // [BAND][RS], row u = distance d0 + u
  float* dss = es + BAND * RS;                   // [BQ][PS], by key column
  float* band = dss + BQ * PS;                   // [BQ][BS], by distance: u in [a, a + BK)
  float* lse_s = band + BQ * BS;                 // [BQ]
  float* dsum_s = lse_s + BQ;                    // [BQ]
  float* live = dsum_s + BQ;                     // [BK]: 1 for a visible key

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const size_t base = (size_t)bh * T_len * DH;
  float* dep = de_part + base;  // [T][DH], row = distance
  const int row4 = tid >> 2;    // phases A-C: the query row this thread works on
  const int c = tid & 3;        // its quarter of the keys (A) or of the columns (C)

  for (int x = tid; x < T_len * DH; x += NT) dep[x] = 0.f;

  const int n_tiles = (T_len + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    const int i = q0 + row4;
    __syncthreads();  // the previous query tile's phases are done with qs, dos
    for (int x = tid; x < BQ * DH; x += NT) {
      const int r = x / DH, d = x - r * DH;
      float qx = 0.f, dox = 0.f;
      if (q0 + r < T_len) {
        const size_t g = base + (size_t)(q0 + r) * DH + d;
        qx = to_f32(q[g]);
        dox = to_f32(dout[g]);
      }
      qs[r * RS + d] = qx;
      dos[r * RS + d] = dox;
    }
    for (int r = tid; r < BQ; r += NT) {
      const bool ok = q0 + r < T_len;
      lse_s[r] = ok ? lse[(size_t)bh * T_len + q0 + r] : 1e30f;
      dsum_s[r] = ok ? dsum[(size_t)bh * T_len + q0 + r] : 0.f;
    }

    float dq_acc[CH];
#pragma unroll
    for (int x = 0; x < CH; ++x) dq_acc[x] = 0.f;

    // causal, or the distance domain alone: only key tiles at or below the
    // diagonal hold a visible pair or a distance >= 0
    const int kt_last = (causal || !KEY_COLUMN) ? qt : n_tiles - 1;
    for (int kt = 0; kt <= kt_last; ++kt) {
      const int k0 = kt * BK;
      const int nk = min(BK, T_len - k0);
      const int dist0 = q0 - k0 - (BK - 1);  // distance of band row 0
      const bool band_live = kt <= qt;        // some distance of the pair is >= 0
      __syncthreads();  // the previous pair's phases are done with the tiles
      for (int x = tid; x < BK * DH; x += NT) {
        const int j = x / DH, d = x - j * DH;
        float kx = 0.f, vx = 0.f;
        if (j < nk) {
          const size_t g = base + (size_t)(k0 + j) * DH + d;
          kx = to_f32(k[g]);
          vx = to_f32(v[g]);
        }
        ks[j * RS + d] = kx;
        vs[j * RS + d] = vx;
      }
      for (int j = tid; j < BK; j += NT)
        live[j] = (j < nk && !(pad != nullptr && pad[(size_t)b * T_len + k0 + j])) ? 1.f : 0.f;
      for (int x = tid; x < BAND * DH; x += NT) {
        const int u = x / DH, d = x - u * DH;
        const int dist = dist0 + u;
        float ev = 0.f;
        if (dist >= 0 && dist < max_seq) ev = to_f32(e[(size_t)(max_seq - 1 - dist) * DH + d]);
        es[u * RS + d] = ev;
      }
      __syncthreads();

      // phases A and A_d, for query row row4
      {
        float qr[DH], dor[DH];
        const float4* q4 = reinterpret_cast<const float4*>(qs + row4 * RS);
        const float4* do4 = reinterpret_cast<const float4*>(dos + row4 * RS);
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 a = q4[d4], g = do4[d4];
          qr[4 * d4] = a.x; qr[4 * d4 + 1] = a.y; qr[4 * d4 + 2] = a.z; qr[4 * d4 + 3] = a.w;
          dor[4 * d4] = g.x; dor[4 * d4 + 1] = g.y; dor[4 * d4 + 2] = g.z; dor[4 * d4 + 3] = g.w;
        }
        const float lse_i = lse_s[row4], dsum_i = dsum_s[row4];
        if constexpr (KEY_COLUMN) {
          // A: keys c + 4r by column; COLUMN unskews j <= i into the band
          for (int r = 0; r < BK / 4; ++r) {
            const int jj = c + 4 * r;
            const int u = row4 - jj + BK - 1;
            float ds = 0.f;
            if (i < T_len && live[jj] != 0.f && !(causal && k0 + jj > i)) {
              float s, dp;
              score_dot<DH>(qr, dor, ks + jj * RS, es + u * RS, vs + jj * RS, s, dp);
              const float p = expf(s * scale - lse_i);  // lse = 1e30 (no visible key) gives 0
              ds = p * (dp - dsum_i) * scale;
            }
            dss[row4 * PS + jj] = ds;
            if constexpr (MODE == COLUMN) band[row4 * BS + u] = (k0 + jj <= i) ? ds : 0.f;
          }
        }
        if constexpr (MODE != COLUMN) {
          // A_d: distances u = row4 + c + 4r of the band, key jj = row4 + BK - 1 - u
          if (band_live) {
            for (int r = 0; r < BK / 4; ++r) {
              const int u = row4 + c + 4 * r;
              const int jj = row4 + BK - 1 - u;
              float ds = 0.f;
              if (i < T_len && live[jj] != 0.f && dist0 + u >= 0) {
                float s, dp;
                score_dot<DH>(qr, dor, ks + jj * RS, es + u * RS, vs + jj * RS, s, dp);
                const float p = expf(s * scale - lse_i);
                ds = p * (dp - dsum_i) * scale;
              }
              band[row4 * BS + u] = ds;
            }
          }
        }
      }
      __syncthreads();

      // phase C: dQ_i += dS' K (by key) and band . E (by distance), columns c
      if (i < T_len) {
        if constexpr (KEY_COLUMN) {
#pragma unroll 4
          for (int jj = 0; jj < BK; ++jj) {
            const float ds = dss[row4 * PS + jj];
            const float4* k4 = reinterpret_cast<const float4*>(ks + jj * RS + c * CH);
#pragma unroll
            for (int x4 = 0; x4 < CH / 4; ++x4) {
              const float4 kk = k4[x4];
              dq_acc[4 * x4 + 0] = fmaf(ds, kk.x, dq_acc[4 * x4 + 0]);
              dq_acc[4 * x4 + 1] = fmaf(ds, kk.y, dq_acc[4 * x4 + 1]);
              dq_acc[4 * x4 + 2] = fmaf(ds, kk.z, dq_acc[4 * x4 + 2]);
              dq_acc[4 * x4 + 3] = fmaf(ds, kk.w, dq_acc[4 * x4 + 3]);
            }
          }
        }
        if (band_live) {
#pragma unroll 4
          for (int uu = 0; uu < BK; ++uu) {
            const int u = row4 + uu;
            const float ds = band[row4 * BS + u];
            const float4* e4 = reinterpret_cast<const float4*>(es + u * RS + c * CH);
#pragma unroll
            for (int x4 = 0; x4 < CH / 4; ++x4) {
              const float4 ee = e4[x4];
              dq_acc[4 * x4 + 0] = fmaf(ds, ee.x, dq_acc[4 * x4 + 0]);
              dq_acc[4 * x4 + 1] = fmaf(ds, ee.y, dq_acc[4 * x4 + 1]);
              dq_acc[4 * x4 + 2] = fmaf(ds, ee.z, dq_acc[4 * x4 + 2]);
              dq_acc[4 * x4 + 3] = fmaf(ds, ee.w, dq_acc[4 * x4 + 3]);
            }
          }
        }
      }

      // phase D: dE at distance dist0 + u += sum over the band's column u
      // of band[a][u] q_a, rows a in [u - BK + 1, u]
      if (band_live) {
        for (int w = tid; w < BAND * 4; w += NT) {
          const int u = w >> 2, cc = w & 3;
          const int dist = dist0 + u;
          if (dist < 0 || dist >= T_len) continue;
          const int a_lo = max(0, u - BK + 1), a_hi = min(BQ - 1, u);
          float acc[CH];
#pragma unroll
          for (int x = 0; x < CH; ++x) acc[x] = 0.f;
          for (int a = a_lo; a <= a_hi; ++a) {
            const float ds = band[a * BS + u];
            const float4* q4 = reinterpret_cast<const float4*>(qs + a * RS + cc * CH);
#pragma unroll
            for (int x4 = 0; x4 < CH / 4; ++x4) {
              const float4 qq = q4[x4];
              acc[4 * x4 + 0] = fmaf(ds, qq.x, acc[4 * x4 + 0]);
              acc[4 * x4 + 1] = fmaf(ds, qq.y, acc[4 * x4 + 1]);
              acc[4 * x4 + 2] = fmaf(ds, qq.z, acc[4 * x4 + 2]);
              acc[4 * x4 + 3] = fmaf(ds, qq.w, acc[4 * x4 + 3]);
            }
          }
          float* dst = dep + (size_t)dist * DH + cc * CH;
#pragma unroll
          for (int x = 0; x < CH; ++x) dst[x] += acc[x];
        }
      }
    }

    if (i < T_len) {
      const size_t g = base + (size_t)i * DH + c * CH;
#pragma unroll
      for (int x = 0; x < CH; ++x) dq[g + x] = from_f32<T>(dq_acc[x]);
    }
  }
}

// dE[row] = sum over b*h of de_part[bh][max_seq - 1 - row], zero for rows
// whose distance is >= T; in a fixed order, so the result is deterministic.
template <typename T>
__global__ void de_reduce_kernel(const float* __restrict__ de_part, T* __restrict__ de,
                                 int BH, int T_len, int max_seq, int dh) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= max_seq * dh) return;
  const int row = x / dh, d = x - row * dh;
  const int dist = max_seq - 1 - row;
  float acc = 0.f;
  if (dist < T_len) {
    const float* src = de_part + (size_t)dist * dh + d;
    for (int bh = 0; bh < BH; ++bh) acc += src[(size_t)bh * T_len * dh];
  }
  de[x] = from_f32<T>(acc);
}

// ---------------------------------------------------------------------------
// the bf16 path of COLUMN and DIST: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NWARP = 8;
constexpr int NTH = 32 * NWARP;
constexpr int SPLIT = 2;      // blocks a (b, h): block s takes query tiles s, s + SPLIT, ...
constexpr int PS = BK + 8;    // bf16 row stride of the dS' tile
constexpr int DS = BQ + BK + 8;  // bf16 row stride of the distance-domain tile dsd
constexpr int WB = 48;        // band rows a warp multiplies in phase A: its 47 distances
constexpr int SMEM_SM = 233472;  // shared memory of an SM, 1 KB a block reserved
constexpr float LOG2E = 1.4426950408889634f;

template <int DH, int MODE>
struct Layout {
  static constexpr int RS = DH + 8;   // bf16 row stride: an odd number of 16-byte units
  static constexpr int CPR = DH / 8;  // 16-byte chunks a row
  // a warp's f32 scratch row: the band (48 columns), and in DIST also S and
  // dP by key (columns 0.. and DP_AT..)
  static constexpr int DP_AT = 36;
  static constexpr int WBS = MODE == DIST ? 72 : WB + 8;
  static constexpr int KV_BYTES = 2 * BK * RS * 2 + BK * 4;    // K, V, key flags
  static constexpr int Q_BYTES = 2 * BQ * RS * 2 + 2 * BQ * 4;  // Q, dO, lse, dsum
  static constexpr int bytes(int stages) {
    return stages * (KV_BYTES + Q_BYTES + 2 * 64 * RS * 2) + BQ * PS * 2 + BQ * DS * 2 +
           NWARP * 16 * WBS * 4;
  }
  // two ring stages (the next pair's copies under this pair's products)
  // where two blocks an SM still fit
  static constexpr int STAGES = 2 * (bytes(2) + 1024) <= SMEM_SM ? 2 : 1;
  static constexpr int NSLOT = 2 * STAGES;  // E chunks of 64 rows: two a pair in work
  static constexpr int Q_AT = STAGES * KV_BYTES;
  static constexpr int E_AT = Q_AT + STAGES * Q_BYTES;
  static constexpr int DSS_AT = E_AT + NSLOT * 64 * RS * 2;
  static constexpr int DSD_AT = DSS_AT + BQ * PS * 2;
  static constexpr int SCR_AT = DSD_AT + BQ * DS * 2;
  static constexpr int TOTAL = SCR_AT + NWARP * 16 * WBS * 4;
  static_assert(TOTAL == bytes(STAGES), "layout");
  // two blocks an SM at d_head <= 48 (128 registers a thread), as kernel 4
  static constexpr int MIN_BLOCKS = DH <= 48 && 2 * (TOTAL + 1024) <= SMEM_SM ? 2 : 1;
};

// From flash_rel_attn_bwd.cu (namespace tc), unchanged: shared-memory
// addresses, cp.async copies, ldmatrix, mma.sync and mma_kn.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared, zeros where !ok (no byte is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[n] += A (16 x 16, fragments a) times the 16 x (8 NH) slab of a
// row-major [k][n] shared tile at `b` (row stride rs, first k row and
// column already applied), read transposed by ldmatrix: lane rows
// (lane & 7) + 8 ((lane >> 3) & 1), 8-column groups by lane >> 4
template <int NH>
__device__ __forceinline__ void mma_kn(float (*acc)[4], const uint32_t* a,
                                       const __nv_bfloat16* b, int rs, int lane) {
  const __nv_bfloat16* row = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * rs;
#pragma unroll
  for (int n = 0; n + 1 < NH; n += 2) {
    uint32_t bf[4];
    ldsm_x4_t(bf, row + 8 * n + (lane >> 4) * 8);
    mma(acc[n], a, bf[0], bf[1]);
    mma(acc[n + 1], a, bf[2], bf[3]);
  }
  if constexpr (NH % 2 == 1) {
    uint32_t bf[2];
    ldsm_x2_t(bf, row + 8 * (NH - 1));
    mma(acc[NH - 1], a, bf[0], bf[1]);
  }
}

// Block s of the SPLIT a (b, h) sweeps query tiles s, s + SPLIT, ... and,
// inside, the key tiles each sees, ascending (see the note at the top).
template <int DH, int MODE>
__global__ void __launch_bounds__(NTH, Layout<DH, MODE>::MIN_BLOCKS)
flash_bwd_q_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ e,
                      const uint8_t* __restrict__ pad, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dq, float* __restrict__ de_part, int H,
                      int T_len, int max_seq, int causal, float scale, float scale_log2) {
  static_assert(MODE == COLUMN || MODE == DIST, "REL keeps the CUDA-core kernel");
  static_assert(BQ == 64 && BK == 64, "the band moves one 64-row chunk a key tile");
  using L = Layout<DH, MODE>;
  constexpr int RS = L::RS, CPR = L::CPR, KS = DH / 16, NH = DH / 16;  // NH: n-tiles a half
  constexpr int WBS = L::WBS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / SPLIT, sp = blockIdx.x % SPLIT, b = bh / H;
  const size_t base = (size_t)bh * T_len * DH, rbase = (size_t)bh * T_len;
  // this block's dE partial [T][DH], row = distance
  float* dep = de_part + ((size_t)sp * (gridDim.x / SPLIT) + bh) * T_len * DH;
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem + L::DSS_AT);  // dS' [BQ][PS]
  __nv_bfloat16* dsd = reinterpret_cast<__nv_bfloat16*>(smem + L::DSD_AT);  // [BQ][DS]
  float* scr = reinterpret_cast<float*>(smem + L::SCR_AT) + warp * 16 * WBS;
  auto kv_buf = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem + s * L::KV_BYTES); };
  auto q_buf = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::Q_AT + s * L::Q_BYTES);
  };

  const int n_tiles = (T_len + BQ - 1) / BQ;
  auto kt_last = [&](int qt) { return causal ? qt : n_tiles - 1; };
  // The last query tile of this block reaches every distance below its
  // q0 + BQ and writes each; rows above stay zero in the partial.
  const int last_qt = sp < n_tiles ? sp + (n_tiles - 1 - sp) / SPLIT * SPLIT : -1;
  const int reach = min(T_len, (last_qt + 1) * BQ);
  for (int x = reach * DH + tid; x < T_len * DH; x += NTH) dep[x] = 0.f;
  for (int x = tid; x < BQ * DS; x += NTH) dsd[x] = __float2bfloat16(0.f);
  if (sp >= n_tiles) return;

  // The E band of a pair (row u at distance q0 - k0 - (BK - 1) + u, zero
  // where negative) is two chunks of 64 rows in a ring of NSLOT. The next
  // key tile's band starts 64 distances lower, so its upper chunk is this
  // pair's lower one and only its lower chunk is copied (both at a query
  // tile's first pair). Chunk c sits in slot c % NSLOT.
  __nv_bfloat16* e_ring = reinterpret_cast<__nv_bfloat16*>(smem + L::E_AT);
  auto e_slot = [&](int c) { return e_ring + (c % L::NSLOT) * 64 * RS; };
  int n_chunks = 0;  // chunks copied so far
  auto load_chunk = [&](int c, int dist_first) {
    __nv_bfloat16* dst = e_slot(c);
    for (int x = tid; x < 64 * CPR; x += NTH) {
      const int u = x / CPR, cc = x - u * CPR;
      const int dist = dist_first + u;
      const bool ok = dist >= 0 && dist < max_seq;
      cp_async16(dst + u * RS + cc * 8, e + (size_t)(ok ? max_seq - 1 - dist : 0) * DH + cc * 8,
                 ok);
    }
  };
  // pair (qt, kt) into ring stage s: at a query tile's first pair its Q,
  // dO, lse and dsum; always K, V and the key flags; where the pair has a
  // distance >= 0 (kt <= qt), the band's new chunks. (lo, hi) come back as
  // the band's chunks, given the last pair's lower one in lo.
  auto load = [&](int qt, int kt, int s, int& lo, int& hi) {
    const int k0 = kt * BK, q0 = qt * BQ;
    const int dist0 = q0 - k0 - (BK - 1);
    if (kt <= qt) {
      if (kt == 0) {
        hi = n_chunks++;
        load_chunk(hi, dist0 + 64);
      } else {
        hi = lo;
      }
      lo = n_chunks++;
      load_chunk(lo, dist0);
    }
    if (kt == 0) {
      __nv_bfloat16* qs = q_buf(qt / SPLIT % L::STAGES);
      __nv_bfloat16* dos = qs + BQ * RS;
      float* lse_s = reinterpret_cast<float*>(dos + BQ * RS);
      for (int x = tid; x < BQ * CPR; x += NTH) {
        const int r = x / CPR, c = x - r * CPR;
        const bool ok = q0 + r < T_len;
        const size_t at = base + (size_t)(ok ? q0 + r : 0) * DH + c * 8;
        cp_async16(qs + r * RS + c * 8, q + at, ok);
        cp_async16(dos + r * RS + c * 8, dout + at, ok);
      }
      for (int r = tid; r < BQ; r += NTH) {
        const bool ok = q0 + r < T_len;
        const size_t at = rbase + (ok ? q0 + r : 0);
        cp_async4(lse_s + r, lse + at, ok);
        cp_async4(lse_s + BQ + r, dsum + at, ok);
      }
    }
    __nv_bfloat16* ks = kv_buf(s);
    __nv_bfloat16* vs = ks + BK * RS;
    float* live = reinterpret_cast<float*>(vs + BK * RS);
    for (int x = tid; x < BK * CPR; x += NTH) {
      const int j = x / CPR, c = x - j * CPR;
      const bool ok = k0 + j < T_len;
      const size_t at = base + (size_t)(ok ? k0 + j : 0) * DH + c * 8;
      cp_async16(ks + j * RS + c * 8, k + at, ok);
      cp_async16(vs + j * RS + c * 8, v + at, ok);
    }
    for (int j = tid; j < BK; j += NTH)
      live[j] =
          (k0 + j < T_len && !(pad != nullptr && pad[(size_t)b * T_len + k0 + j])) ? 1.f : 0.f;
    cp_commit();
  };

  float qacc[NH][4];    // dQ of rows 16 (w / 2).., channel half w % 2, over the query tile
  float ecarry[NH][4];  // dE of the lower distance block, for the next pair
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) qacc[n][x] = ecarry[n][x] = 0.f;
  const int ra = 16 * (warp & 3), ka = 32 * (warp >> 2), ub = ra - ka + 32;  // phase A
  const int mq = warp >> 1, c0 = (warp & 1) * (DH / 2);                        // phase B
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;  // A row-major
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;  // B, A^T

  int qt = sp, kt = 0, nq = qt, nk = kt;
  auto next = [&](int& a, int& c) {
    if (++c > kt_last(a)) {
      a += SPLIT;
      c = 0;
    }
  };
  next(nq, nk);
  int lo = 0, hi = 0, nlo = 0, nhi = 0;  // this pair's band chunks, and the next pair's
  load(qt, kt, 0, lo, hi);
  for (int pair = 0;; ++pair) {
    const int s = pair % L::STAGES;
    const bool more = nq < n_tiles;
    cp_wait<0>();
    __syncthreads();  // this pair's tiles have landed; every warp is done with the last pair
    // the next pair into the other stage, whose last reader was the last pair
    nlo = lo;
    nhi = hi;
    if (L::STAGES > 1 && more) load(nq, nk, (pair + 1) % L::STAGES, nlo, nhi);
    const int k0 = kt * BK, q0 = qt * BQ, dist0 = q0 - k0 - (BK - 1);
    const bool band = kt <= qt;  // some distance of the pair is >= 0
    const __nv_bfloat16* ks = kv_buf(s);
    const __nv_bfloat16* vs = ks + BK * RS;
    const float* live = reinterpret_cast<const float*>(vs + BK * RS);
    const __nv_bfloat16* qs = q_buf(qt / SPLIT % L::STAGES);
    const __nv_bfloat16* dos = qs + BQ * RS;
    const float* lse_s = reinterpret_cast<const float*>(dos + BQ * RS);
    const float* dsum_s = lse_s + BQ;
    const __nv_bfloat16* elo = e_slot(lo);
    const __nv_bfloat16* ehi = e_slot(hi);
    // band row r (a 16-row group never straddles the chunks)
    auto erow = [&](int r) { return (r < 64 ? elo : ehi) + (r & 63) * RS; };

    // ---- phase A
    {
      float sacc[4][4], bacc[WB / 8][4], dpacc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) sacc[n][x] = dpacc[n][x] = 0.f;
#pragma unroll
      for (int n = 0; n < WB / 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) bacc[n][x] = 0.f;
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        uint32_t qa[4], da[4];
        ldsm_x4(qa, qs + (ra + lrow) * RS + st * 16 + lcol);
        ldsm_x4(da, dos + (ra + lrow) * RS + st * 16 + lcol);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, ks + (ka + np * 16 + brow) * RS + st * 16 + bcol);
          mma(sacc[2 * np], qa, bf[0], bf[1]);
          mma(sacc[2 * np + 1], qa, bf[2], bf[3]);
          ldsm_x4(bf, vs + (ka + np * 16 + brow) * RS + st * 16 + bcol);
          mma(dpacc[2 * np], da, bf[0], bf[1]);
          mma(dpacc[2 * np + 1], da, bf[2], bf[3]);
        }
        if (band) {
#pragma unroll
          for (int np = 0; np < WB / 16; ++np) {
            uint32_t bf[4];
            ldsm_x4(bf, erow(ub + np * 16 + brow) + st * 16 + bcol);
            mma(bacc[2 * np], qa, bf[0], bf[1]);
            mma(bacc[2 * np + 1], qa, bf[2], bf[3]);
          }
        }
      }
      if (band) {
#pragma unroll
        for (int n = 0; n < WB / 8; ++n) {
          *reinterpret_cast<float2*>(scr + g * WBS + 8 * n + 2 * t) =
              make_float2(bacc[n][0], bacc[n][1]);
          *reinterpret_cast<float2*>(scr + (g + 8) * WBS + 8 * n + 2 * t) =
              make_float2(bacc[n][2], bacc[n][3]);
        }
      }
      __syncwarp();
      // P and dS' by key column
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h, il = ra + r, i = q0 + il, c = 8 * n + 2 * t, jj = ka + c;
          float ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            // the skew: Srel of (row r, key c + x) is band column r - (c + x) + 31
            const float sc = sacc[n][2 * h + x] + (band ? scr[r * WBS + r - c - x + 31] : 0.f);
            const bool ok = i < T_len && live[jj + x] != 0.f && !(causal && k0 + jj + x > i);
            const float p = ok ? exp2f(sc * scale_log2 - lse_s[il] * LOG2E) : 0.f;
            ds[x] = p * (dpacc[n][2 * h + x] - dsum_s[il]) * scale;
          }
          const uint32_t dsb = pack_bf16(ds[0], ds[1]);
          *reinterpret_cast<uint32_t*>(dss + il * PS + jj) = dsb;
          if constexpr (MODE == COLUMN) {
            if (band) {  // the unskew: key jj + x sits at u - x
              const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dsb);
              const __nv_bfloat16 zero = __float2bfloat16(0.f);
              const int u = il - jj + BK - 1;
              dsd[il * DS + u] = dist0 + u >= 0 ? d2.x : zero;
              dsd[il * DS + u - 1] = dist0 + u - 1 >= 0 ? d2.y : zero;
            }
          }
        }
      if constexpr (MODE == DIST) {
        if (band) {
          // dS by distance: S and dP by key into the scratch, read back at
          // key j = i - d beside the bias by distance, the band product
          __syncwarp();  // every lane has read its band values
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float* row = scr + (g + 8 * h) * WBS + 8 * n + 2 * t;
              *reinterpret_cast<float2*>(row) = make_float2(sacc[n][2 * h], sacc[n][2 * h + 1]);
              *reinterpret_cast<float2*>(row + L::DP_AT) =
                  make_float2(dpacc[n][2 * h], dpacc[n][2 * h + 1]);
            }
          __syncwarp();
#pragma unroll
          for (int n = 0; n < WB / 8; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                // band column ul of row r is key jl = r + 31 - ul of this warp's 32
                const int r = g + 8 * h, ul = 8 * n + 2 * t + x, jl = r + 31 - ul;
                if (jl < 0 || jl > 31) continue;
                const int il = ra + r, i = q0 + il, u = ub + ul;
                const bool ok = i < T_len && live[ka + jl] != 0.f && dist0 + u >= 0;
                const float sd = scr[r * WBS + jl] + bacc[n][2 * h + x];
                const float p = ok ? exp2f(sd * scale_log2 - lse_s[il] * LOG2E) : 0.f;
                dsd[il * DS + u] =
                    __float2bfloat16(p * (scr[r * WBS + L::DP_AT + jl] - dsum_s[il]) * scale);
              }
        }
      }
    }
    __syncthreads();

    // ---- phase B: dQ += dS' K (+ dsd E_band), rows 16 mq.., in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, dss + (16 * mq + lrow) * PS + 16 * kk + lcol);
      mma_kn<NH>(qacc, a, ks + 16 * kk * RS + c0, RS, lane);
    }
    if (band) {
      // The dE partial rows this warp adds to are loaded first, so their
      // latency passes under the products. The upper block (distances
      // 16 (mq + 4)..) is complete after this pair and goes to the
      // partial; the lower one is the next pair's upper block, carried in
      // registers (ecarry) and written at the query tile's last band pair.
      // Rows below `fresh` hold this block's earlier query tiles' sums.
      const bool last = kt == qt;
      const int fresh = qt >= SPLIT ? min(T_len, (qt - SPLIT + 1) * BQ) : 0;
      float2 eold[2][2][NH];
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dist = dist0 + 16 * (mq + 4 * hb) + g + 8 * h;
#pragma unroll
          for (int n = 0; n < NH; ++n)
            eold[hb][h][n] =
                (hb == 1 || last) && dist >= 0 && dist < fresh
                    ? *reinterpret_cast<const float2*>(dep + (size_t)dist * DH + c0 + 8 * n + 2 * t)
                    : make_float2(0.f, 0.f);
        }
      // dsd row i is nonzero at u in [i, i + BK - 1]
#pragma unroll
      for (int ku = mq; ku <= mq + BK / 16; ++ku) {
        uint32_t a[4];
        ldsm_x4(a, dsd + (16 * mq + lrow) * DS + 16 * ku + lcol);
        mma_kn<NH>(qacc, a, erow(16 * ku) + c0, RS, lane);
      }
#pragma unroll
      for (int hb = 1; hb >= 0; --hb) {  // dE += dsd^T Q, distances 16 ublk.. (upper first)
        const int ublk = mq + 4 * hb;
        float eacc[NH][4];
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) eacc[n][x] = hb == 1 ? ecarry[n][x] : 0.f;
        // rows i reach u in [i, i + BK - 1]: query steps ublk - 4 .. ublk
        for (int kq = max(0, ublk - BK / 16); kq <= min(BQ / 16 - 1, ublk); ++kq) {
          uint32_t a[4];
          ldsm_x4_t(a, dsd + (16 * kq + brow) * DS + 16 * ublk + bcol);
          mma_kn<NH>(eacc, a, qs + 16 * kq * RS + c0, RS, lane);
        }
        if (hb == 0) {
#pragma unroll
          for (int n = 0; n < NH; ++n)
#pragma unroll
            for (int x = 0; x < 4; ++x) ecarry[n][x] = last ? 0.f : eacc[n][x];
          if (!last) continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dist = dist0 + 16 * ublk + g + 8 * h;
          if (dist < 0 || dist >= T_len) continue;
#pragma unroll
          for (int n = 0; n < NH; ++n)
            *reinterpret_cast<float2*>(dep + (size_t)dist * DH + c0 + 8 * n + 2 * t) =
                make_float2(eold[hb][h][n].x + eacc[n][2 * h],
                            eold[hb][h][n].y + eacc[n][2 * h + 1]);
        }
      }
    }

    if (kt == kt_last(qt)) {  // the query tile's last pair: its dQ, cast once
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = q0 + 16 * mq + g + 8 * h;
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          if (i < T_len)
            *reinterpret_cast<uint32_t*>(dq + base + (size_t)i * DH + c0 + 8 * n + 2 * t) =
                pack_bf16(qacc[n][2 * h], qacc[n][2 * h + 1]);
          qacc[n][2 * h] = qacc[n][2 * h + 1] = 0.f;
        }
      }
    }
    if (!more) break;
    qt = nq;
    kt = nk;
    next(nq, nk);
    if (L::STAGES == 1) {
      __syncthreads();  // every warp is done with the one stage
      load(qt, kt, 0, lo, hi);
    } else {
      lo = nlo;
      hi = nhi;
    }
  }
}

}  // namespace tc


template <typename T, int DH, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dq, void* de,
                   void* de_part, int B, int H, int T_len, int max_seq, int causal, float scale,
                   cudaStream_t stream) {
  cudaError_t err;
  int parts = B * H;  // dE partials, one a block
  if constexpr (std::is_same<T, __nv_bfloat16>::value && MODE != REL) {
    using B16 = __nv_bfloat16;
    auto kernel = tc::flash_bwd_q_tc_kernel<DH, MODE>;
    const int smem = tc::Layout<DH, MODE>::TOTAL;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    parts = B * H * tc::SPLIT;
    kernel<<<parts, tc::NTH, smem, stream>>>(
        static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
        static_cast<const B16*>(e), static_cast<const uint8_t*>(pad), static_cast<const B16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<B16*>(dq),
        static_cast<float*>(de_part), H, T_len, max_seq, causal, scale, scale * tc::LOG2E);
  } else {
    auto kernel = flash_rel_attn_bwd_q_kernel<T, DH, MODE>;
    const size_t smem = smem_bytes<DH>();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<B * H, Tile<DH>::NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(e), static_cast<const uint8_t*>(pad), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<T*>(dq),
        static_cast<float*>(de_part), H, T_len, max_seq, causal, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = max_seq * DH, threads = 256;
  de_reduce_kernel<T><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(de_part), static_cast<T*>(de), parts, T_len, max_seq, DH);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const void* q, const void* k, const void* v, const void* e, const void* pad,
             const void* dout, const void* lse, const void* dsum, void* dq, void* de,
             void* de_part, int B, int H, int T_len, int dh, int max_seq, int causal, int dtype,
             float scale, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Q_CASE(TYPE, D)                                                                       \
  if (dh == D)                                                                                \
    return launch<TYPE, D, MODE>(q, k, v, e, pad, dout, lse, dsum, dq, de, de_part, B, H,     \
                                 T_len, max_seq, causal, scale, s);
  if (dtype == 0) {
    Q_CASE(float, 16) Q_CASE(float, 32) Q_CASE(float, 48) Q_CASE(float, 64)
    Q_CASE(float, 96) Q_CASE(float, 128)
  } else if (dtype == 1) {
    Q_CASE(__nv_bfloat16, 16) Q_CASE(__nv_bfloat16, 32)
    Q_CASE(__nv_bfloat16, 48) Q_CASE(__nv_bfloat16, 64)
    Q_CASE(__nv_bfloat16, 96) Q_CASE(__nv_bfloat16, 128)
  }
#undef Q_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when both launches were accepted. dtype: 0 =
// float32, 1 = bfloat16 (q, k, v, e, dout, dq, de); lse and dsum are f32
// [B, H, T]; pad may be null. de_part is f32 scratch [2*B*H, T, dh], filled
// by the kernel (the bf16 COLUMN and DIST paths use all of it, one partial
// a block; the others the first B*H). scale is c = 1/sqrt(d_head) of the
// caller's heads, which may have fewer columns than dh (zero columns padded
// up to an instantiated dh add nothing). Launches on `stream` and does not
// synchronise.

// dQ and dE, by key column (the TPU's _bwd_dq_de_kernel).
int flash_rel_attn_bwd_dq_de(const void* q, const void* k, const void* v, const void* e,
                             const void* pad, const void* dout, const void* lse,
                             const void* dsum, void* dq, void* de, void* de_part, int B, int H,
                             int T_len, int dh, int max_seq, int causal, int dtype, float scale,
                             void* stream) {
  return dispatch<COLUMN>(q, k, v, e, pad, dout, lse, dsum, dq, de, de_part, B, H, T_len, dh,
                          max_seq, causal, dtype, scale, stream);
}

// dQ and dE, the relative terms by distance (the TPU's _bwd_dq_de_dist_kernel).
int flash_rel_attn_bwd_dq_de_dist(const void* q, const void* k, const void* v, const void* e,
                                  const void* pad, const void* dout, const void* lse,
                                  const void* dsum, void* dq, void* de, void* de_part, int B,
                                  int H, int T_len, int dh, int max_seq, int causal, int dtype,
                                  float scale, void* stream) {
  return dispatch<DIST>(q, k, v, e, pad, dout, lse, dsum, dq, de, de_part, B, H, T_len, dh,
                        max_seq, causal, dtype, scale, stream);
}

// dQ_rel (into dq) and dE, by distance (the TPU's _bwd_de_dqrel_kernel).
int flash_rel_attn_bwd_de_dqrel(const void* q, const void* k, const void* v, const void* e,
                                const void* pad, const void* dout, const void* lse,
                                const void* dsum, void* dq, void* de, void* de_part, int B,
                                int H, int T_len, int dh, int max_seq, int causal, int dtype,
                                float scale, void* stream) {
  return dispatch<REL>(q, k, v, e, pad, dout, lse, dsum, dq, de, de_part, B, H, T_len, dh,
                       max_seq, causal, dtype, scale, stream);
}

const char* flash_rel_attn_bwd_q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
