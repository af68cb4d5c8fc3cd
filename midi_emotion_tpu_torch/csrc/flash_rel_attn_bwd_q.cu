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
// bf16 COLUMN, DIST and REL (kernels 5, 6 and 8: `fused` with
// DQDE=column or dist, and `split`): Hopper's warpgroup products and TMA
// (wg::flash_bwd_q_wg_tc_kernel, on the building blocks of hopper_sm90.cuh
// that kernel 4 uses too). Bound on the H100: operations; at B 8, H 16,
// T 1216, d_head 48 the products the visible pairs need take 0.0550 ms
// (COLUMN, DIST) and 0.0458 ms (REL) at 989 TFLOP/s. The TPU needed two
// kernels for dQ and dE because the unskew of the key-column dS into the
// distance band, the adjoint of the skew, is a shear Mosaic cannot lower
// as one operation: _bwd_dq_de_kernel (COLUMN) builds it from static
// slice-and-concat rolls over the band, and _bwd_dq_de_dist_kernel (DIST)
// avoids it by forming dS by distance a second time, a second softmax
// over the band. Here the unskew is a shared-memory scatter, and both
// start from the same f32 q.k + q.E and dO.v: the scatter of the rounded
// key-column dS' is the bf16 tile the TPU's COLUMN kernel unskews (ds
// rounded, masked at b <= a, shifted with no arithmetic) and the dS by
// distance the DIST kernel rounds to bf16, with no second exp (P's exps,
// 99.6 M a call at that shape, take 0.025 ms at the SFU's 16 results a
// clock an SM). So the two compute the same products on the same key
// tiles, and COLUMN launches DIST's instantiation: one kernel on the card,
// kernel 5's outputs bit for bit kernel 6's. REL is DIST without
// dQ's key term: no key-column dS' tile, no dS' K product, and only key
// tiles at or below the diagonal, since the relative terms vanish above it
// even in the non-causal (regression) model. Two warpgroups share each
// tile pair, every product a wgmma with f32 sums:
//   phase A, warpgroup h (keys 32 h ..): S = Q K_h^T and dP = dO V_h^T
//     (m64n32), and the band Q E^T over the 96 band rows its keys reach
//     (m64n96), skewed into Srel through a per-warp scratch; P = exp(s -
//     lse) and dS' = c P (dP - dsum) in f32, dS' rounded to bf16 into a
//     shared tile (DIST) and scattered by distance into dsd [i][64 - i + j]
//     (0 at a negative distance; a band pair rewrites every entry a key
//     reaches, the others stay 0); fence.proxy.async, then the barrier that
//     hands the tiles to phase B;
//   phase B, warpgroup 0: dQ += dS' K (DIST) + dsd E_band (K and the band
//     read MN-major), in registers across the query tile's key tiles and
//     written once; warpgroup 1: dE += dsd^T Q over the band's two
//     64-distance halves (dsd and Q read MN-major). The upper half is
//     complete after the pair and added to this block's f32 partial (by
//     distance); the lower half is the next key tile's upper one and stays
//     in registers.
// A block owns alternate query tiles of one (b, h) (two a (b, h), each
// with its own dE partial, summed in block order by de_reduce_kernel: two
// calls give bitwise-equal dE), and walks the key
// tiles each sees: DIST 0..qt causal and every tile non-causal (the band's
// products only up to the diagonal), REL 0..qt in both models. Thread 0
// copies each pair's K, V and 128-row E band (row v at distance q0 - k0 +
// 64 - v, zero where negative) into a ring of two stages, and each query
// tile's Q and dO into one or two slots, by TMA under mbarriers, refilling
// a slot right after the barrier that ends its last reader. Two blocks an
// SM up to d_head 48 (128 registers a thread), one from 64.
//
// f32 (the checks' path, held to 1e-4; TF32 keeps about three digits), in
// every mode: the CUDA cores, simple and correct first:
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
// The bf16 kernel takes Hopper's building blocks (TMA, mbarriers, wgmma)
// from hopper_sm90.cuh, which kernels/build.py hashes into this library's
// name.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_sm90.cuh"

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
// the bf16 path of DIST and REL: Hopper's wgmma, TMA and mbarriers
// ---------------------------------------------------------------------------

// The switches of scripts/torch_query_sweep_ablation.py, which defines
// them ahead of a copy of this file; the libraries as built define none,
// so each takes the value below.
#ifndef BWD_Q_SPLIT
#define BWD_Q_SPLIT 2       // blocks a (b, h)
#endif
#ifndef BWD_Q_ONE_BLOCK
#define BWD_Q_ONE_BLOCK 0   // 1: one block an SM at every d_head
#endif
#ifndef BWD_Q_HALF_BAND
#define BWD_Q_HALF_BAND -1  // phase A's band in halves: -1 at two blocks an SM, 0 never, 1 always
#endif
#ifndef BWD_Q_DE_PARTIAL
#define BWD_Q_DE_PARTIAL 2  // the dE partial's rows: 2 read and written; 1 written over, 0
#endif                      // neither (both give a wrong dE: they time the traffic)

namespace wg {

using namespace sm90;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int EB = BQ + BK;   // band rows staged per tile pair (the first one unused)
constexpr int NCW = 8;        // warps: two warpgroups
constexpr int NTH = 32 * NCW;
constexpr int SPLIT = BWD_Q_SPLIT;  // blocks a (b, h), each with its own dE partial
constexpr int WB = 48;        // band columns a warp reads in phase A: its 47 distances
constexpr int WBS = WB + 8;   // row stride of a warp's band scratch (floats)
constexpr int ALIGN = 256;    // the 32-byte swizzle's period: slabs start on it
constexpr int SMEM_SM = 233472;  // shared memory of an SM, 1 KB a block reserved
constexpr float LOG2E = 1.4426950408889634f;

template <int DH, int MODE>
struct Layout {
  static_assert(DH <= 128, "a 64 x d_head f32 accumulator in a warpgroup's registers");
  static constexpr int TILE = BQ * DH * 2;      // a 64-row bf16 tile in slabs: Q, dO, K or V
  static constexpr int SLAB = TILE / (DH / 16);  // = 2048: its slab stride
  static constexpr int E_TILE = EB * DH * 2;    // the E band, slab stride 4096
  static constexpr int ST = 2 * TILE + E_TILE;  // a pair's stage: K, V, the E band
  static constexpr int NST = 2;                 // the pair ring
  static constexpr int QT = 2 * TILE;           // a query tile's Q and dO
  static constexpr int DS_BYTES = MODE == DIST ? BQ * BK * 2 : 0;  // the key-column dS'
  static constexpr int DSD_BYTES = BQ * EB * 2;                   // dsd [64 q][128 v]
  static constexpr int SCR_BYTES = NCW * 16 * WBS * 4;
  static constexpr int bytes(int nq) {
    return NST * ST + nq * QT + DS_BYTES + DSD_BYTES + SCR_BYTES + 8 * (NST + nq) + ALIGN;
  }
  // two blocks an SM at d_head <= 48, where a thread's 128 registers hold
  // its accumulators (kernel 4's bound); then a second query-tile slot
  // where it still fits, so the next tile's Q and dO land under this one's
  static constexpr int MIN_BLOCKS =
      !BWD_Q_ONE_BLOCK && DH <= 48 && 2 * (bytes(1) + 1024) <= SMEM_SM ? 2 : 1;
  // at 128 registers a thread, phase A's band product in two m64n48
  // halves: S, dP and a half (56 accumulators) fit beside dQ or the dE
  // carry, where S, dP and the whole band (80) spilled; at one block an
  // SM nothing spills and the whole band's one product is the faster
  static constexpr bool HALF_BAND = BWD_Q_HALF_BAND < 0 ? MIN_BLOCKS == 2 : BWD_Q_HALF_BAND == 1;
  static constexpr int BUDGET = MIN_BLOCKS == 2 ? SMEM_SM / 2 - 1024 : 232448;
  static constexpr int NQ = bytes(2) <= BUDGET ? 2 : 1;
  static constexpr int Q_AT = NST * ST;
  static constexpr int DS_AT = Q_AT + NQ * QT;
  static constexpr int DSD_AT = DS_AT + DS_BYTES;
  static constexpr int SCR_AT = DSD_AT + DSD_BYTES;
  static constexpr int BAR_AT = SCR_AT + SCR_BYTES;
  static constexpr int TOTAL = bytes(NQ);
  static_assert(TOTAL <= BUDGET, "a block's shared memory");
  static_assert(TILE % ALIGN == 0 && ST % ALIGN == 0 && DS_AT % ALIGN == 0 &&
                    DSD_AT % ALIGN == 0,
                "aligned slabs");
};

struct Maps {
  CUtensorMap q, k, v, d, e;  // q, k, v, dO: [B*H][T][dh]; e: [max_seq][dh], in slabs
};

// Block s of the SPLIT a (b, h) sweeps query tiles s, s + SPLIT, ... and,
// inside, the key tiles each sees, ascending (see the note at the top).
// The 8 warps are two warpgroups; warp w of a warpgroup owns rows 16 w ..
// 16 w + 15 of each of its 64-row accumulators.
template <int DH, int MODE>
__global__ void __launch_bounds__(NTH, Layout<DH, MODE>::MIN_BLOCKS)
flash_bwd_q_wg_tc_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ pad,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dq, float* __restrict__ de_part, int H,
                         int T_len, int max_seq, int causal, float scale, float scale_log2) {
  static_assert(MODE == DIST || MODE == REL, "COLUMN runs DIST's instantiation");
  using L = Layout<DH, MODE>;
  constexpr int NST = L::NST, NQ = L::NQ, KS = DH / 16, SLAB = L::SLAB, R = DH / 2;
  constexpr bool KEY_TERM = MODE == DIST;  // the key-column dS' tile and dQ += dS' K
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_AT);
  uint64_t* q_full = full + NST;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int g = lane >> 2, t = lane & 3;
  const int wgi = warp >> 2, wq = warp & 3;  // warpgroup (phase A: keys 32 wgi ..); warp in it
  const int bh = blockIdx.x / SPLIT, sp = blockIdx.x % SPLIT, b = bh / H;
  const size_t base_q = (size_t)bh * T_len * DH, rbase = (size_t)bh * T_len;
  // this block's dE partial [T][DH], row = distance
  float* dep = de_part + ((size_t)sp * (gridDim.x / SPLIT) + bh) * T_len * DH;
  const int n_tiles = (T_len + BQ - 1) / BQ;
  const int n_mine = sp < n_tiles ? (n_tiles - 1 - sp) / SPLIT + 1 : 0;  // query tiles
  auto kt_last = [&](int qt) { return causal || MODE == REL ? qt : n_tiles - 1; };

  // zeros: dsd's entries no key reaches, and the partial's rows past the
  // distances this block's last query tile reaches (it writes every row
  // below q0 + BQ); everything when the block has no query tile
  {
    uint32_t* dsd_w = reinterpret_cast<uint32_t*>(smem + L::DSD_AT);
    for (int x = tid; x < L::DSD_BYTES / 4; x += NTH) dsd_w[x] = 0u;
    const int reach = min(T_len, n_mine > 0 ? (sp + (n_mine - 1) * SPLIT + 1) * BQ : 0);
    for (int x = reach * DH + tid; x < T_len * DH; x += NTH) dep[x] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < NST + NQ; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();
  if (n_mine == 0) return;

  // the producer's place (thread 0's alone): the next pair to copy (query
  // tile index c_qi, key tile c_kt), and how many pairs and query tiles
  // were copied
  int c_qi = 0, c_kt = 0, n_pairs = 0, n_q = 0;
  // copy every query tile and pair whose slot is free: tiles_done query
  // tiles and pairs_done pairs have been consumed
  auto produce = [&](int pairs_done, int tiles_done) {
    while (n_q < n_mine && n_q < tiles_done + NQ) {
      const int s = n_q % NQ, q0 = (sp + n_q * SPLIT) * BQ;
      unsigned char* qs = smem + L::Q_AT + s * L::QT;
      mbar_expect_tx(&q_full[s], L::QT);
      tma_load(qs, &maps.q, 0, q0, 0, bh, &q_full[s]);
      tma_load(qs + L::TILE, &maps.d, 0, q0, 0, bh, &q_full[s]);
      ++n_q;
    }
    while (c_qi < n_mine && n_pairs < pairs_done + NST) {
      const int qt = sp + c_qi * SPLIT, kt = c_kt, s = n_pairs % NST;
      const int dist0 = (qt - kt) * BQ - (BK - 1);
      const bool band = kt <= qt;
      unsigned char* st = smem + s * L::ST;
      mbar_expect_tx(&full[s], band ? L::ST : 2 * L::TILE);
      tma_load(st, &maps.k, 0, kt * BK, 0, bh, &full[s]);
      tma_load(st + L::TILE, &maps.v, 0, kt * BK, 0, bh, &full[s]);
      if (band) tma_load(st + 2 * L::TILE, &maps.e, 0, max_seq - EB - dist0, 0, 0, &full[s]);
      ++n_pairs;
      if (++c_kt > kt_last(qt)) {
        c_kt = 0;
        ++c_qi;
      }
    }
  };
  if (tid == 0) produce(0, 0);

  const uint32_t ds_t = base + L::DS_AT, dsd_t = base + L::DSD_AT;
  unsigned char* ds_s = smem + L::DS_AT;
  unsigned char* dsd_s = smem + L::DSD_AT;
  float* scr = reinterpret_cast<float*>(smem + L::SCR_AT) + warp * 16 * WBS;
  // warpgroup 0: the query tile's dQ over its key tiles. Warpgroup 1: the
  // dE block carried to the next pair (the current pair's lower band
  // half, rows 64.., which is the next key tile's upper one), and the
  // pair's lower half
  float acc[R], lo[R];
#pragma unroll
  for (int x = 0; x < R; ++x) acc[x] = 0.f;

  // row rl (0..63) of this thread's accumulator rows: 16 wq + g + 8 hh.
  // add_rows: the partial's rows row0 - rl (those in [0, T)) += src, with
  // the old value read only below `fresh` (rows this block wrote before)
  // or taken from `old`, read ahead by load_rows
  auto load_rows = [&](float* old, int row0, int fresh) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 - (16 * wq + g + 8 * hh);
      const bool ok = BWD_Q_DE_PARTIAL == 2 && row >= 0 && row < fresh;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const float2 x =
            ok ? *reinterpret_cast<const float2*>(dep + (size_t)row * DH + 8 * c + 2 * t)
               : make_float2(0.f, 0.f);
        old[4 * c + 2 * hh] = x.x;
        old[4 * c + 2 * hh + 1] = x.y;
      }
    }
  };
  auto add_rows = [&](const float* src, const float* old, int row0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 - (16 * wq + g + 8 * hh);
      if (BWD_Q_DE_PARTIAL == 0 || row < 0 || row >= T_len) continue;
      float* at = dep + (size_t)row * DH + 2 * t;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        *reinterpret_cast<float2*>(at + 8 * c) =
            make_float2(old[4 * c + 2 * hh] + src[4 * c + 2 * hh],
                        old[4 * c + 2 * hh + 1] + src[4 * c + 2 * hh + 1]);
    }
  };

  int pi = 0;
  for (int qi = 0; qi < n_mine; ++qi) {
    const int qt = sp + qi * SPLIT, q0 = qt * BQ, last_kt = kt_last(qt);
    // rows of the partial this block's earlier query tiles wrote
    const int fresh = qt >= SPLIT ? min(T_len, (qt - SPLIT + 1) * BQ) : 0;
    const uint32_t q_t = base + L::Q_AT + (qi % NQ) * L::QT, d_t = q_t + L::TILE;
    float lse_r[2], dsum_r[2];  // lse in log2 units, and dsum, of this thread's rows
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = q0 + 16 * wq + g + 8 * hh;
      lse_r[hh] = i < T_len ? lse[rbase + i] * LOG2E : 0.f;
      dsum_r[hh] = i < T_len ? dsum[rbase + i] : 0.f;
    }
    mbar_wait(&q_full[qi % NQ], (qi / NQ) & 1);
    for (int kt = 0; kt <= last_kt; ++kt) {
      const int s = pi % NST, kb = kt * BK;
      const bool band = kt <= qt;  // some distance of the pair is >= 0
      const uint32_t k_t = base + s * L::ST, v_t = k_t + L::TILE, e_t = k_t + 2 * L::TILE;
      // key 32 wgi + x of the key tile is live at bit x
      const int key = kb + 32 * wgi + lane;
      const uint32_t live = __ballot_sync(
          0xffffffffu, key < T_len && !(pad != nullptr && pad[(size_t)b * T_len + key]));
      mbar_wait(&full[s], (pi / NST) & 1);

      // ---- phase A
      {
        float sacc[16], pacc[16];
        // the skew: band column (from row 32 wgi) of row r, key 32 wgi + j
        // is 64 - (16 wq + r) + j; the warp keeps columns 48 - 16 wq .. 95 -
        // 16 wq (8-column chunks 6 - 2 wq ..), so it reads scratch column
        // 16 - r + j. keep(b, c0, n): chunks c0 .. c0 + n of the band from b
        auto keep = [&](const float* b, int c0, int n) {
#pragma unroll
          for (int c = 0; c < n; ++c) {
            const int cc = c0 + c - (6 - 2 * wq);
            if (cc >= 0 && cc < WB / 8) {
              *reinterpret_cast<float2*>(scr + g * WBS + 8 * cc + 2 * t) =
                  make_float2(b[4 * c], b[4 * c + 1]);
              *reinterpret_cast<float2*>(scr + (g + 8) * WBS + 8 * cc + 2 * t) =
                  make_float2(b[4 * c + 2], b[4 * c + 3]);
            }
          }
        };
        if (band && L::HALF_BAND) {
          float bacc[24];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const uint64_t da = desc_k(q_t + kk * SLAB);
            mma_ss<32, 0, 0>(sacc, da, desc_k(k_t + 1024 * wgi + kk * SLAB), kk > 0);
            mma_ss<32, 0, 0>(pacc, desc_k(d_t + kk * SLAB), desc_k(v_t + 1024 * wgi + kk * SLAB),
                             kk > 0);
            mma_ss<48, 0, 0>(bacc, da, desc_k(e_t + 1024 * wgi + kk * 2 * SLAB), kk > 0);
          }
          wg_commit();
          wg_wait0();
          fence_regs<16>(sacc);
          fence_regs<16>(pacc);
          fence_regs<24>(bacc);
          keep(bacc, 0, 6);
          wg_fence();  // the band's second half, 48 rows on
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            mma_ss<48, 0, 0>(bacc, desc_k(q_t + kk * SLAB),
                             desc_k(e_t + 1024 * wgi + 1536 + kk * 2 * SLAB), kk > 0);
          wg_commit();
          wg_wait0();
          fence_regs<24>(bacc);
          keep(bacc, 6, 6);
          __syncwarp();
        } else if (band) {
          float bacc[48];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const uint64_t da = desc_k(q_t + kk * SLAB);
            mma_ss<32, 0, 0>(sacc, da, desc_k(k_t + 1024 * wgi + kk * SLAB), kk > 0);
            mma_ss<32, 0, 0>(pacc, desc_k(d_t + kk * SLAB), desc_k(v_t + 1024 * wgi + kk * SLAB),
                             kk > 0);
            mma_ss<96, 0, 0>(bacc, da, desc_k(e_t + 1024 * wgi + kk * 2 * SLAB), kk > 0);
          }
          wg_commit();
          wg_wait0();
          fence_regs<16>(sacc);
          fence_regs<16>(pacc);
          fence_regs<48>(bacc);
          keep(bacc, 0, 12);
          __syncwarp();
        } else {  // DIST, non-causal, above the diagonal: no relative term
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            mma_ss<32, 0, 0>(sacc, desc_k(q_t + kk * SLAB), desc_k(k_t + 1024 * wgi + kk * SLAB),
                             kk > 0);
            mma_ss<32, 0, 0>(pacc, desc_k(d_t + kk * SLAB), desc_k(v_t + 1024 * wgi + kk * SLAB),
                             kk > 0);
          }
          wg_commit();
          wg_wait0();
          fence_regs<16>(sacc);
          fence_regs<16>(pacc);
        }
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        // whether any of the warp's pairs is masked: a row past T, a dead
        // key, or a key past a row under the causal mask
        const bool masked = q0 + 16 * wq + 15 >= T_len || live != 0xffffffffu ||
                            (causal && kb + 32 * wgi + 31 > q0 + 16 * wq);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = g + 8 * hh, il = 16 * wq + r, i = q0 + il;
            const int jl = 8 * n + 2 * t, j = 32 * wgi + jl;
            float ds[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float sc =
                  sacc[4 * n + 2 * hh + x] + (band ? scr[r * WBS + 16 - r + jl + x] : 0.f);
              const bool ok = !masked || (i < T_len && ((live >> (jl + x)) & 1) &&
                                          !(causal && kb + j + x > i));
              const float p = ok ? exp2f(sc * scale_log2 - lse_r[hh]) : 0.f;
              ds[x] = p * (pacc[4 * n + 2 * hh + x] - dsum_r[hh]) * scale;
            }
            const uint32_t dsb = pack_bf16(ds[0], ds[1]);  // rounded as the TPU rounds ds
            if constexpr (KEY_TERM)
              *reinterpret_cast<uint32_t*>(ds_s + (j >> 4) * 2048 + sw32(il, j & 15)) = dsb;
            if (band) {
              // the unskew: distance i - (kb + j + x) sits at band column
              // 64 - il + j + x; 0 where negative
              const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dsb);
              const int v = 64 - il + j, dist = i - (kb + j);
              *reinterpret_cast<__nv_bfloat16*>(dsd_s + (v >> 4) * 2048 + sw32(il, v & 15)) =
                  dist >= 0 ? d2.x : zero;
              *reinterpret_cast<__nv_bfloat16*>(dsd_s + ((v + 1) >> 4) * 2048 +
                                                sw32(il, (v + 1) & 15)) =
                  dist - 1 >= 0 ? d2.y : zero;
            }
          }
      }
      fence_async_smem();
      named_barrier(1, NTH);  // dS' and dsd are in place

      // ---- phase B
      if (wgi == 0) {  // dQ += dS' K + dsd E_band, over the query tile
        if (band) {
          wg_fence();
          if constexpr (KEY_TERM) {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
              mma_ss<DH, 0, 1>(acc, desc_k(ds_t + 2048 * kk), desc_mn(k_t + 512 * kk, SLAB));
          }
#pragma unroll
          for (int kv = 0; kv < EB / 16; ++kv)
            mma_ss<DH, 0, 1>(acc, desc_k(dsd_t + 2048 * kv), desc_mn(e_t + 512 * kv, 2 * SLAB));
          wg_commit();
          wg_wait0();
          fence_regs<R>(acc);
        } else if constexpr (KEY_TERM) {
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            mma_ss<DH, 0, 1>(acc, desc_k(ds_t + 2048 * kk), desc_mn(k_t + 512 * kk, SLAB));
          wg_commit();
          wg_wait0();
          fence_regs<R>(acc);
        }
        if (kt == last_kt) {  // the query tile's last pair: its dQ, cast once
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = q0 + 16 * wq + g + 8 * hh;
            if (i < T_len) {
              __nv_bfloat16* row = dq + base_q + (size_t)i * DH + 2 * t;
#pragma unroll
              for (int c = 0; c < DH / 8; ++c)
                *reinterpret_cast<uint32_t*>(row + 8 * c) =
                    pack_bf16(acc[4 * c + 2 * hh], acc[4 * c + 2 * hh + 1]);
            }
          }
#pragma unroll
          for (int x = 0; x < R; ++x) acc[x] = 0.f;
        }
      } else if (band) {
        // dE += dsd^T Q: band rows 0..63 (distances q0 - kb + 64 - rl) add
        // to the carried block, which is then complete; rows 64..127
        // (q0 - kb - rl) start the next pair's
        const int hi_row0 = q0 - kb + 64;
        float old[DH <= 96 ? R : 1];  // the partial rows the pair finishes, read ahead
        if constexpr (DH <= 96) load_rows(old, hi_row0, fresh);
        wg_fence();
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq) {
          const uint64_t dq_ = desc_mn(q_t + 512 * kq, SLAB);
          mma_ss<DH, 1, 1>(acc, desc_mn(dsd_t + 512 * kq, 2048), dq_);
          mma_ss<DH, 1, 1>(lo, desc_mn(dsd_t + 8192 + 512 * kq, 2048), dq_, kq > 0);
        }
        wg_commit();
        wg_wait0();
        fence_regs<R>(acc);
        fence_regs<R>(lo);
        if constexpr (DH <= 96) {
          add_rows(acc, old, hi_row0);
        } else {
          float old2[R];
          load_rows(old2, hi_row0, fresh);
          add_rows(acc, old2, hi_row0);
        }
        if (kt == qt) {  // the query tile's last band pair: the lower half too
          float old2[R];
          load_rows(old2, q0 - kb, fresh);
          add_rows(lo, old2, q0 - kb);
#pragma unroll
          for (int x = 0; x < R; ++x) acc[x] = 0.f;
        } else {
#pragma unroll
          for (int x = 0; x < R; ++x) acc[x] = lo[x];
        }
      }
      named_barrier(1, NTH);  // every product of the pair is done with its tiles
      ++pi;
      if (tid == 0) produce(pi, qi + (kt == last_kt));
    }
  }
}

template <int DH, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dq, void* de_part,
                   int B, int H, int T_len, int max_seq, int causal, float scale,
                   cudaStream_t stream) {
  Maps maps;
  cudaError_t err;
  if ((err = sm90_host::slab_map(&maps.q, q, B * H, T_len, DH, BQ)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.k, k, B * H, T_len, DH, BK)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.v, v, B * H, T_len, DH, BK)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.d, dout, B * H, T_len, DH, BQ)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.e, e, 1, max_seq, DH, EB)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_q_wg_tc_kernel<DH, MODE>;
  const int smem = Layout<DH, MODE>::TOTAL;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H * SPLIT, NTH, smem, stream>>>(
      maps, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(de_part), H, T_len, max_seq, causal, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace wg



template <typename T, int DH, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dq, void* de,
                   void* de_part, int B, int H, int T_len, int max_seq, int causal, float scale,
                   cudaStream_t stream) {
  cudaError_t err;
  int parts = B * H;  // dE partials, one a block
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // COLUMN (kernel 5) is DIST (kernel 6) on the card: see the note at the top
    err = wg::launch<DH, MODE == COLUMN ? DIST : MODE>(q, k, v, e, pad, dout, lse, dsum, dq,
                                                       de_part, B, H, T_len, max_seq, causal,
                                                       scale, stream);
    if (err != cudaSuccess) return err;
    parts = B * H * wg::SPLIT;
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
// by the kernel (every bf16 path uses all of it, one partial a block; the
// f32 paths the first B*H). scale is c = 1/sqrt(d_head) of the
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
