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
// With c = 1/sqrt(dh), the forward's saved lse, dsum_i = dO_i . O_i, and the
// distance d = i - j (the notation of flash_rel_attn_bwd.cu):
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
// Design (simple and correct first; see PERF.md for its time):
//   * tiles of 64 rows (32 at d_head 128, so the f32 staging fits a block's
//     shared memory) and 4 threads a row;
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
//
// What bounds it on the H100: CUDA-core f32 FMAs fed from shared memory (no
// tensor cores), and the 8 warps a block gives each SM (B * H blocks: one
// wave at B 8, H 16). No source file is shared with the other kernels, so
// the build hash of this file covers everything it compiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, int DH, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dq, void* de,
                   void* de_part, int B, int H, int T_len, int max_seq, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_rel_attn_bwd_q_kernel<T, DH, MODE>;
  const size_t smem = smem_bytes<DH>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, Tile<DH>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(e), static_cast<const uint8_t*>(pad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<T*>(dq),
      static_cast<float*>(de_part), H, T_len, max_seq, causal, 1.f / sqrtf((float)DH));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = max_seq * DH, threads = 256;
  de_reduce_kernel<T><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(de_part), static_cast<T*>(de), B * H, T_len, max_seq, DH);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const void* q, const void* k, const void* v, const void* e, const void* pad,
             const void* dout, const void* lse, const void* dsum, void* dq, void* de,
             void* de_part, int B, int H, int T_len, int dh, int max_seq, int causal, int dtype,
             void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Q_CASE(TYPE, D)                                                                       \
  if (dh == D)                                                                                \
    return launch<TYPE, D, MODE>(q, k, v, e, pad, dout, lse, dsum, dq, de, de_part, B, H,     \
                                 T_len, max_seq, causal, s);
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
// [B, H, T]; pad may be null. de_part is f32 scratch [B*H, T, dh], zeroed by
// the kernel. Launches on `stream` and does not synchronise.

// dQ and dE, by key column (the TPU's _bwd_dq_de_kernel).
int flash_rel_attn_bwd_dq_de(const void* q, const void* k, const void* v, const void* e,
                             const void* pad, const void* dout, const void* lse,
                             const void* dsum, void* dq, void* de, void* de_part, int B, int H,
                             int T_len, int dh, int max_seq, int causal, int dtype,
                             void* stream) {
  return dispatch<COLUMN>(q, k, v, e, pad, dout, lse, dsum, dq, de, de_part, B, H, T_len, dh,
                          max_seq, causal, dtype, stream);
}

// dQ and dE, the relative terms by distance (the TPU's _bwd_dq_de_dist_kernel).
int flash_rel_attn_bwd_dq_de_dist(const void* q, const void* k, const void* v, const void* e,
                                  const void* pad, const void* dout, const void* lse,
                                  const void* dsum, void* dq, void* de, void* de_part, int B,
                                  int H, int T_len, int dh, int max_seq, int causal, int dtype,
                                  void* stream) {
  return dispatch<DIST>(q, k, v, e, pad, dout, lse, dsum, dq, de, de_part, B, H, T_len, dh,
                        max_seq, causal, dtype, stream);
}

// dQ_rel (into dq) and dE, by distance (the TPU's _bwd_de_dqrel_kernel).
int flash_rel_attn_bwd_de_dqrel(const void* q, const void* k, const void* v, const void* e,
                                const void* pad, const void* dout, const void* lse,
                                const void* dsum, void* dq, void* de, void* de_part, int B,
                                int H, int T_len, int dh, int max_seq, int causal, int dtype,
                                void* stream) {
  return dispatch<REL>(q, k, v, e, pad, dout, lse, dsum, dq, de, de_part, B, H, T_len, dh,
                       max_seq, causal, dtype, stream);
}

const char* flash_rel_attn_bwd_q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
