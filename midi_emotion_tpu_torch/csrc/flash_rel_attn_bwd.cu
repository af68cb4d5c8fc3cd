// Flash relative attention, backward, for Hopper (sm_90a).
//
// Replaces midi_emotion_tpu/ops/pallas_attention.py::_bwd_merged_kernel (the
// default BWD_IMPL="merged" Pallas TPU backward, launched by
// _bwd_merged_call). With c = 1/sqrt(dh) and the forward's saved lse:
//
//     s[i,j]  = c (q_i . k_j + Srel[i,j]),  Srel[i,j] = q_i . E[ms-1-(i-j)] (j <= i, else 0)
//     P[i,j]  = exp(s[i,j] - lse_i)          (0 where masked; lse = 1e30 rows give 0)
//     dV_j    = sum_i P[i,j] dO_i
//     dP[i,j] = dO_i . V_j
//     dS'[i,j] = c P[i,j] (dP[i,j] - dsum_i),  dsum_i = dO_i . O_i (given)
//     dK_j    = sum_i dS'[i,j] q_i
//     dQ_i    = sum_j dS'[i,j] (k_j + E[ms-1-(i-j)] [j <= i])
//     dE[ms-1-d] = sum_{i-j=d, d>=0} dS'[i,j] q_i
//
// The scale convention: the forward does not pre-scale q (the JAX backward
// does, and fixes dQ up afterwards); here c is folded into dS' once, so dK,
// dQ and dE each carry it exactly once. Srel is 0 above the diagonal even in
// the non-causal (regression) model, so only distances d = i - j >= 0 reach E.
//
// Both dtype paths keep the TPU kernel's ownership scheme: a block sweeps
// 64-key tiles of one (b, h) and, inside, the 64-row query tiles that see
// them (causal: those at or below the diagonal), as the TPU's sequential
// grid did. dK and dV of the key tile stay on chip (registers, or f32
// shared memory); dQ accumulates in an f32 partial and dE in an f32 partial
// indexed by distance, each only this block's; second kernels reduce the
// partials in a fixed order. No atomics, no sum through bf16, a
// deterministic result.
//
// bf16 (the training path). Bound on the H100: operations. At B 8, H 16,
// T 1216, dh 48 the nine products over the visible pairs are about 72
// GFLOP, 73 us at the tensor cores' 989 TFLOP/s. Design
// (tc::flash_bwd_tc_kernel), on Hopper's wgmma, TMA and mbarriers (the
// building blocks in hopper_sm90.cuh): two warpgroups share each tile pair,
// every product a wgmma with f32 sums, per pair:
//   1. warpgroup h, keys 32 h ..: S = Q K^T, dP = dO V^T and the band Q
//      E_band^T, skewed into Srel through a per-warp scratch; P = exp(s -
//      lse), dS' = c P (dP - dsum) in f32, rounded to bf16 as the TPU
//      kernel rounds ds, into shared tiles, and dS' scattered by distance
//      into dsd (the skew back, 0 where the distance is negative), which
//      feeds dQ_rel = dsd E_band and dE += dsd^T Q as plain products;
//   2. warpgroup 0: dV += P^T dO and dQ += dS' K + dsd E_band; warpgroup 1:
//      dK += dS'^T Q and dE; the transposed operands (P, dS', dsd, Q, dO, K,
//      E) read MN-major through the descriptor's transpose bit.
// Tiles land by TMA in 16-column slabs with the 32-byte swizzle wgmma
// reads; thread 0 refills each ring slot right after the barrier that ends
// its last reader. A block sweeps groups of key tiles of one (b, h) (two
// up to d_head 48, their f32 dK and dV kept in shared memory between
// pairs); two blocks share a (b, h) on alternate groups, or one where B *
// H alone fills 7/8 of the SMs, each with its own f32 dQ and dE partials:
// a query tile's dQ, and each 64-distance dE block, stays in registers
// until the group is done with it, so a partial row is read and written
// once a group. At d_head 192 and 256 a 64 x d_head f32 accumulator would
// pass a thread's registers, so the products over d_head (S, dP, the band)
// run whole in each of two blocks (grid y) and each computes the columns
// of one half of dV, dQ, dK and dE (m64n96 or m64n128 products reading
// that half's slabs of dO, K, E and Q); the pair ring has one stage, and
// at 256 the skew's scratch lies in the E band's other half, which phase
// A alone reads (a barrier after its products). Measured
// before this design (scripts/torch_flash_bench.py, NVIDIA H100 80GB HBM3 at
// 700 W), the whole mma.sync call took 0.9731 ms at B 8: dsum 0.0243, the
// main kernel 0.8868 (128 registers, 24 bytes of spill at d_head 48), the
// dQ and dE reductions 0.0345 and 0.0287; in a first wgmma version, taking
// away the partial rows' reads and writes (each pair's then) saved 0.26 ms
// of 0.76, which led to the groups. dsum reads 16-byte units, 8 lanes a
// row; the dQ reduction 4 values a thread.
//
// f32 (the checks' path, held to 1e-4 of each gradient's scale): CUDA
// cores, because TF32 products keep about three decimal digits. A block of
// 4 threads a row (256 at 64-row tiles, 128 from d_head 128, whose 32-row
// tiles keep the f32 staging inside 227 KB) stages K, V, Q, dO and the band of
// BQ + BK - 1 E rows (zero for negative distances) in shared memory as f32,
// then runs four phases with its threads remapped: A, thread = (query row,
// BK/4 keys): P, dP and dS' into shared tiles; B, thread = (key row, dh/4
// columns): dV and dK; C, thread = (query row, dh/4 columns): dQ; D, thread
// = (distance, dh/4 columns): the band's dE diagonals. CUDA-core FMAs fed
// from shared memory bound it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_sm90.cuh"

namespace {

// Tile sides by d_head: 64 rows, or 32 from d_head 128, where 64-row f32 tiles
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

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
__host__ __device__ constexpr int row_stride() { return DH + 4; }  // 16-byte aligned rows

template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int BQ = Tile<DH>::BQ, BK = Tile<DH>::BK, BAND = Tile<DH>::BAND, PS = Tile<DH>::PS;
  return (size_t)((2 * BK + 2 * BQ + BAND) * row_stride<DH>() + 2 * BQ * PS + 2 * BQ + BK) *
         sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(Tile<DH>::NT)
flash_rel_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ e,
                          const uint8_t* __restrict__ pad, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                          float* __restrict__ dq_acc, float* __restrict__ de_part, int H,
                          int T_len, int max_seq, int causal, float scale) {
  static_assert(DH % 16 == 0, "each of 4 threads takes a float4-aligned quarter row");
  constexpr int BQ = Tile<DH>::BQ, BK = Tile<DH>::BK, BAND = Tile<DH>::BAND, NT = Tile<DH>::NT,
                PS = Tile<DH>::PS;
  constexpr int RS = row_stride<DH>();
  constexpr int CH = DH / 4;  // columns per thread in phases B, C and D
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][RS]
  float* vs = ks + BK * RS;                      // [BK][RS]
  float* qs = vs + BK * RS;                      // [BQ][RS]
  float* dos = qs + BQ * RS;                     // [BQ][RS]
  float* es = dos + BQ * RS;                     // [BAND][RS], row u = distance d0 + u
  float* ps = es + BAND * RS;                    // [BQ][PS]
  float* dss = ps + BQ * PS;                     // [BQ][PS]
  float* lse_s = dss + BQ * PS;                  // [BQ]
  float* dsum_s = lse_s + BQ;                    // [BQ]
  float* live = dsum_s + BQ;                     // [BK]: 1 for a visible key

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const size_t base = (size_t)bh * T_len * DH;
  float* dqa = dq_acc + base;
  float* dep = de_part + base;  // [T][DH], row = distance
  const int row4 = tid >> 2;    // phases A-C: the row this thread works on
  const int c = tid & 3;        // phases B-C: its quarter of the columns

  for (int x = tid; x < T_len * DH; x += NT) {
    dqa[x] = 0.f;
    dep[x] = 0.f;
  }

  const int n_tiles = (T_len + BQ - 1) / BQ;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, T_len - k0);
    __syncthreads();  // the previous key tile's phases are done with ks, vs
    for (int x = tid; x < BK * DH; x += NT) {
      const int j = x / DH, d = x - j * DH;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        const size_t g = base + (size_t)(k0 + j) * DH + d;
        kx = k[g];
        vx = v[g];
      }
      ks[j * RS + d] = kx;
      vs[j * RS + d] = vx;
    }
    for (int j = tid; j < BK; j += NT)
      live[j] = (j < nk && !(pad != nullptr && pad[(size_t)b * T_len + k0 + j])) ? 1.f : 0.f;

    float dk_acc[CH], dv_acc[CH];
#pragma unroll
    for (int x = 0; x < CH; ++x) dk_acc[x] = dv_acc[x] = 0.f;

    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous pair's phases are done with the tiles
      for (int x = tid; x < BQ * DH; x += NT) {
        const int r = x / DH, d = x - r * DH;
        float qx = 0.f, dox = 0.f;
        if (q0 + r < T_len) {
          const size_t g = base + (size_t)(q0 + r) * DH + d;
          qx = q[g];
          dox = dout[g];
        }
        qs[r * RS + d] = qx;
        dos[r * RS + d] = dox;
      }
      for (int r = tid; r < BQ; r += NT) {
        const bool ok = q0 + r < T_len;
        lse_s[r] = ok ? lse[(size_t)bh * T_len + q0 + r] : 1e30f;
        dsum_s[r] = ok ? dsum[(size_t)bh * T_len + q0 + r] : 0.f;
      }
      const int dist0 = q0 - k0 - (BK - 1);  // distance of band row 0
      for (int x = tid; x < BAND * DH; x += NT) {
        const int u = x / DH, d = x - u * DH;
        const int dist = dist0 + u;
        float ev = 0.f;
        if (dist >= 0 && dist < max_seq) ev = e[(size_t)(max_seq - 1 - dist) * DH + d];
        es[u * RS + d] = ev;
      }
      __syncthreads();

      // phase A: P, and dS' = c P (dP - dsum), for query row row4, keys c + 4r
      {
        const int i = q0 + row4;
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
        for (int r = 0; r < BK / 4; ++r) {
          const int jj = c + 4 * r;
          float p = 0.f, ds = 0.f;
          if (i < T_len && live[jj] != 0.f && !(causal && k0 + jj > i)) {
            const float4* kr = reinterpret_cast<const float4*>(ks + jj * RS);
            const float4* vr = reinterpret_cast<const float4*>(vs + jj * RS);
            const float4* er = reinterpret_cast<const float4*>(es + (row4 - jj + BK - 1) * RS);
            float s = 0.f, dp = 0.f;
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
            p = expf(s * scale - lse_i);  // lse = 1e30 (no visible key) gives 0
            ds = p * (dp - dsum_i) * scale;
          }
          ps[row4 * PS + jj] = p;
          dss[row4 * PS + jj] = ds;
        }
      }
      __syncthreads();

      // phase B: dV_j += P^T dO, dK_j += dS'^T q for key row row4, columns c
#pragma unroll 4
      for (int ii = 0; ii < BQ; ++ii) {
        const float p = ps[ii * PS + row4], ds = dss[ii * PS + row4];
        const float4* q4 = reinterpret_cast<const float4*>(qs + ii * RS + c * CH);
        const float4* do4 = reinterpret_cast<const float4*>(dos + ii * RS + c * CH);
#pragma unroll
        for (int x4 = 0; x4 < CH / 4; ++x4) {
          const float4 a = q4[x4], g = do4[x4];
          dv_acc[4 * x4 + 0] = fmaf(p, g.x, dv_acc[4 * x4 + 0]);
          dv_acc[4 * x4 + 1] = fmaf(p, g.y, dv_acc[4 * x4 + 1]);
          dv_acc[4 * x4 + 2] = fmaf(p, g.z, dv_acc[4 * x4 + 2]);
          dv_acc[4 * x4 + 3] = fmaf(p, g.w, dv_acc[4 * x4 + 3]);
          dk_acc[4 * x4 + 0] = fmaf(ds, a.x, dk_acc[4 * x4 + 0]);
          dk_acc[4 * x4 + 1] = fmaf(ds, a.y, dk_acc[4 * x4 + 1]);
          dk_acc[4 * x4 + 2] = fmaf(ds, a.z, dk_acc[4 * x4 + 2]);
          dk_acc[4 * x4 + 3] = fmaf(ds, a.w, dk_acc[4 * x4 + 3]);
        }
      }

      // phase C: dQ_i += dS' (K + E band) for query row row4, columns c
      if (q0 + row4 < T_len) {
        float acc[CH];
#pragma unroll
        for (int x = 0; x < CH; ++x) acc[x] = 0.f;
#pragma unroll 4
        for (int jj = 0; jj < BK; ++jj) {
          const float ds = dss[row4 * PS + jj];
          const float4* k4 = reinterpret_cast<const float4*>(ks + jj * RS + c * CH);
          const float4* e4 =
              reinterpret_cast<const float4*>(es + (row4 - jj + BK - 1) * RS + c * CH);
#pragma unroll
          for (int x4 = 0; x4 < CH / 4; ++x4) {
            const float4 kk = k4[x4], ee = e4[x4];
            acc[4 * x4 + 0] = fmaf(ds, kk.x + ee.x, acc[4 * x4 + 0]);
            acc[4 * x4 + 1] = fmaf(ds, kk.y + ee.y, acc[4 * x4 + 1]);
            acc[4 * x4 + 2] = fmaf(ds, kk.z + ee.z, acc[4 * x4 + 2]);
            acc[4 * x4 + 3] = fmaf(ds, kk.w + ee.w, acc[4 * x4 + 3]);
          }
        }
        float* dst = dqa + (size_t)(q0 + row4) * DH + c * CH;
#pragma unroll
        for (int x = 0; x < CH; ++x) dst[x] += acc[x];
      }

      // phase D: dE at distance dist0 + u += sum over the band's diagonal
      // u of dS'[ii, jj] q_ii, with ii - jj = u - (BK - 1)
      for (int w = tid; w < BAND * 4; w += NT) {
        const int u = w >> 2, cc = w & 3;
        const int dist = dist0 + u;
        if (dist < 0 || dist >= T_len) continue;
        const int off = u - (BK - 1);
        const int ii_lo = max(0, off), ii_hi = min(BQ, BK + off);
        float acc[CH];
#pragma unroll
        for (int x = 0; x < CH; ++x) acc[x] = 0.f;
        for (int ii = ii_lo; ii < ii_hi; ++ii) {
          const float ds = dss[ii * PS + ii - off];
          const float4* q4 = reinterpret_cast<const float4*>(qs + ii * RS + cc * CH);
#pragma unroll
          for (int x4 = 0; x4 < CH / 4; ++x4) {
            const float4 a = q4[x4];
            acc[4 * x4 + 0] = fmaf(ds, a.x, acc[4 * x4 + 0]);
            acc[4 * x4 + 1] = fmaf(ds, a.y, acc[4 * x4 + 1]);
            acc[4 * x4 + 2] = fmaf(ds, a.z, acc[4 * x4 + 2]);
            acc[4 * x4 + 3] = fmaf(ds, a.w, acc[4 * x4 + 3]);
          }
        }
        float* dst = dep + (size_t)dist * DH + cc * CH;
#pragma unroll
        for (int x = 0; x < CH; ++x) dst[x] += acc[x];
      }
    }

    if (k0 + row4 < T_len) {
      const size_t g = base + (size_t)(k0 + row4) * DH + c * CH;
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        dk[g + x] = dk_acc[x];
        dv[g + x] = dv_acc[x];
      }
    }
  }

  __syncthreads();  // every dQ accumulation of this (b, h) has landed
  for (int x = tid; x < T_len * DH; x += NT) dq[base + x] = dqa[x];
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// dsum[row] = dO[row] . O[row] in f32, a warp a row: the backward's one
// input that the forward does not save (XLA work beside the TPU kernel).
template <typename T>
__global__ void dsum_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                            float* __restrict__ dsum, int rows, int dh) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps
  const size_t base = (size_t)row * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc += to_f32(dout[base + d]) * to_f32(o[base + d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

// The same for bf16 rows of a multiple of 8 values (16-byte units): 8
// lanes a row, each summing 16-byte units 64 values apart, so a warp reads
// 4 whole rows at once.
__global__ void dsum_vec_kernel(const __nv_bfloat16* __restrict__ dout,
                                   const __nv_bfloat16* __restrict__ o, float* __restrict__ dsum,
                                   int rows, int dh) {
  const size_t at = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = at >> 3;
  const int sub = (int)(at & 7);
  float acc = 0.f;
  if (row < (size_t)rows) {
    const uint4* a = reinterpret_cast<const uint4*>(dout + row * dh);
    const uint4* b = reinterpret_cast<const uint4*>(o + row * dh);
    for (int u = sub; u < dh / 8; u += 8) {
      const uint4 x = a[u], y = b[u];
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        acc = fmaf(__uint_as_float(xs[w] << 16), __uint_as_float(ys[w] << 16), acc);
        acc = fmaf(__uint_as_float(xs[w] & 0xffff0000u), __uint_as_float(ys[w] & 0xffff0000u),
                   acc);
      }
    }
  }
#pragma unroll
  for (int off = 4; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < (size_t)rows) dsum[row] = acc;
}


// ---------------------------------------------------------------------------
// the bf16 path: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;

constexpr int BQ = 64;              // query rows per tile
constexpr int BK = 64;              // keys per tile
constexpr int EB = BQ + BK;         // band rows staged per tile pair (the first one unused)
constexpr int NCW = 8;              // warps: two warpgroups
constexpr int NTH = 32 * NCW;
constexpr int MAX_SPLIT = 2;        // blocks a (b, h), at most (the scratch has room for 2)
constexpr int WB = 48;              // band columns a warp reads in phase A: its 47 distances
constexpr int WBS = WB + 8;         // row stride of a warp's band scratch (floats)
constexpr float LOG2E = 1.4426950408889634f;

// DV: the gradient columns a block computes (the grid's y index picks which
// DV of the DH): DH itself up to d_head 128, DH / 2 at 192 and 256, where a
// 64 x DH f32 accumulator would pass a thread's registers.
template <int DH, int DV>
struct Layout {
  static_assert(DH % DV == 0 && DV <= 128, "column chunks of at most 128");
  static constexpr int G = DH <= 48 ? 2 : 1;   // key tiles a block sweeps the query tiles with
  static constexpr int TILE = BQ * DH * 2;     // a 64-row bf16 tile in slabs: Q, dO, K or V
  static constexpr int SLAB = TILE / (DH / 16);  // = 2048: its slab stride
  static constexpr int E_TILE = EB * DH * 2;   // the E band, slab stride 4096
  static constexpr int ST = 2 * TILE + E_TILE;  // a pair's stage: Q, dO, the E band
  static constexpr int KV = 2 * G * TILE;       // a group's K, V of each key tile
  static constexpr int NST = DV < DH ? 1 : 2;   // the pair ring, where two stages fit
  static constexpr int NKV = DH <= 96 ? 2 : 1;  // the group ring, where it fits
  // at d_head 256 the skew's scratch takes the E band's columns this block
  // does not own, which phase A alone reads (the rest would pass 227 KB)
  static constexpr bool SCR_IN_E = DH > 192;
  static constexpr int KV_AT = NST * ST;
  static constexpr int P_AT = KV_AT + NKV * KV;  // P, then dS': [64 q][64 k] in slabs
  static constexpr int DSD_AT = P_AT + 2 * 8192;  // dS' by distance: [64 q][128 v] in slabs
  static constexpr int SCR_AT = DSD_AT + 16384;
  // G = 2: each key tile's f32 dV (warpgroup 0) and dK (1), between pairs
  static constexpr int ACC_AT = SCR_AT + (SCR_IN_E ? 0 : NCW * 16 * WBS * 4);
  static constexpr int BAR_AT = ACC_AT + (G == 2 ? G * 2 * BK * DH * 4 : 0);
  static constexpr int TOTAL = BAR_AT + 8 * (NST + NKV) + 1024;  // + room to align to 1024
  static_assert(TOTAL <= 232448, "a block's shared memory");
  static_assert(TILE % 1024 == 0 && ST % 1024 == 0 && SCR_AT % 1024 == 0, "aligned slabs");
  static_assert(!SCR_IN_E || (NST == 1 && DH == 2 * DV &&
                              (DH - DV) / 16 * 2 * SLAB >= NCW * 16 * WBS * 4),
                "the other half of the one stage's E band holds the scratch");
};

struct Maps {
  CUtensorMap q, k, v, d, e;  // q, k, v, dO: [B*H][T][dh]; e: [max_seq][dh], in slabs
};

// Block s of the nsplit a (b, h) sweeps groups s, s + nsplit, ... of G
// consecutive key tiles (G = 2 up to d_head 48, where shared memory holds
// both key tiles' f32 dK and dV between pairs, else 1) and, inside, the
// query tiles that
// see them, as the TPU's sequential grid did; a query tile meets the
// group's key tiles one after the other (pairs whose keys all lie past its
// rows under the causal mask are skipped). Thread 0 is also the producer:
// it copies each group's K and V into a ring of NKV, and each pair's Q, dO
// and E band (128 rows, row v at distance dist0 + 127 - v, zero where
// negative) into a ring of NST, by TMA, each slot's arrival counted by an
// mbarrier; it refills a slot right after the barrier that ends the slot's
// last reader. (A ninth, producer warp would put three warps on one of the
// SM's four schedulers and cap every thread at 168 registers.) The 8 warps
// are two warpgroups; warp w of a warpgroup owns rows 16 w .. 16 w + 15 of
// each of its 64-row accumulators. Per tile pair:
//   phase A, warpgroup h (keys 32 h ..): S = Q K_h^T, dP = dO V_h^T (m64n32)
//     and the band Q E^T over the 96 rows its keys reach (m64n96), by wgmma
//     from shared memory; the band skewed into Srel through a per-warp
//     scratch; P = exp(s - lse), dS' = c P (dP - dsum) in f32, both rounded
//     to bf16 into shared tiles, and dS' also scattered by distance into dsd
//     [i][64 - i + j] (0 where the distance is negative); entries no key
//     reaches stay 0;
//   phase B, warpgroup 0: dV += P^T dO (P read MN-major) and dQ += dS' K +
//     dsd E_band, in registers across the group; warpgroup 1: dK += dS'^T Q
//     and dE += dsd^T Q over the band's two 64-row halves (dsd read
//     MN-major), into registers that carry each 64-distance block until no
//     later pair of the group reaches it.
// Once a query tile has met the group, warpgroup 0 adds its dQ to this
// block's f32 dQ partial and warpgroup 1 its finished dE block to this
// block's f32 dE partial (by distance): each partial row is read and
// written once a group, not once a pair. A partial row's first write in
// the block (its first group) stores without reading; rows the block never
// reaches are zeroed first.
template <int DH, int DV>
__global__ void __launch_bounds__(NTH, 1)
flash_bwd_tc_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ pad,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ dq_acc, float* __restrict__ de_part, int H, int T_len,
                    int max_seq, int causal, float scale, float scale_log2, int nsplit) {
  using L = Layout<DH, DV>;
  constexpr int G = L::G, NST = L::NST, NKV = L::NKV, KS = DH / 16, SLAB = L::SLAB, R = DV / 2;
  // this block's columns c0 .. c0 + DV - 1 of dK, dV, dQ and dE: from slab
  // cs of Q, dO, K and E (the products over d_head read every slab)
  const int c0 = blockIdx.y * DV, cs = c0 / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_AT);
  uint64_t* kv_full = full + NST;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / nsplit, sp = blockIdx.x % nsplit, b = bh / H;
  const size_t base_q = (size_t)bh * T_len * DH, rbase = (size_t)bh * T_len;
  const size_t part = ((size_t)sp * (gridDim.x / nsplit) + bh) * T_len * DH;  // this block's
  float* dqa = dq_acc + part;   // [T][DH]
  float* dep = de_part + part;  // [T][DH], row = distance
  const int n_tiles = (T_len + BK - 1) / BK;
  auto first_q = [&](int grp) { return causal ? grp * G : 0; };  // a group's first query tile
  // whether key tile u of group grp meets query tile qt
  auto meets = [&](int grp, int qt, int u) {
    const int kt = grp * G + u;
    return kt < n_tiles && !(causal && kt > qt);
  };

  // zeros: dsd's entries no key reaches; the dQ rows (query tiles before
  // the block's first group's first) and dE distances (past those its first
  // group reaches) the block never writes; everything when it has no group
  {
    uint32_t* dsd_w = reinterpret_cast<uint32_t*>(smem + L::DSD_AT);
    for (int x = tid; x < 16384 / 4; x += NTH) dsd_w[x] = 0u;
    const bool none = sp * G >= n_tiles;
    const int dq_zero = none ? T_len : min(T_len, first_q(sp) * BQ);
    const int de_from = none ? 0 : min(T_len, (n_tiles - sp * G) * BK + 1);
    if constexpr (DV == DH) {
      for (int x = tid; x < dq_zero * DH; x += NTH) dqa[x] = 0.f;
      for (int x = de_from * DH + tid; x < T_len * DH; x += NTH) dep[x] = 0.f;
    } else {  // the block's own columns: the other chunks' blocks write the rest
      for (int x = tid; x < dq_zero * DV; x += NTH) dqa[x / DV * DH + c0 + x % DV] = 0.f;
      for (int x = de_from * DV + tid; x < T_len * DV; x += NTH)
        dep[x / DV * DH + c0 + x % DV] = 0.f;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    for (int s = 0; s < NKV; ++s) mbar_init(&kv_full[s], 1);
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();
  if (sp * G >= n_tiles) return;

  // the producer's place in the pair sequence (thread 0's alone): the next
  // pair to copy (group c_g, query tile c_qt, its key tile G - 1 - c_uu: a
  // query tile meets the group's key tiles from the last down), and how many
  // pairs and groups were copied
  int c_g = sp, c_qt = first_q(sp), c_uu = 0, n_pairs = 0, n_kv = 0;
  auto settle = [&]() {  // on to the first pair from here that exists
    while (c_g * G < n_tiles && !meets(c_g, c_qt, G - 1 - c_uu)) {
      if (++c_uu == G) {
        c_uu = 0;
        if (++c_qt == n_tiles) c_qt = first_q(c_g += nsplit);
      }
    }
  };
  settle();
  // copy every pair whose slot is free: pairs_done pairs and groups_done
  // groups have been consumed
  auto produce = [&](int pairs_done, int groups_done) {
    while (c_g * G < n_tiles && n_pairs < pairs_done + NST) {
      const int gi = (c_g - sp) / nsplit, kt0 = c_g * G;
      if (n_kv == gi) {  // the pair opens a group: its K and V first
        if (gi >= groups_done + NKV) return;
        const int ks = gi % NKV, nt = min(G, n_tiles - kt0);
        unsigned char* kv = smem + L::KV_AT + ks * L::KV;
        mbar_expect_tx(&kv_full[ks], nt * 2 * L::TILE);
        for (int u = 0; u < nt; ++u) {
          tma_load(kv + 2 * u * L::TILE, &maps.k, 0, (kt0 + u) * BK, 0, bh, &kv_full[ks]);
          tma_load(kv + (2 * u + 1) * L::TILE, &maps.v, 0, (kt0 + u) * BK, 0, bh, &kv_full[ks]);
        }
        ++n_kv;
      }
      const int kt = kt0 + G - 1 - c_uu;
      const int s = n_pairs % NST, q0 = c_qt * BQ, dist0 = q0 - kt * BK - (BK - 1);
      unsigned char* st = smem + s * L::ST;
      mbar_expect_tx(&full[s], L::ST);
      tma_load(st, &maps.q, 0, q0, 0, bh, &full[s]);
      tma_load(st + L::TILE, &maps.d, 0, q0, 0, bh, &full[s]);
      tma_load(st + 2 * L::TILE, &maps.e, 0, max_seq - EB - dist0, 0, 0, &full[s]);
      ++n_pairs;
      if (++c_uu == G) {
        c_uu = 0;
        if (++c_qt == n_tiles) c_qt = first_q(c_g += nsplit);
      }
      settle();
    }
  };
  if (tid == 0) produce(0, 0);

  const int wg = warp >> 2, wq = warp & 3;  // warpgroup (phase A: keys 32 wg ..); warp in it
  const uint32_t p_t = base + L::P_AT, ds_t = p_t + 8192, dsd_t = base + L::DSD_AT;
  unsigned char* p_s = smem + L::P_AT;
  unsigned char* ds_s = p_s + 8192;
  unsigned char* dsd_s = smem + L::DSD_AT;
  float* scr = reinterpret_cast<float*>(
                   smem + (L::SCR_IN_E ? 2 * L::TILE + ((DH - DV) - c0) / 16 * 2 * SLAB
                                       : L::SCR_AT)) +
               warp * 16 * WBS;
  // warpgroup 0: dV of the pair's key tile, 1: dK (rows = keys); with G = 2
  // read from and written back to shared memory around each pair's
  // products (a thread's own values, in a layout without bank conflicts)
  float acc[R];
  float4* acc_s = reinterpret_cast<float4*>(smem + L::ACC_AT) + (tid & 127);
  auto acc_at = [&](int u, int x4) -> float4& {
    return acc_s[((u * 2 + wg) * (R / 4) + x4) * 128];
  };
  // warpgroup 0: ec[0] is the query tile's dQ over the group. Warpgroup 1:
  // dE blocks in flight. At a query tile with first band distance D = q0 -
  // k0 - 63 (k0: the group's first key), the pair with key tile u adds its
  // band rows 64.. to the 64 distances from D - 64 u (block -u) and rows
  // 0..63 to those from D - 64 (u - 1) (block 1 - u); block p's row rl is
  // distance D + 64 p + 63 - rl. A query tile meets the key tiles from the
  // last down: block -(G - 1) is finished after the first pair, then its
  // registers take block 1. Between query tiles ec[j] holds block -(G - 1)
  // + j; in a query tile (G = 2), ec[0] holds block -1 then block 1 and
  // ec[1] block 0; G = 1 takes block 1 into en.
  static_assert(G <= 2, "the dE block rotation is written for groups of 1 or 2");
  float ec[G][R], en[G == 1 ? R : 1];
#pragma unroll
  for (int x = 0; x < R; ++x) acc[x] = 0.f;
#pragma unroll
  for (int u = 0; u < G; ++u)
#pragma unroll
    for (int x = 0; x < R; ++x) ec[u][x] = 0.f;
  if (G == 2)
#pragma unroll
    for (int u = 0; u < G; ++u)
#pragma unroll
      for (int x4 = 0; x4 < R / 4; ++x4) acc_at(u, x4) = make_float4(0.f, 0.f, 0.f, 0.f);
  // key tile kt0 + u's dK (warpgroup 1) or dV (0) from acc, cast to bf16
  int kt0 = 0;  // the group's first key tile
  auto store_out = [&](int u) {
    __nv_bfloat16* out = wg == 0 ? dv : dk;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = (kt0 + u) * BK + 16 * wq + g + 8 * hh;
      if (key < T_len) {
        __nv_bfloat16* row = out + base_q + (size_t)key * DH + c0 + 2 * t;
#pragma unroll
        for (int c = 0; c < DV / 8; ++c)
          *reinterpret_cast<uint32_t*>(row + 8 * c) =
              pack_bf16(acc[4 * c + 2 * hh], acc[4 * c + 2 * hh + 1]);
      }
    }
  };

  // row rl (0..63) of this thread's accumulator rows: 16 wq + g + 8 hh.
  // load_rows: dst = the partial's rows row0 + step * rl (0 in the block's
  // first group, or outside [0, T)); add_rows: those rows = old + add
  auto load_rows = [&](float* dst, const float* src, int row0, int step, bool first) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + step * (16 * wq + g + 8 * hh);
      const bool ok = !first && row >= 0 && row < T_len;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        const float2 x = ok ? *reinterpret_cast<const float2*>(src + (size_t)row * DH + c0 +
                                                               8 * c + 2 * t)
                            : make_float2(0.f, 0.f);
        dst[4 * c + 2 * hh] = x.x;
        dst[4 * c + 2 * hh + 1] = x.y;
      }
    }
  };
  auto add_rows = [&](float* dst, const float* add, const float* old, int row0, int step) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + step * (16 * wq + g + 8 * hh);
      if (row < 0 || row >= T_len) continue;
      float* at = dst + (size_t)row * DH + c0 + 2 * t;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<float2*>(at + 8 * c) =
            make_float2(old[4 * c + 2 * hh] + add[4 * c + 2 * hh],
                        old[4 * c + 2 * hh + 1] + add[4 * c + 2 * hh + 1]);
    }
  };

  int pi = 0, gi = 0;
  for (int grp = sp; grp * G < n_tiles; grp += nsplit, ++gi) {
    const int ks = gi % NKV, k0 = grp * G * BK;
    kt0 = grp * G;
    const bool first = gi == 0;  // the block's first group: partial rows not yet written
    const uint32_t kv_t = base + L::KV_AT + ks * L::KV;
    uint32_t live[G];  // key 32 wg + x of key tile u is live at bit x of live[u]
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int key = k0 + u * BK + 32 * wg + lane;
      live[u] = __ballot_sync(0xffffffffu,
                              key < T_len && !(pad != nullptr && pad[(size_t)b * T_len + key]));
    }
    // lse (in log2 units) and dsum of this thread's rows of query tile qt:
    // read one query tile ahead, so their latency passes under its pairs
    float lse_n[2], dsum_n[2];
    auto load_rowstats = [&](int qt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = qt * BQ + 16 * wq + g + 8 * hh;
        lse_n[hh] = i < T_len ? lse[rbase + i] * LOG2E : 0.f;
        dsum_n[hh] = i < T_len ? dsum[rbase + i] : 0.f;
      }
    };
    load_rowstats(first_q(grp));
    mbar_wait(&kv_full[ks], (gi / NKV) & 1);
    for (int qt = first_q(grp); qt < n_tiles; ++qt) {
      const int q0 = qt * BQ, D = q0 - k0 - (BK - 1);
      const float lse_r[2] = {lse_n[0], lse_n[1]}, dsum_r[2] = {dsum_n[0], dsum_n[1]};
      if (qt + 1 < n_tiles) load_rowstats(qt + 1);
      if (wg == 0) {
#pragma unroll
        for (int x = 0; x < R; ++x) ec[0][x] = 0.f;
      }
      float old[R];  // the partial rows the query tile finishes, read ahead
      const int fin = D - (G - 1) * BK + 63;  // warpgroup 1: block -(G - 1), row rl at fin - rl
#pragma unroll
      for (int uu = 0; uu < G; ++uu) {
        const int u = G - 1 - uu;  // the key tiles from the last down
        if (!meets(grp, qt, u)) continue;
        const int kt = grp * G + u, s = pi % NST;
        const bool top = uu == 0 || !meets(grp, qt, u + 1);  // the query tile's first pair
        const uint32_t q_t = base + s * L::ST, d_t = q_t + L::TILE, e_t = q_t + 2 * L::TILE;
        const uint32_t k_t = kv_t + 2 * u * L::TILE, v_t = k_t + L::TILE;
        mbar_wait(&full[s], (pi / NST) & 1);

        // ---- phase A
        {
          float sacc[16], pacc[16], bacc[48];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const uint64_t da = desc_k(q_t + kk * SLAB);
            mma_ss<32, 0, 0>(sacc, da, desc_k(k_t + 1024 * wg + kk * SLAB), kk > 0);
            mma_ss<32, 0, 0>(pacc, desc_k(d_t + kk * SLAB), desc_k(v_t + 1024 * wg + kk * SLAB),
                             kk > 0);
            mma_ss<96, 0, 0>(bacc, da, desc_k(e_t + 1024 * wg + kk * 2 * SLAB), kk > 0);
          }
          wg_commit();
          wg_wait0();
          fence_regs<16>(sacc);
          fence_regs<16>(pacc);
          fence_regs<48>(bacc);
          // the scratch in E's unowned columns: both warpgroups' band
          // products are done reading them
          if (L::SCR_IN_E) named_barrier(1, 32 * NCW);
          // the skew: band column (from row 32 wg) of row r, key 32 wg + j is
          // 64 - (16 wq + r) + j; the warp keeps columns 48 - 16 wq .. 95 -
          // 16 wq (chunks 6 - 2 wq ..), so it reads scratch column 16 - r + j
#pragma unroll
          for (int c = 0; c < 12; ++c) {
            const int cc = c - (6 - 2 * wq);
            if (cc >= 0 && cc < WB / 8) {
              *reinterpret_cast<float2*>(scr + g * WBS + 8 * cc + 2 * t) =
                  make_float2(bacc[4 * c], bacc[4 * c + 1]);
              *reinterpret_cast<float2*>(scr + (g + 8) * WBS + 8 * cc + 2 * t) =
                  make_float2(bacc[4 * c + 2], bacc[4 * c + 3]);
            }
          }
          __syncwarp();
          const __nv_bfloat16 zero = __float2bfloat16(0.f);
          const int kb = kt * BK;  // the key tile's first key
          // whether any of the warp's pairs is masked: a row past T, a dead
          // key, or a key past a row under the causal mask
          const bool masked = q0 + 16 * wq + 15 >= T_len || live[u] != 0xffffffffu ||
                              (causal && kb + 32 * wg + 31 > q0 + 16 * wq);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = g + 8 * hh, il = 16 * wq + r, i = q0 + il;
              const int jl = 8 * n + 2 * t, j = 32 * wg + jl;
              float p[2], ds[2];
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const float sc = sacc[4 * n + 2 * hh + x] + scr[r * WBS + 16 - r + jl + x];
                const bool ok = !masked || (i < T_len && ((live[u] >> (jl + x)) & 1) &&
                                            !(causal && kb + j + x > i));
                p[x] = ok ? exp2f(sc * scale_log2 - lse_r[hh]) : 0.f;
                ds[x] = p[x] * (pacc[4 * n + 2 * hh + x] - dsum_r[hh]) * scale;
              }
              const uint32_t at = (j >> 4) * 2048 + sw32(il, j & 15);
              *reinterpret_cast<uint32_t*>(p_s + at) = pack_bf16(p[0], p[1]);
              const uint32_t dsb = pack_bf16(ds[0], ds[1]);
              *reinterpret_cast<uint32_t*>(ds_s + at) = dsb;
              const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dsb);
              // distance (q0 + il) - (kb + j + x) sits at band column 64 - il + j + x
              const int v = 64 - il + j, dist = i - (kb + j);
              *reinterpret_cast<__nv_bfloat16*>(dsd_s + (v >> 4) * 2048 + sw32(il, v & 15)) =
                  dist >= 0 ? d2.x : zero;
              *reinterpret_cast<__nv_bfloat16*>(dsd_s + ((v + 1) >> 4) * 2048 +
                                                sw32(il, (v + 1) & 15)) =
                  dist - 1 >= 0 ? d2.y : zero;
            }
        }
        fence_async_smem();
        named_barrier(1, 32 * NCW);  // P, dS' and dsd are in place

        // ---- phase B. The partial rows the query tile finishes are read
        // under products, so their latency passes there (not at d_head
        // 128, where the registers are not there).
        if (G == 2)
#pragma unroll
          for (int x4 = 0; x4 < R / 4; ++x4) {
            const float4 v = acc_at(u, x4);
            acc[4 * x4] = v.x;
            acc[4 * x4 + 1] = v.y;
            acc[4 * x4 + 2] = v.z;
            acc[4 * x4 + 3] = v.w;
          }
        if (wg == 0) {
          if (u == 0 && DH <= 96) load_rows(old, dqa, q0, 1, first);
          wg_fence();
#pragma unroll
          for (int kq = 0; kq < BQ / 16; ++kq)  // dV += P^T dO
            mma_ss<DV, 1, 1>(acc, desc_mn(p_t + 512 * kq, 2048),
                             desc_mn(d_t + cs * SLAB + 512 * kq, SLAB));
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)  // dQ += dS' K
            mma_ss<DV, 0, 1>(ec[0], desc_k(ds_t + 2048 * kk),
                             desc_mn(k_t + cs * SLAB + 512 * kk, SLAB));
#pragma unroll
          for (int kv = 0; kv < EB / 16; ++kv)  // + dsd E_band
            mma_ss<DV, 0, 1>(ec[0], desc_k(dsd_t + 2048 * kv),
                             desc_mn(e_t + cs * 2 * SLAB + 512 * kv, 2 * SLAB));
          wg_commit();
          wg_wait0();
          fence_regs<R>(acc);
          fence_regs<R>(ec[0]);
        } else {
          if (top && (G == 2 || DH <= 96)) load_rows(old, dep, fin, -1, first);
          if (G == 2 && top && u == 0) add_rows(dep, ec[0], old, fin, -1);  // block -1 had no pair
          // band rows 64..127 to block -u; rows 0..63 to block 1 - u, which
          // is block 1 at u = 0: en (G = 1), or ec[0], block -1's registers
          // once that is written (G = 2)
          float* lo = ec[G - 1 - u];
          float* hi = u == 0 ? (G == 1 ? en : ec[0]) : ec[G - u];
          wg_fence();
#pragma unroll
          for (int kq = 0; kq < BQ / 16; ++kq) {
            const uint64_t dq_ = desc_mn(q_t + cs * SLAB + 512 * kq, SLAB);
            mma_ss<DV, 1, 1>(acc, desc_mn(ds_t + 512 * kq, 2048), dq_);  // dK += dS'^T Q
            mma_ss<DV, 1, 1>(lo, desc_mn(dsd_t + 8192 + 512 * kq, 2048), dq_);
            mma_ss<DV, 1, 1>(hi, desc_mn(dsd_t + 512 * kq, 2048), dq_, u > 0 || kq > 0);
          }
          wg_commit();
          wg_wait0();
          fence_regs<R>(acc);
          fence_regs<R>(lo);
          fence_regs<R>(hi);
          if (G == 2 && top && u == 1) add_rows(dep, ec[0], old, fin, -1);  // block -1 is done
        }
        if (G == 2)  // back to shared memory (zeros for the next group)
#pragma unroll
          for (int x4 = 0; x4 < R / 4; ++x4)
            acc_at(u, x4) = qt == n_tiles - 1 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                           : make_float4(acc[4 * x4], acc[4 * x4 + 1],
                                                         acc[4 * x4 + 2], acc[4 * x4 + 3]);
        if (qt == n_tiles - 1) {  // the key tile's last query tile: its dK or dV out
          store_out(u);
#pragma unroll
          for (int x = 0; x < R; ++x) acc[x] = 0.f;
        }
        named_barrier(1, 32 * NCW);  // every product of the pair is done with its tiles
        ++pi;
        if (tid == 0) produce(pi, gi + (qt == n_tiles - 1 && u == 0));
      }
      // the query tile has met the group
      if (wg == 0) {
        if (DH > 96) load_rows(old, dqa, q0, 1, first);
        add_rows(dqa, ec[0], old, q0, 1);
      } else if (G == 1) {
        if (DH > 96) load_rows(old, dep, fin, -1, first);
        add_rows(dep, ec[0], old, fin, -1);
#pragma unroll
        for (int x = 0; x < R; ++x) ec[0][x] = en[x];
      } else {  // blocks 0 and 1 move down to -1 and 0
#pragma unroll
        for (int x = 0; x < R; ++x) {
          const float y = ec[0][x];
          ec[0][x] = ec[G - 1][x];
          ec[G - 1][x] = y;
        }
      }
    }
    // the group's end: the dE blocks still in flight (block -(G - 1) + j
    // of the query tile past the last)
    if (wg == 1) {
      const int D = n_tiles * BQ - k0 - (BK - 1);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float prev[R];
        const int row0 = D + (j - (G - 1)) * BK + 63;
        load_rows(prev, dep, row0, -1, first);
        add_rows(dep, ec[j], prev, row0, -1);
#pragma unroll
        for (int x = 0; x < R; ++x) ec[j][x] = 0.f;
      }
    }
  }
}
// dQ = the nsplit blocks' partials summed in block order, cast once; 4
// values a thread (n is a multiple of 16)
__global__ void dq_reduce_kernel(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                                 size_t n, int nsplit) {
  const size_t x = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (x >= n) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s) {
    if (s == nsplit) break;
    const float4 v = *reinterpret_cast<const float4*>(dq_acc + s * n + x);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<uint2*>(dq + x) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}

// Blocks a (b, h): one where the (b, h) alone nearly fill the card (at
// least 7/8 of its SMs, one block an SM), so each partial has one block
// and the reductions read half as much; else two, on alternate groups.
inline int split_for(int B, int H) {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return MAX_SPLIT;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return B * H >= sms[dev] - sms[dev] / 8 ? 1 : MAX_SPLIT;
}

template <int DH, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
                   void* dq_acc, void* de_part, int B, int H, int T_len, int max_seq, int causal,
                   float scale, int nsplit, cudaStream_t stream) {
  Maps maps;
  cudaError_t err;
  if ((err = sm90_host::slab_map(&maps.q, q, B * H, T_len, DH, BQ)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.k, k, B * H, T_len, DH, BK)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.v, v, B * H, T_len, DH, BK)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.d, dout, B * H, T_len, DH, BQ)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.e, e, 1, max_seq, DH, EB)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_tc_kernel<DH, DV>;
  const int smem = Layout<DH, DV>::TOTAL;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H * nsplit, DH / DV), NTH, smem, stream>>>(
      maps, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(dq_acc), static_cast<float*>(de_part),
      H, T_len, max_seq, causal, scale, scale * LOG2E, nsplit);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dq, void* dk,
                   void* dv, void* de, void* dq_acc, void* de_part, int B, int H, int T_len,
                   int max_seq, int causal, float scale, cudaStream_t stream) {
  cudaError_t err;
  int parts = B * H;  // dE partials to sum: one per (b, h) in f32, nsplit in bf16
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = flash_rel_attn_bwd_kernel<DH>;
    const size_t smem = smem_bytes<DH>();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<B * H, Tile<DH>::NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(e), static_cast<const uint8_t*>(pad),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(dsum), static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), static_cast<float*>(dq_acc), static_cast<float*>(de_part), H,
        T_len, max_seq, causal, scale);
  } else {
    // past d_head 128, two blocks a (b, h) and split, on the column halves
    constexpr int DV = DH > 128 ? DH / 2 : DH;
    const int nsplit = tc::split_for(B, H * (DH / DV));
    err = tc::launch<DH, DV>(q, k, v, e, pad, dout, lse, dsum, dk, dv, dq_acc, de_part, B, H,
                             T_len, max_seq, causal, scale, nsplit, stream);
    if (err != cudaSuccess) return err;
    const size_t n = (size_t)B * H * T_len * DH;
    tc::dq_reduce_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), n, nsplit);
    parts *= nsplit;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = max_seq * DH, threads = 256;
  de_reduce_kernel<T><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(de_part), static_cast<T*>(de), parts, T_len, max_seq, DH);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* e,
                        const void* pad, const void* dout, const void* lse, const void* dsum,
                        void* dq, void* dk, void* dv, void* de, void* dq_acc, void* de_part,
                        int B, int H, int T_len, int dh, int max_seq, int causal,
                        float scale, cudaStream_t s) {
#define FLASH_BWD_CASE(D)                                                                    \
  case D:                                                                                    \
    return launch<T, D>(q, k, v, e, pad, dout, lse, dsum, dq, dk, dv, de, dq_acc, de_part, B, \
                        H, T_len, max_seq, causal, scale, s);
  switch (dh) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(48)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(192)
    FLASH_BWD_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when both launches were accepted. dtype: 0 =
// float32, 1 = bfloat16 (q, k, v, e, dout, dq, dk, dv, de); lse and dsum are
// f32 [B, H, T]; pad may be null. dq_acc is f32 scratch [2, B, H, T, dh] and
// de_part f32 scratch [2*B*H, T, dh] (the f32 path uses their first halves,
// the bf16 path one half per block of a (b, h), one or two blocks); the
// kernels fill what they use.
// scale is c = 1/sqrt(d_head) of the caller's heads, which may have fewer
// columns than dh (zero columns padded up to an instantiated dh add nothing).
// Launches on `stream` and does not synchronise.
int flash_rel_attn_bwd(const void* q, const void* k, const void* v, const void* e,
                       const void* pad, const void* dout, const void* lse, const void* dsum,
                       void* dq, void* dk, void* dv, void* de, void* dq_acc, void* de_part,
                       int B, int H, int T_len, int dh, int max_seq, int causal, int dtype,
                       float scale, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, e, pad, dout, lse, dsum, dq, dk, dv, de, dq_acc, de_part,
                              B, H, T_len, dh, max_seq, causal, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, e, pad, dout, lse, dsum, dq, dk, dv, de, dq_acc,
                                      de_part, B, H, T_len, dh, max_seq, causal, scale, s);
  return cudaErrorInvalidValue;
}

// dsum = rowsum(dout * o) in f32 [rows] for dout and o [rows, dh] of one
// dtype (0 = float32, 1 = bfloat16). Returns a cudaError_t; launches on
// `stream` and does not synchronise.
int flash_rel_attn_dsum(const void* dout, const void* o, void* dsum, int rows, int dh,
                        int dtype, void* stream) {
  if (rows <= 0 || dh <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = (int)(((size_t)rows * 32 + threads - 1) / threads);
  if (dtype == 0)
    dsum_kernel<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(dout),
                                                  static_cast<const float*>(o),
                                                  static_cast<float*>(dsum), rows, dh);
  else if (dtype == 1 && dh % 8 == 0 && ((uintptr_t)dout | (uintptr_t)o) % 16 == 0)
    dsum_vec_kernel<<<(unsigned)(((size_t)rows * 8 + threads - 1) / threads), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(o),
        static_cast<float*>(dsum), rows, dh);
  else if (dtype == 1)
    dsum_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(o),
        static_cast<float*>(dsum), rows, dh);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

const char* flash_rel_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
