// Flash relative attention, backward: the key-major sweeps, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of midi_emotion_tpu/ops/pallas_attention.py:
//   * _bwd_dkdv_kernel (BWD_IMPL="fused", launched by _bwd_dkdv_call): dK, dV;
//   * _bwd_dkdv_dq_kernel (BWD_IMPL="split", launched by _bwd_dkdv_dq_call):
//     dK, dV and the key term of dQ.
// With c = 1/sqrt(dh), the forward's saved lse and dsum_i = dO_i . O_i (the
// notation of flash_rel_attn_bwd.cu):
//
//     P[i,j]    = exp(c q_i . (k_j + E[ms-1-(i-j)] [j <= i]) - lse_i)   (0 where masked)
//     dS'[i,j]  = c P[i,j] (dO_i . V_j - dsum_i)
//     dV_j      = sum_i P[i,j] dO_i
//     dK_j      = sum_i dS'[i,j] q_i
//     dQ_qk_i   = sum_j dS'[i,j] k_j          (with the dQ term only)
//
// The relative term's share of dQ and dE is left to the distance-domain
// kernel (flash_rel_attn_bwd_q.cu), as on the TPU.
//
// bf16 (the `split` and `fused` training paths): tensor cores. Bound on
// the H100: operations. Per visible tile pair the products are S = Q K^T,
// the band Q E_band^T (P needs Srel), dP = dO V^T, dV += P^T dO, dK +=
// dS'^T Q and, with the dQ term, dQ += dS' K: flash_rel_attn_bwd.cu's
// kernel 4 without its distance-domain half (the dsd scatter, dQ_rel, dE,
// the dE partials and their carry).
//   * with dQ (kernel 7, wg::flash_bwd_kv_wg_tc_kernel): kernel 4's Hopper
//     design, the key-major sweep of bwd_key_major.cuh (the layout, the
//     walk and its TMA producer, phase A, the row helpers and the dQ
//     reduction, shared with kernel 4). At B 8, H 16,
//     T 1216, d_head 48 the products the visible pairs need take 0.0550 ms
//     at 989 TFLOP/s. Two warpgroups share each tile pair, every product a
//     wgmma with f32 sums, per pair:
//       phase A, warpgroup h (keys 32 h ..): S = Q K_h^T, dP = dO V_h^T
//         (m64n32) and the band Q E^T over the 96 band rows its keys reach
//         (m64n96), skewed into Srel through a per-warp scratch; P = exp(s
//         - lse), dS' = c P (dP - dsum) in f32, both rounded to bf16 into
//         shared tiles (as the TPU kernel rounds ds); fence.proxy.async,
//         then the barrier that hands them to phase B;
//       phase B, warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS'^T Q (P,
//         dS', Q and dO read MN-major); warpgroup DQ_WG: dQ += dS' K (K read
//         MN-major), in registers while the query tile meets the group.
//     Thread 0 copies by TMA under mbarriers: each group's K and V into a
//     ring of NKV, each pair's Q, dO and 128-row E band into a ring of two,
//     refilling a slot right after the barrier that ends its last reader. A
//     block sweeps groups of G key tiles of one (b, h) (two up to d_head
//     48, their f32 dK and dV kept in shared memory between pairs) and,
//     inside, the query tiles that see them; a query tile meets the group's
//     key tiles one after the other, so its dQ partial rows are read and
//     written once a group (the block's first group stores without
//     reading; rows it never reaches are zeroed first). Blocks a (b, h):
//     one where B * H fills 7/8 of the SMs (one block an SM; 30 MB of f32
//     partial at the flagship shape, inside the 50 MB L2), else two on
//     alternate groups (the wrapper chooses, by kernel 4's rule:
//     ops/flash_attention.py::bwd_split); the partials [2, B, H, T, dh]
//     are summed in block order and cast once by km::dq_reduce_kernel, as
//     the TPU casts its f32 dq scratch once: no atomics, two calls give
//     bitwise-equal outputs.
//   * dK/dV alone (kernel 9, tc::flash_bwd_kv_tc_kernel): the
//     earlier mma.sync form of the same sweep without dQ, m16n8k16 with
//     bf16 operands and f32 sums, cp.async copies; a key tile carries no
//     state across tiles, so the grid is free: `split` blocks a (b, h),
//     block s taking key tiles s, s + split, ..., numbered key-tile-major
//     so that the longest (causal: the first) key tiles start first. The
//     wrapper passes split = the number of key tiles (one block per (b, h,
//     key tile), 2 432 blocks at the flagship shape) or 2. Its dK and dV
//     sum the same products over the same query tiles in the same order as
//     kernel 7's, on other instructions: within bf16 rounding of them, not
//     bit for bit.
//
// f32 (the checks' path, held to 1e-4; TF32 keeps about three digits): the
// CUDA cores, simple and correct first:
//   * tiles of 64 rows (32 at d_head 128, so the f32 staging fits a block's
//     shared memory) and 4 threads a row;
//   * dK/dV alone: one block per (b, h, key tile). The tile owns
//     its dK and dV, kept in registers, and sweeps the query tiles that see
//     it (causal: those at or below the diagonal);
//   * with dQ_qk: dQ crosses key tiles, so the kernel takes kernel 4's
//     ownership scheme: one block per (b, h) sweeps its key tiles, and dQ_qk
//     accumulates in an f32 scratch [B, H, T, dh] that only this block
//     touches, cast once at the end. No atomics, nothing summed in bf16, and
//     the result is deterministic;
//   * per tile pair the block stages K, V, Q, dO and the band of BQ + BK - 1
//     E rows (zero for negative distances) in shared memory as f32, then runs
//     flash_rel_attn_bwd.cu's phases with its threads remapped: A, thread =
//     (query row, 16 keys): P and dS' into shared [BQ][BK] tiles; B, thread =
//     (key row, dh/4 columns): dV and dK; C (dQ term only), thread = (query
//     row, dh/4 columns): dQ_qk.
// CUDA-core f32 FMAs fed from shared memory bound that path. Kernel 9's
// mma.sync helpers are copied from the earlier flash_rel_attn_bwd.cu
// (namespace tc here); kernel 7 takes the sweep from bwd_key_major.cuh and
// Hopper's building blocks (TMA, mbarriers, wgmma) from hopper_sm90.cuh,
// which kernels/build.py hashes into this library's name.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bwd_key_major.cuh"
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
  constexpr int BQ = Tile<DH>::BQ, BK = Tile<DH>::BK, BAND = Tile<DH>::BAND, PS = Tile<DH>::PS;
  return (size_t)((2 * BK + 2 * BQ + BAND) * row_stride<DH>() + 2 * BQ * PS + 2 * BQ + BK) *
         sizeof(float);
}

template <typename T, int DH, bool WITH_DQ>
__global__ void __launch_bounds__(Tile<DH>::NT)
flash_rel_attn_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ e,
                             const uint8_t* __restrict__ pad, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ dsum,
                             T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dq,
                             float* __restrict__ dq_acc, int H, int T_len, int max_seq,
                             int causal, float scale) {
  static_assert(DH % 16 == 0, "each of 4 threads takes a float4-aligned quarter row");
  constexpr int BQ = Tile<DH>::BQ, BK = Tile<DH>::BK, BAND = Tile<DH>::BAND, NT = Tile<DH>::NT,
                PS = Tile<DH>::PS;
  constexpr int RS = row_stride<DH>();
  constexpr int CH = DH / 4;  // columns per thread in phases B and C
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
  const int n_tiles = (T_len + BK - 1) / BK;
  // dK/dV alone: block = (b * H + h) * n_tiles + key tile; with dQ: b * H + h
  const int bh = WITH_DQ ? blockIdx.x : blockIdx.x / n_tiles;
  const int kt_begin = WITH_DQ ? 0 : blockIdx.x - bh * n_tiles;
  const int kt_end = WITH_DQ ? n_tiles : kt_begin + 1;
  const int b = bh / H;
  const size_t base = (size_t)bh * T_len * DH;
  const int row4 = tid >> 2;  // phases A-C: the row this thread works on
  const int c = tid & 3;      // phases B-C: its quarter of the columns
  float* dqa = WITH_DQ ? dq_acc + base : nullptr;

  if constexpr (WITH_DQ)
    for (int x = tid; x < T_len * DH; x += NT) dqa[x] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, T_len - k0);
    __syncthreads();  // the previous key tile's phases are done with ks, vs
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
      const int dist0 = q0 - k0 - (BK - 1);  // distance of band row 0
      for (int x = tid; x < BAND * DH; x += NT) {
        const int u = x / DH, d = x - u * DH;
        const int dist = dist0 + u;
        float ev = 0.f;
        if (dist >= 0 && dist < max_seq) ev = to_f32(e[(size_t)(max_seq - 1 - dist) * DH + d]);
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

      // phase C: dQ_qk_i += dS' K for query row row4, columns c
      if constexpr (WITH_DQ) if (q0 + row4 < T_len) {
        float acc[CH];
#pragma unroll
        for (int x = 0; x < CH; ++x) acc[x] = 0.f;
#pragma unroll 4
        for (int jj = 0; jj < BK; ++jj) {
          const float ds = dss[row4 * PS + jj];
          const float4* k4 = reinterpret_cast<const float4*>(ks + jj * RS + c * CH);
#pragma unroll
          for (int x4 = 0; x4 < CH / 4; ++x4) {
            const float4 kk = k4[x4];
            acc[4 * x4 + 0] = fmaf(ds, kk.x, acc[4 * x4 + 0]);
            acc[4 * x4 + 1] = fmaf(ds, kk.y, acc[4 * x4 + 1]);
            acc[4 * x4 + 2] = fmaf(ds, kk.z, acc[4 * x4 + 2]);
            acc[4 * x4 + 3] = fmaf(ds, kk.w, acc[4 * x4 + 3]);
          }
        }
        float* dst = dqa + (size_t)(q0 + row4) * DH + c * CH;
#pragma unroll
        for (int x = 0; x < CH; ++x) dst[x] += acc[x];
      }
    }

    if (k0 + row4 < T_len) {
      const size_t g = base + (size_t)(k0 + row4) * DH + c * CH;
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        dk[g + x] = from_f32<T>(dk_acc[x]);
        dv[g + x] = from_f32<T>(dv_acc[x]);
      }
    }
  }

  if constexpr (WITH_DQ) {
    __syncthreads();  // every dQ_qk accumulation of this (b, h) has landed
    for (int x = tid; x < T_len * DH; x += NT) dq[base + x] = from_f32<T>(dqa[x]);
  }
}


// ---------------------------------------------------------------------------
// the bf16 path of dK, dV and dQ_qk: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NWARP = 8;
constexpr int NTH = 32 * NWARP;
constexpr int PS = BK + 8;    // bf16 row stride of the P and dS' tiles
constexpr int WB = 48;        // band rows a warp multiplies in phase A: its 47 distances
constexpr int WBS = WB + 8;   // row stride of a warp's band scratch (floats)
constexpr int SMEM_SM = 233472;  // shared memory of an SM, 1 KB a block reserved
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Layout {
  static constexpr int RS = DH + 8;   // bf16 row stride: an odd number of 16-byte units
  static constexpr int CPR = DH / 8;  // 16-byte chunks a row
  static constexpr int KV_BYTES = 2 * BK * RS * 2 + BK * 4;      // K, V, key flags
  static constexpr int ST_BYTES = 2 * BQ * RS * 2 + 2 * BQ * 4;  // Q, dO, lse, dsum
  static constexpr int bytes(int stages) {
    return stages * (KV_BYTES + ST_BYTES + 2 * 64 * RS * 2) + 2 * BQ * PS * 2 +
           NWARP * 16 * WBS * 4;
  }
  // two ring stages (the next pair's copies under this pair's products)
  // where two blocks an SM still fit
  static constexpr int STAGES = 2 * (bytes(2) + 1024) <= SMEM_SM ? 2 : 1;
  static constexpr int NSLOT = 2 * STAGES;  // E chunks of 64 rows: two a pair in work
  static constexpr int ST_AT = STAGES * KV_BYTES;
  static constexpr int E_AT = ST_AT + STAGES * ST_BYTES;
  static constexpr int P_AT = E_AT + NSLOT * 64 * RS * 2;
  static constexpr int SCR_AT = P_AT + 2 * BQ * PS * 2;
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

// Block s of the `split` a (b, h) sweeps key tiles s, s + split, ... and,
// inside, the query tiles that see them (causal: those at or below the
// diagonal), with 8 warps. Per tile pair:
//   phase A, warp (rows 16 (w % 4), keys 32 (w / 4)): S = Q K^T, the band
//     Q E_band^T over its 48 distances and dP = dO V^T on the tensor cores;
//     the band skewed into Srel through a per-warp scratch (P needs it);
//     P = exp(s - lse) and dS' = c P (dP - dsum) in f32, both rounded to
//     bf16 into shared tiles;
//   phase B, warp (16-row block w / 2, channel half w % 2): dV += P^T dO and
//     dK += dS'^T Q (registers, the key tile's own).
// Blocks are numbered key-tile-major: block s of every (b, h) before block
// s + 1.
template <int DH>
__global__ void __launch_bounds__(NTH, Layout<DH>::MIN_BLOCKS)
flash_bwd_kv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ e,
                       const uint8_t* __restrict__ pad, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ dsum,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                       int T_len, int max_seq, int causal, float scale, float scale_log2,
                       int split) {
  static_assert(BQ == 64 && BK == 64, "the band moves one 64-row chunk a query tile");
  using L = Layout<DH>;
  constexpr int RS = L::RS, CPR = L::CPR, KS = DH / 16, NH = DH / 16;  // NH: n-tiles a half
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_bh = gridDim.x / split;
  const int bh = blockIdx.x % n_bh, sp = blockIdx.x / n_bh;
  const int b = bh / H;
  const size_t base = (size_t)bh * T_len * DH, rbase = (size_t)bh * T_len;
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P_AT);  // P [BQ][PS]
  __nv_bfloat16* dss = ps + BQ * PS;                                      // dS' [BQ][PS]
  float* scr = reinterpret_cast<float*>(smem + L::SCR_AT) + warp * 16 * WBS;
  auto kv_buf = [&](int i) { return reinterpret_cast<__nv_bfloat16*>(smem + i * L::KV_BYTES); };
  auto st_buf = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::ST_AT + s * L::ST_BYTES);
  };

  const int n_tiles = (T_len + BK - 1) / BK;
  auto first_q = [&](int kt) { return causal ? kt : 0; };
  if (sp >= n_tiles) return;
  // The E band of a pair (row u at distance q0 - k0 - (BK - 1) + u, zero
  // where negative) is two chunks of 64 rows in a ring of NSLOT: the next
  // query tile's band starts 64 distances on, so its lower chunk is this
  // pair's upper one and only its upper chunk is copied (both at a key
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
  // pair (kt, qt) into ring stage s: at a key tile's first pair its K, V and
  // key flags; always Q, dO, lse, dsum and the band's new chunks; (lo, hi)
  // come back as the band's chunks, given the last pair's upper one in hi
  auto load = [&](int kt, int qt, int s, int& lo, int& hi) {
    const int k0 = kt * BK, q0 = qt * BQ;
    const int dist0 = q0 - k0 - (BK - 1);
    if (qt == first_q(kt)) {
      lo = n_chunks++;
      load_chunk(lo, dist0);
    } else {
      lo = hi;
    }
    hi = n_chunks++;
    load_chunk(hi, dist0 + 64);
    if (qt == first_q(kt)) {
      __nv_bfloat16* ks = kv_buf(kt / split % L::STAGES);
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
        live[j] = (k0 + j < T_len && !(pad != nullptr && pad[(size_t)b * T_len + k0 + j])) ? 1.f
                                                                                           : 0.f;
    }
    __nv_bfloat16* qs = st_buf(s);
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
    cp_commit();
  };

  float dva[NH][4], dka[NH][4];  // dV, dK of keys 16 (w / 2).., channel half w % 2
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dva[n][x] = dka[n][x] = 0.f;
  const int ra = 16 * (warp & 3), ka = 32 * (warp >> 2), ub = ra - ka + 32;  // phase A
  const int mq = warp >> 1, c0 = (warp & 1) * (DH / 2);                        // phase B
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;  // A row-major
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;  // B, A^T

  int kt = sp, qt = first_q(sp), nk = kt, nq = qt;
  auto next = [&](int& a, int& c) {
    if (++c == n_tiles) c = first_q(a += split);
  };
  next(nk, nq);
  int lo = 0, hi = 0, nlo = 0, nhi = 0;  // this pair's band chunks, and the next pair's
  load(kt, qt, 0, lo, hi);
  for (int pair = 0;; ++pair) {
    const int s = pair % L::STAGES;
    const bool more = nk < n_tiles;
    cp_wait<0>();
    __syncthreads();  // this pair's tiles have landed; every warp is done with the last pair
    // the next pair into the other stage, whose last reader was the last pair
    nhi = hi;
    if (L::STAGES > 1 && more) load(nk, nq, (pair + 1) % L::STAGES, nlo, nhi);
    const int k0 = kt * BK, q0 = qt * BQ;
    const __nv_bfloat16* ks = kv_buf(kt / split % L::STAGES);
    const __nv_bfloat16* vs = ks + BK * RS;
    const float* live = reinterpret_cast<const float*>(vs + BK * RS);
    const __nv_bfloat16* qs = st_buf(s);
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
#pragma unroll
        for (int np = 0; np < WB / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, erow(ub + np * 16 + brow) + st * 16 + bcol);
          mma(bacc[2 * np], qa, bf[0], bf[1]);
          mma(bacc[2 * np + 1], qa, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < WB / 8; ++n) {
        *reinterpret_cast<float2*>(scr + g * WBS + 8 * n + 2 * t) =
            make_float2(bacc[n][0], bacc[n][1]);
        *reinterpret_cast<float2*>(scr + (g + 8) * WBS + 8 * n + 2 * t) =
            make_float2(bacc[n][2], bacc[n][3]);
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h, il = ra + r, i = q0 + il, c = 8 * n + 2 * t, jj = ka + c;
          float p[2], ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            // the skew: Srel of (row r, key c + x) is band column r - (c + x) + 31
            const float sc = sacc[n][2 * h + x] + scr[r * WBS + r - c - x + 31];
            const bool ok = i < T_len && live[jj + x] != 0.f && !(causal && k0 + jj + x > i);
            p[x] = ok ? exp2f(sc * scale_log2 - lse_s[il] * LOG2E) : 0.f;
            ds[x] = p[x] * (dpacc[n][2 * h + x] - dsum_s[il]) * scale;
          }
          *reinterpret_cast<uint32_t*>(ps + il * PS + jj) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(dss + il * PS + jj) = pack_bf16(ds[0], ds[1]);
        }
    }
    __syncthreads();

    // ---- phase B
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {  // dV += P^T dO, dK += dS'^T Q
      uint32_t pa[4], sa[4];
      ldsm_x4_t(pa, ps + (16 * kq + brow) * PS + 16 * mq + bcol);
      ldsm_x4_t(sa, dss + (16 * kq + brow) * PS + 16 * mq + bcol);
      mma_kn<NH>(dva, pa, dos + 16 * kq * RS + c0, RS, lane);
      mma_kn<NH>(dka, sa, qs + 16 * kq * RS + c0, RS, lane);
    }
    if (qt == n_tiles - 1) {  // the key tile's last pair: its dK and dV
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + 16 * mq + g + 8 * h;
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          if (key < T_len) {
            const size_t at = base + (size_t)key * DH + c0 + 8 * n + 2 * t;
            *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(dka[n][2 * h], dka[n][2 * h + 1]);
            *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
          }
          dka[n][2 * h] = dka[n][2 * h + 1] = dva[n][2 * h] = dva[n][2 * h + 1] = 0.f;
        }
      }
    }
    if (!more) break;
    kt = nk;
    qt = nq;
    next(nk, nq);
    if (L::STAGES == 1) {
      __syncthreads();  // every warp is done with the one stage
      load(kt, qt, 0, lo, hi);
    } else {
      lo = nlo;
      hi = nhi;
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the bf16 path of dK, dV and dQ_qk (kernel 7): the key-major sweep of
// bwd_key_major.cuh
// ---------------------------------------------------------------------------

// The switches of scripts/torch_key_sweep_ablation.py, which defines them
// ahead of a copy of this file; the libraries as built define none, so
// each takes the value below.
#ifndef BWD_KV_DQ_WG
#define BWD_KV_DQ_WG 0  // the warpgroup that forms dQ += dS' K: 0 (beside dV) or 1 (beside dK)
#endif
#ifndef BWD_KV_G
#define BWD_KV_G 0      // key tiles a group up to d_head 48: 0 as built (2), or 1 or 2
#endif
#ifndef BWD_KV_AHEAD
#define BWD_KV_AHEAD 48  // up to this d_head, dQ partial rows are read under the products
#endif

namespace wg {

using namespace km;

constexpr int DQ_WG = BWD_KV_DQ_WG;
static_assert(DQ_WG == 0 || DQ_WG == 1, "dQ on one of the two warpgroups");

// key tiles a block sweeps the query tiles with: two up to d_head 48,
// where shared memory holds both key tiles' f32 dK and dV between pairs;
// no tiles of its own
template <int DH>
using Layout = km::Layout<DH, (DH > 48 ? 1 : BWD_KV_G > 0 ? BWD_KV_G : 2), 0>;

// Block s of the nsplit a (b, h) walks its groups of key tiles as
// bwd_key_major.cuh sets out, thread 0 copying. Per tile pair: phase A
// (km::phase_a); phase B, warpgroup 0: dV += P^T dO, warpgroup 1: dK +=
// dS'^T Q, warpgroup DQ_WG: dQ += dS' K, in registers while the query
// tile meets the group; then its rows of this block's f32 dQ partial are
// read and written once (see the note at the top).
template <int DH>
__global__ void __launch_bounds__(NTH, 1)
flash_bwd_kv_wg_tc_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ pad,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ dq_acc, int H, int T_len, int max_seq, int causal,
                          float scale, float scale_log2, int nsplit) {
  using L = Layout<DH>;
  constexpr int G = L::G, NST = L::NST, NKV = L::NKV, R = DH / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_AT);
  uint64_t* kv_full = full + NST;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int wgi = warp >> 2, wq = warp & 3;  // warpgroup (phase A: keys 32 wgi ..); warp in it
  const int bh = blockIdx.x / nsplit, sp = blockIdx.x % nsplit, b = bh / H;
  const size_t base_q = (size_t)bh * T_len * DH, rbase = (size_t)bh * T_len;
  // this block's dQ partial [T][DH] (of [nsplit][B*H][T][DH])
  float* dqa = dq_acc + ((size_t)sp * (gridDim.x / nsplit) + bh) * T_len * DH;
  const int n_tiles = (T_len + BK - 1) / BK;
  const Walk<G> walk{n_tiles, causal, sp, nsplit};

  // zeros: the dQ rows the block never writes (query tiles before its
  // first group's first; all when it has no group)
  {
    const bool none = sp * G >= n_tiles;
    const int dq_zero = none ? T_len : min(T_len, walk.first_q(sp) * BQ);
    for (int x = tid; x < dq_zero * DH; x += NTH) dqa[x] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    for (int s = 0; s < NKV; ++s) mbar_init(&kv_full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (sp * G >= n_tiles) return;

  Producer<L> prod(walk, bh, max_seq);
  if (tid == 0) prod.produce(smem, maps, full, kv_full, 0, 0);

  const Rows<DH> rows{wq, lane >> 2, lane & 3, T_len};
  const uint32_t p_t = base + L::P_AT, ds_t = p_t + 8192;
  unsigned char* p_s = smem + L::P_AT;
  unsigned char* ds_s = p_s + 8192;
  float* scr = reinterpret_cast<float*>(smem + L::SCR_AT) + warp * 16 * WBS;
  // warpgroup 0: dV of the pair's key tile, 1: dK (rows = keys); with G = 2
  // read from and written back to shared memory around each pair's
  // products. Warpgroup DQ_WG: the query tile's dQ over the group (rows =
  // queries).
  float acc[R], dqr[R];
  const AccSlab<DH> slab{reinterpret_cast<float4*>(smem + L::ACC_AT) + (tid & 127), wgi};
#pragma unroll
  for (int x = 0; x < R; ++x) acc[x] = dqr[x] = 0.f;
  if (G == 2)
#pragma unroll
    for (int u = 0; u < G; ++u) slab.zero(u);

  auto mma_dq = [&](uint32_t k_t) {  // dQ += dS' K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_ss<DH, 0, 1>(dqr, desc_k(ds_t + 2048 * kk), desc_mn(k_t + 512 * kk, SLAB));
  };

  int pi = 0, gi = 0;
  for (int grp = sp; grp * G < n_tiles; grp += nsplit, ++gi) {
    const int ks = gi % NKV, k0 = grp * G * BK;
    const bool first = gi == 0;  // the block's first group: partial rows not yet written
    const uint32_t kv_t = base + L::KV_AT + ks * L::KV;
    uint32_t live[G];  // key 32 wgi + x of key tile u is live at bit x of live[u]
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int key = k0 + u * BK + 32 * wgi + lane;
      live[u] = __ballot_sync(0xffffffffu,
                              key < T_len && !(pad != nullptr && pad[(size_t)b * T_len + key]));
    }
    // lse (in log2 units) and dsum of this thread's rows of a query tile:
    // read one query tile ahead, so their latency passes under its pairs
    float lse_n[2], dsum_n[2];
    rows.stats(lse_n, dsum_n, lse + rbase, dsum + rbase, walk.first_q(grp) * BQ);
    mbar_wait(&kv_full[ks], (gi / NKV) & 1);
    for (int qt = walk.first_q(grp); qt < n_tiles; ++qt) {
      const int q0 = qt * BQ;
      const float lse_r[2] = {lse_n[0], lse_n[1]}, dsum_r[2] = {dsum_n[0], dsum_n[1]};
      if (qt + 1 < n_tiles) rows.stats(lse_n, dsum_n, lse + rbase, dsum + rbase, q0 + BQ);
      float old[R];  // the partial rows the query tile adds to
#pragma unroll
      for (int uu = 0; uu < G; ++uu) {
        const int u = G - 1 - uu;  // the key tiles from the last down; u = 0 always meets
        if (!walk.meets(grp, qt, u)) continue;
        const int kt = grp * G + u, s = pi % NST, kb = kt * BK;
        const uint32_t q_t = base + s * L::ST, d_t = q_t + L::TILE;
        const uint32_t k_t = kv_t + 2 * u * L::TILE;
        mbar_wait(&full[s], (pi / NST) & 1);

        phase_a<DH>(q_t, k_t, p_s, ds_s, scr, wgi, wq, lane, q0, kb, live[u], T_len, causal,
                    lse_r, dsum_r, scale, scale_log2, [](int, int, uint32_t) {});
        fence_async_smem();
        named_barrier(1, NTH);  // P and dS' are in place

        // ---- phase B. The partial rows the query tile adds to are read
        // at its last pair, under the products, up to d_head BWD_KV_AHEAD,
        // and after the products past it, where each way was faster on the
        // card (scripts/torch_key_sweep_ablation.py: reading after cost
        // 3-5% at 32 and 48; reading ahead cost 7% at 64, with 221
        // registers against 188, and at 96 spilled).
        // Each warpgroup's products run from one fence to one wait, as
        // kernel 4's: a branch joining between them would have ptxas
        // serialize the wgmma.
        if (G == 2) slab.load(u, acc);
        if (wgi == DQ_WG && u == 0 && DH <= BWD_KV_AHEAD) rows.load(old, dqa, q0, 1, first);
        if (wgi == 0) {
          wg_fence();
#pragma unroll
          for (int kq = 0; kq < BQ / 16; ++kq)  // dV += P^T dO
            mma_ss<DH, 1, 1>(acc, desc_mn(p_t + 512 * kq, 2048), desc_mn(d_t + 512 * kq, SLAB));
          if constexpr (DQ_WG == 0) mma_dq(k_t);
          wg_commit();
          wg_wait0();
        } else {
          wg_fence();
#pragma unroll
          for (int kq = 0; kq < BQ / 16; ++kq)  // dK += dS'^T Q
            mma_ss<DH, 1, 1>(acc, desc_mn(ds_t + 512 * kq, 2048), desc_mn(q_t + 512 * kq, SLAB));
          if constexpr (DQ_WG == 1) mma_dq(k_t);
          wg_commit();
          wg_wait0();
        }
        fence_regs<R>(acc);
        fence_regs<R>(dqr);
        if (G == 2) slab.save(u, acc, qt == n_tiles - 1);  // zeros for the next group
        if (qt == n_tiles - 1) {  // the key tile's last query tile: its dK or dV out
          rows.store((wgi == 0 ? dv : dk) + base_q, kb, acc);
#pragma unroll
          for (int x = 0; x < R; ++x) acc[x] = 0.f;
        }
        named_barrier(1, NTH);  // every product of the pair is done with its tiles
        ++pi;
        if (tid == 0)
          prod.produce(smem, maps, full, kv_full, pi, gi + (qt == n_tiles - 1 && u == 0));
      }
      // the query tile has met the group: its dQ into the partial, once
      if (wgi == DQ_WG) {
        if (DH > BWD_KV_AHEAD) rows.load(old, dqa, q0, 1, first);
        rows.add(dqa, dqr, old, q0, 1);
#pragma unroll
        for (int x = 0; x < R; ++x) dqr[x] = 0.f;
      }
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
                   void* dq, void* dq_acc, int B, int H, int T_len, int max_seq, int causal,
                   float scale, int nsplit, cudaStream_t stream) {
  Maps maps;
  cudaError_t err = make_maps(&maps, q, k, v, dout, e, B * H, T_len, DH, max_seq);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_kv_wg_tc_kernel<DH>;
  const int smem = Layout<DH>::TOTAL;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H * nsplit, NTH, smem, stream>>>(
      maps, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(dq_acc), H, T_len, max_seq, causal,
      scale, scale * LOG2E, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_dq(dq_acc, dq, (size_t)B * H * T_len * DH, nsplit, stream);
}

}  // namespace wg

template <typename T, int DH, bool WITH_DQ>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
                   void* dq, void* dq_acc, int B, int H, int T_len, int max_seq, int causal,
                   float scale, int split, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && WITH_DQ) {
    return wg::launch<DH>(q, k, v, e, pad, dout, lse, dsum, dk, dv, dq, dq_acc, B, H, T_len,
                          max_seq, causal, scale, split, stream);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using B16 = __nv_bfloat16;
    auto kernel = tc::flash_bwd_kv_tc_kernel<DH>;
    const int smem = tc::Layout<DH>::TOTAL;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<B * H * split, tc::NTH, smem, stream>>>(
        static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
        static_cast<const B16*>(e), static_cast<const uint8_t*>(pad), static_cast<const B16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<B16*>(dk),
        static_cast<B16*>(dv), H, T_len, max_seq, causal, scale, scale * tc::LOG2E, split);
  } else {
    auto kernel = flash_rel_attn_bwd_kv_kernel<T, DH, WITH_DQ>;
    const size_t smem = smem_bytes<DH>();
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int blocks = WITH_DQ ? B * H : B * H * ((T_len + Tile<DH>::BK - 1) / Tile<DH>::BK);
    kernel<<<blocks, Tile<DH>::NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(e), static_cast<const uint8_t*>(pad), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<T*>(dk),
        static_cast<T*>(dv), static_cast<T*>(dq), static_cast<float*>(dq_acc), H, T_len, max_seq,
        causal, scale);
  }
  return cudaGetLastError();
}

template <bool WITH_DQ>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* e,
                     const void* pad, const void* dout, const void* lse, const void* dsum,
                     void* dk, void* dv, void* dq, void* dq_acc, int B, int H, int T_len, int dh,
                     int max_seq, int causal, int dtype, float scale, int split, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq) return cudaErrorInvalidValue;
  // bf16: kernel 9 takes any split >= 1, kernel 7 one or two blocks a (b, h)
  if (dtype == 1 && (split <= 0 || (WITH_DQ && split > km::MAX_SPLIT)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KV_CASE(TYPE, D)                                                                     \
  if (dh == D)                                                                               \
    return launch<TYPE, D, WITH_DQ>(q, k, v, e, pad, dout, lse, dsum, dk, dv, dq, dq_acc, B, \
                                    H, T_len, max_seq, causal, scale, split, s);
  if (dtype == 0) {
    KV_CASE(float, 16) KV_CASE(float, 32) KV_CASE(float, 48) KV_CASE(float, 64)
    KV_CASE(float, 96) KV_CASE(float, 128)
  } else if (dtype == 1) {
    KV_CASE(__nv_bfloat16, 16) KV_CASE(__nv_bfloat16, 32)
    KV_CASE(__nv_bfloat16, 48) KV_CASE(__nv_bfloat16, 64)
    KV_CASE(__nv_bfloat16, 96) KV_CASE(__nv_bfloat16, 128)
  }
#undef KV_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when the launch was accepted. dtype: 0 =
// float32, 1 = bfloat16 (q, k, v, e, dout and the outputs); lse and dsum are
// f32 [B, H, T]; pad may be null. scale is c = 1/sqrt(d_head) of the caller's
// heads, which may have fewer columns than dh (zero columns padded up to an
// instantiated dh add nothing). Launches on `stream` and does not synchronise.

// dK, dV (the TPU's _bwd_dkdv_kernel). bf16: `split` (> 0) blocks a
// (b, h), block s taking key tiles s, s + split, ...; f32 ignores it (one
// block per (b, h, key tile)).
int flash_rel_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* e,
                            const void* pad, const void* dout, const void* lse,
                            const void* dsum, void* dk, void* dv, int B, int H, int T_len,
                            int dh, int max_seq, int causal, int dtype, float scale, int split,
                            void* stream) {
  return dispatch<false>(q, k, v, e, pad, dout, lse, dsum, dk, dv, nullptr, nullptr, B, H,
                         T_len, dh, max_seq, causal, dtype, scale, split, stream);
}

// dK, dV and dQ_qk (the TPU's _bwd_dkdv_dq_kernel); dq_acc is f32 scratch
// [split, B, H, T, dh], filled by the kernel. bf16: `split` (1 or 2) blocks
// a (b, h) on alternate groups of key tiles, one partial each; f32 ignores
// it (one block per (b, h), the first partial).
int flash_rel_attn_bwd_dkdv_dq(const void* q, const void* k, const void* v, const void* e,
                               const void* pad, const void* dout, const void* lse,
                               const void* dsum, void* dk, void* dv, void* dq, void* dq_acc,
                               int B, int H, int T_len, int dh, int max_seq, int causal,
                               int dtype, float scale, int split, void* stream) {
  return dispatch<true>(q, k, v, e, pad, dout, lse, dsum, dk, dv, dq, dq_acc, B, H, T_len, dh,
                        max_seq, causal, dtype, scale, split, stream);
}

const char* flash_rel_attn_bwd_kv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
