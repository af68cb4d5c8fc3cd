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
// Design (simple and correct first; see PERF.md for its time):
//   * tiles of 64 rows (32 at d_head 128, so the f32 staging fits a block's
//     shared memory) and 4 threads a row;
//   * dK/dV alone: one block per (b, h, key tile). The tile owns
//     its dK and dV, kept in registers, and sweeps the query tiles that see
//     it (causal: those at or below the diagonal). At B 8, H 16, T 1216 that
//     is 2 432 blocks, so every SM holds work to the end;
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
//
// What bounds it on the H100: CUDA-core f32 FMAs fed from shared memory (no
// tensor cores). No source file is shared with the other kernels, so the
// build hash of this file covers everything it compiles.

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

template <typename T, int DH, bool WITH_DQ>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
                   void* dq, void* dq_acc, int B, int H, int T_len, int max_seq, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_rel_attn_bwd_kv_kernel<T, DH, WITH_DQ>;
  const size_t smem = smem_bytes<DH>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = WITH_DQ ? B * H : B * H * ((T_len + Tile<DH>::BK - 1) / Tile<DH>::BK);
  kernel<<<blocks, Tile<DH>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(e), static_cast<const uint8_t*>(pad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<T*>(dq), static_cast<float*>(dq_acc), H, T_len, max_seq,
      causal, 1.f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <bool WITH_DQ>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* e,
                     const void* pad, const void* dout, const void* lse, const void* dsum,
                     void* dk, void* dv, void* dq, void* dq_acc, int B, int H, int T_len, int dh,
                     int max_seq, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KV_CASE(TYPE, D)                                                                     \
  if (dh == D)                                                                               \
    return launch<TYPE, D, WITH_DQ>(q, k, v, e, pad, dout, lse, dsum, dk, dv, dq, dq_acc, B, \
                                    H, T_len, max_seq, causal, s);
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
// f32 [B, H, T]; pad may be null. Launches on `stream` and does not
// synchronise.

// dK, dV (the TPU's _bwd_dkdv_kernel).
int flash_rel_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* e,
                            const void* pad, const void* dout, const void* lse,
                            const void* dsum, void* dk, void* dv, int B, int H, int T_len,
                            int dh, int max_seq, int causal, int dtype, void* stream) {
  return dispatch<false>(q, k, v, e, pad, dout, lse, dsum, dk, dv, nullptr, nullptr, B, H,
                         T_len, dh, max_seq, causal, dtype, stream);
}

// dK, dV and dQ_qk (the TPU's _bwd_dkdv_dq_kernel); dq_acc is f32 scratch
// [B, H, T, dh], zeroed by the kernel.
int flash_rel_attn_bwd_dkdv_dq(const void* q, const void* k, const void* v, const void* e,
                               const void* pad, const void* dout, const void* lse,
                               const void* dsum, void* dk, void* dv, void* dq, void* dq_acc,
                               int B, int H, int T_len, int dh, int max_seq, int causal,
                               int dtype, void* stream) {
  return dispatch<true>(q, k, v, e, pad, dout, lse, dsum, dk, dv, dq, dq_acc, B, H, T_len, dh,
                        max_seq, causal, dtype, stream);
}

const char* flash_rel_attn_bwd_kv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
