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
// Design (simple and correct first; see PERF.md for its time):
//   * one block of 256 threads per (b, h) sweeps its 64-key tiles and, inside,
//     the 64-row query tiles that see them, as the TPU's sequential grid did.
//     So every accumulation has one owner: dK and dV of the key tile live in
//     registers; dQ accumulates in an f32 scratch [B, H, T, dh] that only
//     this block touches; dE accumulates in an f32 partial [B*H, T, dh]
//     indexed by distance, again only this block's. A second kernel reduces
//     the partials over B*H into dE. No atomics, no sum through bf16, and the
//     result is deterministic. At B 8, H 16 that is 128 blocks: one wave on
//     the H100's 132 SMs;
//   * per tile pair the block stages K, V, Q, dO and the band of BQ + BK - 1
//     E rows (zero for negative distances, as in the forward) in shared
//     memory as f32, then runs four phases with its threads remapped:
//     A, thread = (query row, 16 keys): recompute P, dP and dS' into shared
//     [BQ][BK] tiles; B, thread = (key row, dh/4 columns): dV and dK; C,
//     thread = (query row, dh/4 columns): dQ; D, thread = (distance, dh/4
//     columns): the band's dE diagonals;
//   * causal: query tiles above a key tile are never visited.
//
// What bounds it on the H100: CUDA-core f32 FMAs fed from shared memory (no
// tensor cores), and the 8 warps a block gives each SM. wgmma tiles and a
// split of the key sweep over more blocks are the later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int BAND = BQ + BK - 1;  // distinct distances i - j in one tile pair
constexpr int NT = 256;            // threads per block: 4 per row in phases B-D
constexpr int PS = BK + 1;         // row stride of the P and dS' tiles
static_assert(NT == 4 * BQ && NT == 4 * BK, "phases map 4 threads to a row");

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
  return (size_t)((2 * BK + 2 * BQ + BAND) * row_stride<DH>() + 2 * BQ * PS + 2 * BQ + BK) *
         sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_rel_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ e,
                          const uint8_t* __restrict__ pad, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ dq_acc, float* __restrict__ de_part, int H,
                          int T_len, int max_seq, int causal, float scale) {
  static_assert(DH % 16 == 0, "each of 4 threads takes a float4-aligned quarter row");
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
        dk[g + x] = from_f32<T>(dk_acc[x]);
        dv[g + x] = from_f32<T>(dv_acc[x]);
      }
    }
  }

  __syncthreads();  // every dQ accumulation of this (b, h) has landed
  for (int x = tid; x < T_len * DH; x += NT) dq[base + x] = from_f32<T>(dqa[x]);
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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   const void* dout, const void* lse, const void* dsum, void* dq, void* dk,
                   void* dv, void* de, void* dq_acc, void* de_part, int B, int H, int T_len,
                   int max_seq, int causal, cudaStream_t stream) {
  auto kernel = flash_rel_attn_bwd_kernel<T, DH>;
  const size_t smem = smem_bytes<DH>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(e), static_cast<const uint8_t*>(pad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dq_acc),
      static_cast<float*>(de_part), H, T_len, max_seq, causal, 1.f / sqrtf((float)DH));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = max_seq * DH, threads = 256;
  de_reduce_kernel<T><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(de_part), static_cast<T*>(de), B * H, T_len, max_seq, DH);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* e,
                        const void* pad, const void* dout, const void* lse, const void* dsum,
                        void* dq, void* dk, void* dv, void* de, void* dq_acc, void* de_part,
                        int B, int H, int T_len, int dh, int max_seq, int causal,
                        cudaStream_t s) {
#define FLASH_BWD_CASE(D)                                                                    \
  case D:                                                                                    \
    return launch<T, D>(q, k, v, e, pad, dout, lse, dsum, dq, dk, dv, de, dq_acc, de_part, B, \
                        H, T_len, max_seq, causal, s);
  switch (dh) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(48)
    FLASH_BWD_CASE(64)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when both launches were accepted. dtype: 0 =
// float32, 1 = bfloat16 (q, k, v, e, dout, dq, dk, dv, de); lse and dsum are
// f32 [B, H, T]; pad may be null. dq_acc is f32 scratch [B, H, T, dh] and
// de_part f32 scratch [B*H, T, dh]; the kernel zeroes both. Launches on
// `stream` and does not synchronise.
int flash_rel_attn_bwd(const void* q, const void* k, const void* v, const void* e,
                       const void* pad, const void* dout, const void* lse, const void* dsum,
                       void* dq, void* dk, void* dv, void* de, void* dq_acc, void* de_part,
                       int B, int H, int T_len, int dh, int max_seq, int causal, int dtype,
                       void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, e, pad, dout, lse, dsum, dq, dk, dv, de, dq_acc, de_part,
                              B, H, T_len, dh, max_seq, causal, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, e, pad, dout, lse, dsum, dq, dk, dv, de, dq_acc,
                                      de_part, B, H, T_len, dh, max_seq, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_rel_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
