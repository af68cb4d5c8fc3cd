// Flash relative attention, forward only, for Hopper (sm_90a).
//
// Replaces midi_emotion_tpu/ops/pallas_attention.py::_flash_kernel (the
// Pallas TPU forward launched by _flash_fwd_impl). It computes
//
//     O[i]   = sum_j softmax_j(s[i, j]) V[j]
//     s[i,j] = (q_i . k_j + Srel[i, j]) / sqrt(dh),   masked -> -inf
//     Srel[i, j] = q_i . E[max_seq - 1 - (i - j)]  for j <= i, 0 for j > i
//
// with an online softmax over key tiles, never materialising [T, T]. It also
// writes the per-row log-sum-exp (lse = m + log l). A row whose keys are all
// masked gives O = 0 and lse = +1e30, the contract the TPU kernel documents
// (its finite -1e30 mask value keeps it from reaching that branch).
//
// Inputs are contiguous [B, H, T, dh] (q, k, v), E [max_seq, dh] in the same
// type as q, and an optional [B, T] key-pad mask (nonzero = pad). T <= max_seq.
//
// Design (simple and correct first; see PERF.md for its time):
//   * one block of BQ = 64 threads per (b, h, 64-row query tile); each thread
//     owns one query row: q (pre-scaled by 1/sqrt(dh)), the f32 accumulator
//     and the softmax state m, l live in registers;
//   * for each key tile of BK = 64 keys the block stages K, V and the band of
//     BQ + BK - 1 E rows that the tile pair's distances can reach in shared
//     memory as f32. Band rows with a negative distance (j > i) are zero, so
//     Srel is 0 above the diagonal without a select, which the non-causal
//     (regression) path needs;
//   * since q.k + q.E = q.(k + E), each score costs dh FMAs;
//   * causal: key tiles wholly above the diagonal are never loaded, and each
//     row stops at its own diagonal inside the last tile;
//   * query tiles are issued heaviest first (the last tiles see the most
//     keys) so the causal tail does not leave SMs idle at the end.
//
// What bounds it on the H100: it runs on the CUDA cores, not the tensor
// cores, and each FMA reads one shared-memory operand (K and V reads are
// warp-wide broadcasts, E reads are per-thread rows padded by 4 floats so a
// 16-byte load per thread is free of bank conflicts). Shared-memory traffic
// and the 64-thread blocks' low occupancy bound it. wgmma/TMA tiles are the
// later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per block = threads per block
constexpr int BK = 64;             // keys per shared-memory tile
constexpr int BAND = BQ + BK - 1;  // distinct distances i - j in one tile pair
constexpr int CHUNK = 16;          // scores held in registers at once
static_assert(BK % CHUNK == 0, "a chunk never crosses a tile");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
__host__ __device__ constexpr int e_stride() { return DH + 4; }  // 16-byte aligned, conflict-free rows

template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(2 * BK * DH + BAND * e_stride<DH>()) * sizeof(float) + BK;
}

template <typename T, int DH>
__global__ void __launch_bounds__(BQ)
flash_rel_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ e,
                          const uint8_t* __restrict__ pad, T* __restrict__ o,
                          float* __restrict__ lse, int H, int T_len, int max_seq,
                          int causal, float scale) {
  static_assert(DH % 4 == 0, "rows are read as float4");
  constexpr int ES = e_stride<DH>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][DH]
  float* vs = ks + BK * DH;                      // [BK][DH]
  float* es = vs + BK * DH;                      // [BAND][ES]
  uint8_t* live = reinterpret_cast<uint8_t*>(es + BAND * ES);  // [BK]

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tile first
  const int bh = blockIdx.y;                          // b * H + h
  const int b = bh / H;
  const int i = q0 + tid;
  const bool row_ok = i < T_len;
  const size_t base = (size_t)bh * T_len * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = row_ok ? to_f32(q[base + (size_t)i * DH + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int k_end = causal ? min(T_len, q0 + BQ) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    const int nk = min(BK, T_len - k0);
    for (int x = tid; x < BK * DH; x += BQ) {
      float kx = 0.f, vx = 0.f;
      if (x < nk * DH) {
        const size_t g = base + (size_t)k0 * DH + x;
        kx = to_f32(k[g]);
        vx = to_f32(v[g]);
      }
      ks[x] = kx;
      vs[x] = vx;
    }
    // band row u holds distance dist0 + u, i.e. E row max_seq - 1 - dist
    const int dist0 = q0 - k0 - (BK - 1);
    for (int x = tid; x < BAND * DH; x += BQ) {
      const int u = x / DH, d = x - u * DH;
      const int dist = dist0 + u;
      float ev = 0.f;
      if (dist >= 0 && dist < max_seq) ev = to_f32(e[(size_t)(max_seq - 1 - dist) * DH + d]);
      es[u * ES + d] = ev;
    }
    for (int x = tid; x < BK; x += BQ)
      live[x] = x < nk && !(pad != nullptr && pad[(size_t)b * T_len + k0 + x]);
    __syncthreads();
    if (!row_ok) continue;

    const int jn = causal ? min(nk, i - k0 + 1) : nk;  // keys this row sees
    const float* erow0 = es + (tid + BK - 1) * ES;       // band row for j = 0
    for (int c0 = 0; c0 < jn; c0 += CHUNK) {
      float s[CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const int j = c0 + c;
        float sc = -INFINITY;
        if (j < jn && live[j]) {
          const float4* kr = reinterpret_cast<const float4*>(ks + j * DH);
          const float4* er = reinterpret_cast<const float4*>(erow0 - j * ES);
          float a = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < DH / 4; ++d4) {
            const float4 kk = kr[d4], ee = er[d4];
            a = fmaf(qr[4 * d4 + 0], kk.x + ee.x, a);
            a = fmaf(qr[4 * d4 + 1], kk.y + ee.y, a);
            a = fmaf(qr[4 * d4 + 2], kk.z + ee.z, a);
            a = fmaf(qr[4 * d4 + 3], kk.w + ee.w, a);
          }
          sc = a;
        }
        s[c] = sc;
        cmax = fmaxf(cmax, sc);
      }
      if (cmax == -INFINITY) continue;  // every key of the chunk is masked
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 while m is still -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const float p = expf(s[c] - m_new);  // masked: exp(-inf) = 0
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + (c0 + c) * DH);
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!row_ok) return;
  T* orow = o + base + (size_t)i * DH;
  if (l > 0.f) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = from_f32<T>(acc[d] * inv);
    lse[(size_t)bh * T_len + i] = m + logf(l);
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = from_f32<T>(0.f);
    lse[(size_t)bh * T_len + i] = 1e30f;
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e,
                   const void* pad, void* o, void* lse, int B, int H, int T_len,
                   int max_seq, int causal, cudaStream_t stream) {
  auto kernel = flash_rel_attn_fwd_kernel<T, DH>;
  const size_t smem = smem_bytes<DH>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, B * H);
  kernel<<<grid, BQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(e), static_cast<const uint8_t*>(pad), static_cast<T*>(o),
      static_cast<float*>(lse), H, T_len, max_seq, causal, 1.f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* e,
                        const void* pad, void* o, void* lse, int B, int H, int T_len,
                        int dh, int max_seq, int causal, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, stream);
    case 32: return launch<T, 32>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, stream);
    case 48: return launch<T, 48>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, stream);
    case 64: return launch<T, 64>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. dtype: 0 = float32,
// 1 = bfloat16. pad may be null. Launches on `stream` and does not synchronise.
int flash_rel_attn_fwd(const void* q, const void* k, const void* v, const void* e,
                       const void* pad, void* o, void* lse, int B, int H, int T_len,
                       int dh, int max_seq, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, e, pad, o, lse, B, H, T_len, dh, max_seq, causal, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, e, pad, o, lse, B, H, T_len, dh, max_seq,
                                      causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_rel_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
