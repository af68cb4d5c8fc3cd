// One-token attention over the stacked int8/bf16 KV cache of one layer, past
// the head widths decode_attn_stacked.cu is built for (d_head above 256),
// for Hopper (sm_90a).
//
// Replaces midi_emotion_tpu/ops/decode_attention.py::_kernel (the Pallas TPU
// kernel launched by _run, which takes d_head as one block), as
// decode_attn_stacked.cu does at the narrower widths: the same arguments,
// layouts and results (see decode_attn_stacked.cuh's note and
// ops/decode_attention.py's twin, decode_attn_cached_plain).
//
// Up to 1024 channels a head (d_head 384, 512, 640, 768, 896 and 1024, the
// widths the wrappers lay a wide head out at) this file instantiates the
// stacked kernel of decode_attn_stacked.cuh: a cluster of CTAs per batch
// row splitting the live window blocks, prefix maxima exchanged in
// distributed shared memory, a producer warp filling a TMA ring, the
// products on mma.sync (int8 m16n8k32 with exact integer sums, bf16
// m16n8k16), rank 0 summing (acc, l) in rank order and running the staged
// tail in the same launch. Its wide instantiations differ in two places
// only (WIDE_DH): a tile's E rows come as a job of their own, copied in
// 128-byte pieces of the row (a box is at most 256 columns, and the K
// rows and E rows of one 32-key tile at d_head 1024 bf16 would take 128 KB
// a ring stage), their bias landing in the logits before the K tile adds
// its scores; and the score units run two chains over the one or two
// heads a group holds.
//
// Past 1024 channels a head (namespace per_head) the first wide design
// runs: one block of 256 threads per (head, batch row), walking the window
// blocks of `bw` keys in order with the twin's running max, so P
// re-quantizes as the twin's does. q (f32, its bf16 rounding and, in int8
// mode, its int8 quantisation) and the f32 accumulator live in shared
// memory at d_head floats each, whatever d_head is. Per window block: a
// warp per key computes the score (int8: the exact integer dot of q8 and
// the raw int8 K, scaled by sq * ks; bf16: f32 sums of bf16 products) and
// the bias q_bf16 . e_rows[w], lanes striding over the channels; the block
// takes the max, P, its sum and (int8) the re-quantised P; then a thread
// per channel sums P against V over the block's keys (int8: in integers).
// The staged tail and the self term follow as in the twin, and the current
// row lands in stage slot (p_cnt, layer) when p_cnt < S.
//
// Bound on the H100: bytes (each live cache row is read once). At B 64,
// length 1216, 2 heads of 384, one layer's live int8 rows and scales are
// 120.2 MB, 35.9 us at 3.35 TB/s (bf16 239.1 MB, 71.4 us); the E rows
// (1216 x 768 bytes) stay in L2 across the batch rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_attn_stacked.cuh"

namespace {

namespace per_head {


constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* kv;
  const __nv_bfloat16* sc;
  const __nv_bfloat16* e_rows;
  __nv_bfloat16* pend;
  const __nv_bfloat16* e_pend;
  const __nv_bfloat16* row;
  float* acc;
  float* m;
  float* l;
  __nv_bfloat16* out;
  int L, B, W, H, dh, layer, length, S, p_cnt, bw, q_bf16;
  float scale;
};

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the block's max (MAX) or sum of x, for every thread; red: NW floats
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = MAX ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NW; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// sum_d qh[d] * x[d] over the block, for every thread
__device__ __forceinline__ float block_dot(const float* qh, const __nv_bfloat16* x, int dh,
                                           float* red) {
  float a = 0.f;
  for (int d = threadIdx.x; d < dh; d += NT) a = fmaf(qh[d], to_f(x[d]), a);
  return block_reduce<false>(a, red);
}

// the dot of a warp's lanes, striding over the channels, for every lane
__device__ __forceinline__ float warp_dot(const float* qh, const __nv_bfloat16* x, int dh) {
  float a = 0.f;
  for (int d = threadIdx.x & 31; d < dh; d += 32) a = fmaf(qh[d], to_f(x[d]), a);
  return warp_sum(a);
}

template <bool QUANT>
__global__ void __launch_bounds__(NT) decode_wide_kernel(Params p) {
  using KV = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh = p.dh, H = p.H, D = H * dh;
  const int nlg = max(p.bw, p.S);
  extern __shared__ float4 smem4[];
  float* qf = reinterpret_cast<float*>(smem4);  // [dh] q as given, in f32
  float* qh = qf + dh;                           // [dh] q rounded to bf16
  float* q8 = qh + dh;                           // [dh] q quantised (integer values)
  float* acc = q8 + dh;                          // [dh] the f32 accumulator
  float* lg = acc + dh;                          // [nlg] a block's logits, then P
  float* red = lg + nlg;                         // [NW]

  for (int d = tid; d < dh; d += NT) {
    const size_t g = ((size_t)b * H + h) * dh + d;
    const float x = p.q_bf16 ? to_f(static_cast<const __nv_bfloat16*>(p.q)[g])
                             : static_cast<const float*>(p.q)[g];
    qf[d] = x;
    qh[d] = bf(x);
    acc[d] = 0.f;
  }
  float sq = 0.f;
  if (QUANT) {
    float a = 0.f;
    for (int d = tid; d < dh; d += NT) a = fmaxf(a, fabsf(qf[d]));
    sq = block_reduce<true>(a, red) / 127.f + 1e-20f;
    for (int d = tid; d < dh; d += NT) q8[d] = rintf(qf[d] / sq);
  }
  __syncthreads();

  const KV* kv = static_cast<const KV*>(p.kv) + ((size_t)p.layer * p.B + b) * p.W * 2 * D;
  const __nv_bfloat16* ks =
      QUANT ? p.sc + (((size_t)p.layer * p.B + b) * 2 * H + h) * p.W : nullptr;
  const __nv_bfloat16* vs = QUANT ? ks + (size_t)H * p.W : nullptr;
  float m = NEG, l = 0.f;
  for (int j0 = 0; j0 < p.length; j0 += p.bw) {
    for (int w = warp; w < p.bw; w += NW) {
      const int key = j0 + w;
      float logit = NEG;
      if (key < p.length) {
        const KV* krow = kv + (size_t)key * 2 * D + (size_t)h * dh;
        float score;
        if constexpr (QUANT) {
          int a = 0;
          for (int d = lane; d < dh; d += 32) a += (int)q8[d] * (int)krow[d];
          score = (float)warp_sum(a) * sq * to_f(ks[key]);
        } else {
          float a = 0.f;
          for (int d = lane; d < dh; d += 32) a = fmaf(qh[d], to_f(krow[d]), a);
          score = warp_sum(a);
        }
        const float bias = warp_dot(qh, p.e_rows + (size_t)key * dh, dh);
        logit = (score + bias) * p.scale;
      }
      if (lane == 0) lg[w] = logit;
    }
    __syncthreads();
    float x = NEG;
    for (int w = tid; w < p.bw; w += NT) x = fmaxf(x, lg[w]);
    const float m_new = fmaxf(m, block_reduce<true>(x, red));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    for (int w = tid; w < p.bw; w += NT) {
      const float pw = j0 + w < p.length ? expf(lg[w] - m_new) : 0.f;
      lg[w] = pw;
      psum += pw;
    }
    l = l * alpha + block_reduce<false>(psum, red);  // its barriers publish lg
    m = m_new;
    float s_p = 0.f;
    if (QUANT) {
      float pmax = 0.f;
      for (int w = tid; w < p.bw; w += NT) {
        const float pv = j0 + w < p.length ? lg[w] * to_f(vs[j0 + w]) : 0.f;
        lg[w] = pv;
        pmax = fmaxf(pmax, pv);
      }
      s_p = block_reduce<true>(pmax, red) / 127.f + 1e-20f;
      for (int w = tid; w < p.bw; w += NT) lg[w] = rintf(lg[w] / s_p);
    } else {
      for (int w = tid; w < p.bw; w += NT) lg[w] = bf(lg[w]);
    }
    __syncthreads();
    const int n = min(p.bw, p.length - j0);
    const KV* vrow = kv + (size_t)j0 * 2 * D + D + (size_t)h * dh;
    for (int d = tid; d < dh; d += NT) {
      float r;
      if constexpr (QUANT) {
        int a = 0;
        for (int w = 0; w < n; ++w) a += (int)lg[w] * (int)vrow[(size_t)w * 2 * D + d];
        r = (float)a * s_p;
      } else {
        r = 0.f;
        for (int w = 0; w < n; ++w) r = fmaf(lg[w], to_f(vrow[(size_t)w * 2 * D + d]), r);
      }
      acc[d] = acc[d] * alpha + r;
    }
    __syncthreads();  // lg is read before the next block writes it
  }

  if (p.pend == nullptr) {
    for (int d = tid; d < dh; d += NT) p.acc[(size_t)b * D + (size_t)h * dh + d] = acc[d];
    if (tid == 0) {
      p.m[(size_t)b * H + h] = m;
      p.l[(size_t)b * H + h] = l;
    }
    return;
  }

  // the staged tail: the <= S bf16 stage rows of this layer, q in bf16
  const size_t slot = (size_t)p.L * p.B * 2 * D;  // one stage slot's rows
  const __nv_bfloat16* pend_b = p.pend + ((size_t)p.layer * p.B + b) * 2 * D;
  for (int s = warp; s < p.S; s += NW) {
    float logit = NEG;
    if (s < p.p_cnt) {
      const float kd = warp_dot(qh, pend_b + s * slot + (size_t)h * dh, dh);
      const float ed = warp_dot(qh, p.e_pend + (size_t)s * dh, dh);
      logit = (kd + ed) * p.scale;
    }
    if (lane == 0) lg[s] = logit;
  }
  __syncthreads();
  float x = NEG;
  for (int s = tid; s < p.S; s += NT) x = fmaxf(x, lg[s]);
  const float m_new = fmaxf(m, block_reduce<true>(x, red));
  const float alpha = expf(m - m_new);
  float psum = 0.f;
  for (int s = tid; s < p.S; s += NT) {
    const float pw = s < p.p_cnt ? expf(lg[s] - m_new) : 0.f;
    lg[s] = bf(pw);
    psum += pw;
  }
  l = l * alpha + block_reduce<false>(psum, red);
  m = m_new;
  for (int d = tid; d < dh; d += NT) {
    float r = 0.f;
    for (int s = 0; s < p.p_cnt && s < p.S; ++s)
      r = fmaf(lg[s], to_f(pend_b[s * slot + D + (size_t)h * dh + d]), r);
    acc[d] = acc[d] * alpha + r;
  }

  // the self term: the current row, bias row e_pend[p_cnt]
  const __nv_bfloat16* krow = p.row + (size_t)b * 2 * D + (size_t)h * dh;
  const __nv_bfloat16* vrow = krow + D;
  const float kd = block_dot(qh, krow, dh, red);
  const float ed = block_dot(qh, p.e_pend + (size_t)p.p_cnt * dh, dh, red);
  const float logit_s = (kd + ed) * p.scale;
  const float m_fin = fmaxf(m, logit_s);
  const float a_old = expf(m - m_fin), a_new = expf(logit_s - m_fin);
  const float denom = l * a_old + a_new;
  for (int d = tid; d < dh; d += NT)
    p.out[(size_t)b * D + (size_t)h * dh + d] =
        __float2bfloat16((acc[d] * a_old + to_f(vrow[d]) * a_new) / denom);
  if (p.p_cnt < p.S) {  // slot p_cnt is read by no block: the tail reads s < p_cnt
    __nv_bfloat16* dst = p.pend + (size_t)p.p_cnt * slot + ((size_t)p.layer * p.B + b) * 2 * D +
                         (size_t)h * dh;
    for (int d = tid; d < dh; d += NT) {
      dst[d] = krow[d];
      dst[D + d] = vrow[d];
    }
  }
}


// the checked call, past MAX_D channels a head
cudaError_t run(const void* q, const void* kv, const void* sc, const void* e_rows, void* pend,
                const void* e_pend, const void* row, void* acc, void* m, void* l, void* out,
                int L, int B, int W, int H, int dh, int layer, int length, int S, int p_cnt,
                int bw, int quant, int q_bf16, float scale, cudaStream_t s) {
  if (L <= 0 || B <= 0 || W <= 0 || H <= 0 || dh <= 0 || layer < 0 || layer >= L ||
      length < 0 || length > W || bw <= 0 || W % bw != 0 || q == nullptr || kv == nullptr ||
      e_rows == nullptr)
    return cudaErrorInvalidValue;
  if (quant && sc == nullptr) return cudaErrorInvalidValue;
  if (pend != nullptr) {
    if (S < 1 || p_cnt < 0 || p_cnt > S || e_pend == nullptr || row == nullptr ||
        out == nullptr)
      return cudaErrorInvalidValue;
  } else if (acc == nullptr || m == nullptr || l == nullptr) {
    return cudaErrorInvalidValue;
  } else {
    S = 0;
  }
  Params p = {q,
              kv,
              static_cast<const __nv_bfloat16*>(sc),
              static_cast<const __nv_bfloat16*>(e_rows),
              static_cast<__nv_bfloat16*>(pend),
              static_cast<const __nv_bfloat16*>(e_pend),
              static_cast<const __nv_bfloat16*>(row),
              static_cast<float*>(acc),
              static_cast<float*>(m),
              static_cast<float*>(l),
              static_cast<__nv_bfloat16*>(out),
              L, B, W, H, dh, layer, length, S, p_cnt, bw, q_bf16, scale};
  const int smem = (4 * dh + (bw > S ? bw : S) + NW) * (int)sizeof(float);
  const dim3 grid(H, B);
  cudaError_t err;
  if (quant) {
    if ((err = cudaFuncSetAttribute(decode_wide_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return err;
    decode_wide_kernel<true><<<grid, NT, smem, s>>>(p);
  } else {
    if ((err = cudaFuncSetAttribute(decode_wide_kernel<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return err;
    decode_wide_kernel<false><<<grid, NT, smem, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace per_head

// the stacked kernel's wide instantiations (S: the 128-byte slab, which
// divides any half row of multiples of 128 columns)
template <bool QUANT>
cudaError_t dispatch_wide(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 384: return launch<384, QUANT, 128>(p, stream);
    case 512: return launch<512, QUANT, 128>(p, stream);
    case 640: return launch<640, QUANT, 128>(p, stream);
    case 768: return launch<768, QUANT, 128>(p, stream);
    case 896: return launch<896, QUANT, 128>(p, stream);
    case 1024: return launch<1024, QUANT, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The arguments and results of decode_attn_stacked (decode_attn_stacked.cu)
// for d_head past 256: the stacked kernel's wide instantiations up to MAX_D
// (1024) channels a head, which take the stage sizes it takes (S <= 128),
// the per-head kernel past them (any S >= 1). Returns a cudaError_t: 0 when
// the launch was accepted. Launches on `stream` and does not synchronise.
int decode_attn_wide(const void* q, const void* kv, const void* sc, const void* e_rows,
                     void* pend, const void* e_pend, const void* row, void* acc, void* m,
                     void* l, void* out, int L, int B, int W, int H, int dh, int layer,
                     int length, int S, int p_cnt, int bw, int quant, int q_bf16, float scale,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > MAX_D)
    return per_head::run(q, kv, sc, e_rows, pend, e_pend, row, acc, m, l, out, L, B, W, H, dh,
                         layer, length, S, p_cnt, bw, quant, q_bf16, scale, s);
  Params p = {};
  const cudaError_t err = make_params(p, q, kv, sc, e_rows, pend, e_pend, row, acc, m, l, out, L,
                                      B, W, H, dh, layer, length, S, p_cnt, bw, quant, q_bf16,
                                      scale);
  if (err != cudaSuccess) return err;
  return quant ? dispatch_wide<true>(p, dh, s) : dispatch_wide<false>(p, dh, s);
}

const char* decode_attn_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
