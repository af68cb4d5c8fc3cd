// One-token attention over the stacked int8/bf16 KV cache of one layer, for
// Hopper (sm_90a).
//
// Replaces midi_emotion_tpu/ops/decode_attention.py::_kernel (the Pallas TPU
// kernel launched by _run). For the query of batch row b and head h at window
// position length + p_cnt it computes, over the `length` flushed cache rows,
//
//     logit[w] = (q . k[w] + q_bf16 . e_rows[w]) / sqrt(dh),   w < length
//
// with an online softmax across window blocks of `bw` keys, and returns the
// unnormalised flash triple (acc [B, D] f32, m and l [B, H] f32). Staged, it
// goes on to fold the <= S bf16 stage rows of this layer and the current
// token's own row (the self term, bias row e_pend[p_cnt]), writes the
// normalised output [B, D] bf16, and appends the current row at stage slot
// (p_cnt, layer) when p_cnt < S (the wrapper writes the clamped slot S - 1).
//
// Layouts (all contiguous): kv [L, B, W, 2D] (head h's key at columns
// h*dh.., its value at D + h*dh..), sc [L, B, 2H, W] bf16 (key scales of
// head h at row h, value scales at row H + h), e_rows [W, dh] bf16,
// pend [S, L, B, 2D] bf16, e_pend [S + 1, dh] bf16, row [B, 2D] bf16;
// q8 [B, H, dh] int8 with sq [B, H] f32 (int8 mode), qh [B, H, dh] bf16.
//
// int8 mode: the score dot is exact integer arithmetic (__dp4a over the int8
// q and K), then scaled by sq * ks. P times the value scales is re-quantised
// to int8 per (b, h, window block) with s_p = max/127 + 1e-20 and summed
// against the raw int8 V in integers. bf16 mode: bf16 products summed in f32,
// p rounded to bf16 before the PV sum. The plain twin
// (ops/decode_attention.py::decode_attn_cached_plain) uses the same blocks.
//
// Design (simple and correct first; see PERF.md for its time): one block of
// 128 threads per (b, h). For each window block below `length` a thread per
// key loads its head slice with 16-byte vector loads and computes its logit
// into shared memory; block-wide max and sum give the online softmax; the
// re-quantised P goes through shared memory to an integer (or f32) PV sum in
// which DH-thread groups split the keys. Blocks past `length` are never read.
//
// What bounds it on the H100: bytes. A step reads each layer's live cache
// once: at B 64, length 1216, D 768 that is 120 MB of int8 rows and ~5 MB of
// scales a layer, ~37 us at 3.35 TB/s (bf16: twice the rows). The design
// reads only the live rows, each once per (b, h) block that owns it; a
// thread's 48-byte head slice is a strided gather rather than a coalesced
// stream, which the L2 absorbs only in part. Coalescing across heads and
// tensor-core (s8 mma) products are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;         // threads per block
constexpr int MAX_STAGE = 128;  // one thread per stage row in the tail
constexpr float NEG = -1e30f;
static_assert(MAX_STAGE <= NT, "the tail folds one stage row per thread");

struct Params {
  const int8_t* q8;
  const float* sq;
  const __nv_bfloat16* qh;
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
  int L, B, W, H, layer, length, S, p_cnt, bw;
  float scale;
};

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

// f32 dot of DH bf16 values (16-byte aligned) with q held in shared memory.
template <int DH>
__device__ __forceinline__ float dot_bf16(const __nv_bfloat16* row, const float* qs) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const uint4 x = r4[i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a = fmaf(qs[8 * i + 2 * j], __uint_as_float(w[j] << 16), a);
      a = fmaf(qs[8 * i + 2 * j + 1], __uint_as_float(w[j] & 0xffff0000u), a);
    }
  }
  return a;
}

// Exact int32 dot of DH int8 values (16-byte aligned) with the packed q.
template <int DH>
__device__ __forceinline__ int dot_int8(const int8_t* row, const int* qw) {
  const int4* r4 = reinterpret_cast<const int4*>(row);
  int a = 0;
#pragma unroll
  for (int i = 0; i < DH / 16; ++i) {
    const int4 x = r4[i];
    a = __dp4a(x.x, qw[4 * i + 0], a);
    a = __dp4a(x.y, qw[4 * i + 1], a);
    a = __dp4a(x.z, qw[4 * i + 2], a);
    a = __dp4a(x.w, qw[4 * i + 3], a);
  }
  return a;
}

// Block-wide reductions; every thread gets the result. Deterministic: each
// thread combines the warps' results in one fixed order.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is free: every thread has read its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r += red[i];
  return r;
}

template <int DH, bool QUANT>
__global__ void __launch_bounds__(NT) decode_attn_stacked_kernel(const Params p) {
  constexpr int NG = NT / DH;  // key groups of the PV sum
  extern __shared__ float dyn[];
  float* s_buf = dyn;         // [bw] logits, then p * vs (int8 mode)
  float* p_buf = dyn + p.bw;  // [bw] P as the PV sum reads it
  __shared__ float qs[DH];
  __shared__ int qw[DH / 4];
  __shared__ float red[NT / 32];
  __shared__ float part[NG * DH];
  __shared__ float tail_p[MAX_STAGE];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int D = p.H * DH, D2 = 2 * D;
  if (tid < DH) qs[tid] = bf2f(p.qh[(size_t)bh * DH + tid]);
  if (QUANT && tid < DH / 4) qw[tid] = reinterpret_cast<const int*>(p.q8 + (size_t)bh * DH)[tid];
  const float sq = QUANT ? p.sq[bh] : 0.f;
  __syncthreads();

  const int8_t* kv8 = static_cast<const int8_t*>(p.kv);
  const __nv_bfloat16* kvb = static_cast<const __nv_bfloat16*>(p.kv);
  const size_t row0 = ((size_t)p.layer * p.B + b) * p.W;  // row (layer, b, 0)
  const __nv_bfloat16* ks = QUANT ? p.sc + (row0 * 2 * p.H + (size_t)h * p.W) : nullptr;
  const __nv_bfloat16* vs = QUANT ? ks + (size_t)p.H * p.W : nullptr;
  const int pv_d = tid % DH, pv_g = tid / DH;

  float m = NEG, l = 0.f, acc = 0.f;  // acc: channel tid, for tid < DH
  for (int j0 = 0; j0 < p.length; j0 += p.bw) {
    const int n = min(p.bw, p.length - j0);  // live keys of this window block
    float bmax = NEG;
    for (int t = tid; t < n; t += NT) {
      const int w = j0 + t;
      float score;
      if (QUANT) {
        score = (float)dot_int8<DH>(kv8 + (row0 + w) * D2 + h * DH, qw) * sq * bf2f(ks[w]);
      } else {
        score = dot_bf16<DH>(kvb + (row0 + w) * D2 + h * DH, qs);
      }
      const float lg = (score + dot_bf16<DH>(p.e_rows + (size_t)w * DH, qs)) * p.scale;
      s_buf[t] = lg;
      bmax = fmaxf(bmax, lg);
    }
    const float m_new = fmaxf(m, block_max(bmax, red));
    const float alpha = expf(m - m_new);
    float psum = 0.f, pvmax = 0.f;
    for (int t = tid; t < n; t += NT) {
      const float pr = expf(s_buf[t] - m_new);
      psum += pr;
      if (QUANT) {
        const float pv = pr * bf2f(vs[j0 + t]);
        s_buf[t] = pv;
        pvmax = fmaxf(pvmax, pv);
      } else {
        p_buf[t] = bf_round(pr);
      }
    }
    l = l * alpha + block_sum(psum, red);
    m = m_new;
    float s_p = 1.f;
    if (QUANT) {
      s_p = block_max(pvmax, red) / 127.f + 1e-20f;
      for (int t = tid; t < n; t += NT) p_buf[t] = rintf(s_buf[t] / s_p);
    }
    __syncthreads();  // p_buf is complete
    if (pv_g < NG) {
      if (QUANT) {
        // integers: |p8 * v8| <= 127 * 127, summed over <= bw keys
        int sum = 0;
        const int8_t* vcol = kv8 + (row0 + j0) * D2 + D + h * DH + pv_d;
        for (int k = pv_g; k < n; k += NG) sum += (int)p_buf[k] * (int)vcol[(size_t)k * D2];
        part[tid] = (float)sum;
      } else {
        float sum = 0.f;
        const __nv_bfloat16* vcol = kvb + (row0 + j0) * D2 + D + h * DH + pv_d;
        for (int k = pv_g; k < n; k += NG) sum = fmaf(p_buf[k], bf2f(vcol[(size_t)k * D2]), sum);
        part[tid] = sum;
      }
    }
    __syncthreads();
    if (tid < DH) {
      float res = 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g) res += part[g * DH + tid];
      acc = acc * alpha + (QUANT ? res * s_p : res);
    }
  }

  if (p.pend == nullptr) {
    if (tid < DH) p.acc[(size_t)b * D + h * DH + tid] = acc;
    if (tid == 0) {
      p.m[bh] = m;
      p.l[bh] = l;
    }
    return;
  }

  // ---- the staged tail: rows 0..p_cnt-1 of this layer's stage, bf16 ----
  const int np = p.p_cnt;
  const size_t slot_stride = (size_t)p.L * p.B * D2;  // one stage slot
  const __nv_bfloat16* pend_b = p.pend + ((size_t)p.layer * p.B + b) * D2;  // slot 0
  float lg = NEG;
  if (tid < np) {
    const __nv_bfloat16* prow = pend_b + (size_t)tid * slot_stride;
    lg = (dot_bf16<DH>(prow + h * DH, qs) + dot_bf16<DH>(p.e_pend + (size_t)tid * DH, qs)) *
         p.scale;
  }
  const float m_new = fmaxf(m, block_max(lg, red));
  const float alpha = expf(m - m_new);
  const float pr = tid < np ? expf(lg - m_new) : 0.f;
  tail_p[tid] = bf_round(pr);
  l = l * alpha + block_sum(pr, red);  // its barriers publish tail_p
  m = m_new;
  if (tid < DH) {
    float res = 0.f;
    for (int s = 0; s < np; ++s)
      res = fmaf(tail_p[s], bf2f(pend_b[(size_t)s * slot_stride + D + h * DH + tid]), res);
    acc = acc * alpha + res;
  }

  // ---- the self term and the normalisation ----
  const __nv_bfloat16* row = p.row + (size_t)b * D2;
  float qk = 0.f, qe = 0.f;
  if (tid < DH) {
    qk = qs[tid] * bf2f(row[h * DH + tid]);
    qe = qs[tid] * bf2f(p.e_pend[(size_t)np * DH + tid]);
  }
  const float sum_qk = block_sum(qk, red);
  const float logit_s = (sum_qk + block_sum(qe, red)) * p.scale;
  const float m_fin = fmaxf(m, logit_s);
  const float a_old = expf(m - m_fin), a_new = expf(logit_s - m_fin);
  const float denom = l * a_old + a_new;
  if (tid < DH) {
    const float v = bf2f(row[D + h * DH + tid]);
    p.out[(size_t)b * D + h * DH + tid] = __float2bfloat16((acc * a_old + v * a_new) / denom);
  }

  // ---- append the current row at stage slot p_cnt: one writer per b. The
  // slot is never read above (rows >= p_cnt are not live). ----
  if (h == 0 && np < p.S) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
    uint4* dst = reinterpret_cast<uint4*>(p.pend + (size_t)np * slot_stride +
                                          ((size_t)p.layer * p.B + b) * D2);
    for (int i = tid; i < D2 * 2 / 16; i += NT) dst[i] = src[i];
  }
}

template <int DH, bool QUANT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = decode_attn_stacked_kernel<DH, QUANT>;
  const size_t smem = 2 * (size_t)p.bw * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.B * p.H, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t dispatch_dh(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<16, QUANT>(p, stream);
    case 32: return launch<32, QUANT>(p, stream);
    case 48: return launch<48, QUANT>(p, stream);
    case 64: return launch<64, QUANT>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. quant: 1 = int8
// cache (q8, sq and sc required), 0 = bf16 cache. Staged when pend is not
// null (then e_pend, row and out are required), else acc, m and l are.
// Launches on `stream` and does not synchronise.
int decode_attn_stacked(const void* q8, const void* sq, const void* qh, const void* kv,
                        const void* sc, const void* e_rows, void* pend, const void* e_pend,
                        const void* row, void* acc, void* m, void* l, void* out, int L, int B,
                        int W, int H, int dh, int layer, int length, int S, int p_cnt, int bw,
                        int quant, void* stream) {
  if (L <= 0 || B <= 0 || W <= 0 || H <= 0 || layer < 0 || layer >= L || length < 0 ||
      length > W || bw <= 0 || W % bw != 0 || qh == nullptr || kv == nullptr ||
      e_rows == nullptr)
    return cudaErrorInvalidValue;
  if (quant && (q8 == nullptr || sq == nullptr || sc == nullptr)) return cudaErrorInvalidValue;
  if (pend != nullptr) {
    if (S < 1 || S > MAX_STAGE || p_cnt < 0 || p_cnt > S || e_pend == nullptr ||
        row == nullptr || out == nullptr)
      return cudaErrorInvalidValue;
  } else if (acc == nullptr || m == nullptr || l == nullptr) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q8 = static_cast<const int8_t*>(q8);
  p.sq = static_cast<const float*>(sq);
  p.qh = static_cast<const __nv_bfloat16*>(qh);
  p.kv = kv;
  p.sc = static_cast<const __nv_bfloat16*>(sc);
  p.e_rows = static_cast<const __nv_bfloat16*>(e_rows);
  p.pend = static_cast<__nv_bfloat16*>(pend);
  p.e_pend = static_cast<const __nv_bfloat16*>(e_pend);
  p.row = static_cast<const __nv_bfloat16*>(row);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.L = L;
  p.B = B;
  p.W = W;
  p.H = H;
  p.layer = layer;
  p.length = length;
  p.S = S;
  p.p_cnt = p_cnt;
  p.bw = bw;
  p.scale = (float)(1.0 / sqrt((double)dh));  // the twin's f32 constant
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quant ? dispatch_dh<true>(p, dh, s) : dispatch_dh<false>(p, dh, s);
}

const char* decode_attn_stacked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
