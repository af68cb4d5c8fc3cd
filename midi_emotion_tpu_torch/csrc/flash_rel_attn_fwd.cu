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
// Two paths, one per dtype, both masking their own ragged edge (T <= max_seq
// is all a caller needs; nobody pads), skipping causal key tiles wholly above
// the diagonal and issuing the heaviest query tiles first (the last tiles see
// the most keys), so the causal tail does not leave SMs idle at the end.
//
// bf16 (the main path: every prefill and training forward). Bound on the
// H100: operations. At B 4, H 16, T 1216, dh 48 it needs about 13.6 GFLOP
// (QK^T, the relative term and PV over the visible pairs), 13.7 us at the
// tensor cores' 989 TFLOP/s, against 3 MB of inputs and outputs. The design
// puts every product on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 sums), as the TPU kernel puts them on the MXU:
//   * a block of 4 warps takes 64 query rows; each warp owns 16 rows end to
//     end, so the softmax state, the skew and P never leave the warp;
//   * per 64-key tile: S = Q K^T, and the band Q E_band^T over the 80 band
//     rows (distances) its 16 rows reach, as tensor-core products; the band
//     is skewed into Srel through a per-warp shared scratch (row r, key j
//     reads band column r - j + 63); band rows of negative distance are
//     zero, so Srel is 0 above the diagonal, which the non-causal
//     (regression) model needs;
//   * online softmax in f32 (exp2 with log2(e) folded into the scale), then
//     P rounded to bf16 straight from the score fragments into the A
//     operand of P V (the TPU kernel casts P to the input dtype the same
//     way), with an f32 accumulator;
//   * K, V and the E band land by cp.async in a two-stage ring, the next
//     key tile's copies under this tile's products; the band moves 64
//     distances a key tile, so E lives in a ring of 64-row chunks and a
//     tile copies one new chunk. The query tile lands in the band scratch
//     (it is read into registers once), so three blocks fit an SM at
//     d_head <= 48 (12 warps: one block's barriers pass under the others'
//     products), two at 64, one at 96 and 128. Rows are padded by 16 bytes
//     so ldmatrix reads are free of bank conflicts.
// mma.sync and not wgmma, chosen without a wgmma version written or timed:
// a warp's 16 rows are the unit of the skew, the softmax and the P-to-
// operand reuse, which mma.sync keeps inside one warp. Nothing rules wgmma
// out: it takes A (Q, P) from registers, and its shared-memory B operands
// take 32- and 64-byte swizzles or padded rows, so d_head 48 and 96 fit. A
// wgmma version, each B tile read once a 64-row warpgroup instead of by
// every warp's ldmatrix, is the next step.
//
// f32 (the checks' path, held to 1e-4): CUDA cores, because TF32 tensor-core
// products keep about three decimal digits and cannot meet that. One block
// of 64 threads per 64-row query tile, a thread a query row with q (pre-
// scaled) and its f32 accumulator in registers; K, V and the band of BQ +
// BK - 1 E rows staged in shared memory as f32 per 64-key tile; since q.k +
// q.E = q.(k + E), each score costs dh FMAs. Shared-memory traffic and the
// 64-thread blocks bound it; at d_head 128 its two 128-float rows pass the
// 255 registers a thread may hold and spill (correct, slower).

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

template <int DH>
__host__ __device__ constexpr int e_stride() { return DH + 4; }  // 16-byte aligned, conflict-free rows

template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(2 * BK * DH + BAND * e_stride<DH>()) * sizeof(float) + BK;
}

template <int DH>
__global__ void __launch_bounds__(BQ)
flash_rel_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ e,
                          const uint8_t* __restrict__ pad, float* __restrict__ o,
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
    qr[d] = row_ok ? q[base + (size_t)i * DH + d] * scale : 0.f;
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
        kx = k[g];
        vx = v[g];
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
      if (dist >= 0 && dist < max_seq) ev = e[(size_t)(max_seq - 1 - dist) * DH + d];
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
  float* orow = o + base + (size_t)i * DH;
  if (l > 0.f) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = acc[d] * inv;
    lse[(size_t)bh * T_len + i] = m + logf(l);
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = 0.f;
    lse[(size_t)bh * T_len + i] = 1e30f;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e,
                   const void* pad, void* o, void* lse, int B, int H, int T_len,
                   int max_seq, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_rel_attn_fwd_kernel<DH>;
  const size_t smem = smem_bytes<DH>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, B * H);
  kernel<<<grid, BQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(e), static_cast<const uint8_t*>(pad), static_cast<float*>(o),
      static_cast<float*>(lse), H, T_len, max_seq, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* e,
                        const void* pad, void* o, void* lse, int B, int H, int T_len,
                        int dh, int max_seq, int causal, float scale, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, stream);
    case 32:
      return launch<32>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, stream);
    case 48:
      return launch<48>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, stream);
    case 64:
      return launch<64>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, stream);
    case 96:
      return launch<96>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// the bf16 path: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;              // query rows per block: 4 warps of 16
constexpr int BK = 64;              // keys per tile
constexpr int NWARP = BQ / 16;
constexpr int NTH = 32 * NWARP;
constexpr int WB = 80;              // band rows a warp multiplies: its rows' 79 distances
constexpr int WBS = WB + 8;         // row stride of a warp's band scratch (floats)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
struct Layout {
  static constexpr int STAGES = 2;   // the next key tile lands while this one computes
  static constexpr int RS = DH + 8;  // bf16 row stride: an odd number of 16-byte units
  static constexpr int CPR = DH / 8;  // 16-byte chunks a row
  // a ring stage: K [BK][RS], V [BK][RS] bf16, live [BK] f32
  static constexpr int STAGE_BYTES = 2 * BK * RS * 2 + BK * 4;
  // the E band: chunks of 64 rows [64][RS] bf16, two a tile in work
  static constexpr int NSLOT = STAGES + 1;
  static constexpr int E_BYTES = NSLOT * 64 * RS * 2;
  // the band scratch; the query tile [BQ][RS] bf16 lands there first, and
  // is read into registers before any warp writes its scratch
  static constexpr int SCRATCH_BYTES = NWARP * 16 * WBS * 4;
  static_assert(BQ * RS * 2 <= SCRATCH_BYTES, "the query tile fits the scratch");
  static constexpr int TOTAL = STAGES * STAGE_BYTES + E_BYTES + SCRATCH_BYTES;
  // blocks an SM that the SM's 228 KB (1 KB of it per block reserved)
  // holds, at most 3 (12 warps, each block's copies and barriers under the
  // others' products): 3 at d_head <= 48, 2 at 64, 1 at 96 and 128
  static constexpr int MIN_BLOCKS = 233472 / (TOTAL + 1024) < 3 ? 233472 / (TOTAL + 1024) : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, zeros where !ok (no byte is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
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

// Fragment coordinates (g = lane / 4, t = lane % 4): an f32 accumulator tile
// c[n][e] holds row g + 8 (e / 2), column 8 n + 2 t + e % 2 of the warp's 16
// rows.
template <int DH>
__global__ void __launch_bounds__(NTH, Layout<DH>::MIN_BLOCKS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ e,
                    const uint8_t* __restrict__ pad, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int H, int T_len, int max_seq, int causal,
                    float scale_log2) {
  using L = Layout<DH>;
  constexpr int RS = L::RS, CPR = L::CPR, KS = DH / 16, STAGES = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* e_ring = reinterpret_cast<__nv_bfloat16*>(ring + STAGES * L::STAGE_BYTES);
  float* scr_all = reinterpret_cast<float*>(ring + STAGES * L::STAGE_BYTES + L::E_BYTES);
  float* scr = scr_all + warp * 16 * WBS;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(scr_all);  // until the first tile's products

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tile first
  const int bh = blockIdx.y, b = bh / H;
  const size_t base = (size_t)bh * T_len * DH;
  const int k_end = causal ? min(T_len, q0 + BQ) : T_len;
  const int n_kt = (k_end + BK - 1) / BK;

  auto stage = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(ring + s * L::STAGE_BYTES); };
  // The E band of a tile (row u at distance q0 - k0 - (BK - 1) + u, zero
  // where negative) is two chunks of 64 rows in a ring of NSLOT: the next
  // key tile's band starts 64 distances lower, so its upper chunk is this
  // tile's lower one and only its lower chunk is copied (both at the first
  // tile). Chunk c sits in slot c % NSLOT.
  static_assert(BQ == 64 && BK == 64, "the band moves one 64-row chunk a key tile");
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
  // key tile kt into ring stage s: K, V, the key flags and the band's new
  // chunks; (lo, hi) come back as the band's chunks, given the last tile's
  // lower one in lo
  auto load_tile = [&](int kt, int s, int& lo, int& hi) {
    const int k0 = kt * BK, dist0 = q0 - k0 - (BK - 1);
    if (kt == 0) {
      hi = n_chunks++;
      load_chunk(hi, dist0 + 64);
    } else {
      hi = lo;
    }
    lo = n_chunks++;
    load_chunk(lo, dist0);
    __nv_bfloat16* ks = stage(s);
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

  for (int x = tid; x < BQ * CPR; x += NTH) {  // the query tile, with the first key tile
    const int r = x / CPR, c = x - r * CPR;
    const bool ok = q0 + r < T_len;
    cp_async16(qs + r * RS + c * 8, q + base + (size_t)(ok ? q0 + r : 0) * DH + c * 8, ok);
  }
  int lo = 0, hi = 0, nlo = 0, nhi = 0;  // this tile's band chunks, and the next tile's
  load_tile(0, 0, lo, hi);

  uint32_t qa[KS][4];  // this warp's 16 query rows as A fragments
  float oacc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) oacc[n][x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (log2 units)
  const int ub = 16 * warp;  // the warp's first band row

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      nlo = lo;
      load_tile(kt + 1, (kt + 1) % STAGES, nlo, nhi);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int s = 0; s < KS; ++s)
        ldsm_x4(qa[s], qs + (ub + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + s * 16 +
                           (lane >> 4) * 8);
      __syncthreads();  // every warp holds its rows before the scratch is written over them
    }
    const __nv_bfloat16* ks = stage(kt % STAGES);
    const __nv_bfloat16* vs = ks + BK * RS;
    const float* live = reinterpret_cast<const float*>(vs + BK * RS);
    const __nv_bfloat16* elo = e_slot(lo);
    const __nv_bfloat16* ehi = e_slot(hi);
    const int k0 = kt * BK;

    // S = Q K^T and band = Q E_band^T (rows ub .. ub + WB - 1)
    float sacc[BK / 8][4], bacc[WB / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) sacc[n][x] = 0.f;
#pragma unroll
    for (int n = 0; n < WB / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) bacc[n][x] = 0.f;
    const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (np * 16 + brow) * RS + s * 16 + bcol);
        mma(sacc[2 * np], qa[s], bf[0], bf[1]);
        mma(sacc[2 * np + 1], qa[s], bf[2], bf[3]);
      }
#pragma unroll
      for (int np = 0; np < WB / 16; ++np) {
        uint32_t bf[4];
        const int r = ub + np * 16;  // a 16-row group never straddles the chunks
        ldsm_x4(bf, (r < 64 ? elo : ehi) + ((r & 63) + brow) * RS + s * 16 + bcol);
        mma(bacc[2 * np], qa[s], bf[0], bf[1]);
        mma(bacc[2 * np + 1], qa[s], bf[2], bf[3]);
      }
    }
    // the skew: Srel[r][j] = band[r][r - j + BK - 1]
#pragma unroll
    for (int n = 0; n < WB / 8; ++n) {
      *reinterpret_cast<float2*>(scr + g * WBS + 8 * n + 2 * t) =
          make_float2(bacc[n][0], bacc[n][1]);
      *reinterpret_cast<float2*>(scr + (g + 8) * WBS + 8 * n + 2 * t) =
          make_float2(bacc[n][2], bacc[n][3]);
    }
    __syncwarp();
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = g + 8 * (x >> 1), j = 8 * n + 2 * t + (x & 1);
        const int i = q0 + ub + r;
        float sc = (sacc[n][x] + scr[r * WBS + r - j + BK - 1]) * scale_log2;
        if (live[j] == 0.f || (causal && k0 + j > i)) sc = -INFINITY;
        sacc[n][x] = sc;
        mx[x >> 1] = fmaxf(mx[x >> 1], sc);
      }
    __syncwarp();  // the scratch is read before the next tile writes it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mu[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // a row with no visible key yet
      alpha[h] = exp2f(m[h] - mu[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) oacc[n][x] *= alpha[x >> 1];
    uint32_t pa[BK / 16][4];  // P as bf16 A fragments
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        p[x] = exp2f(sacc[n][x] - mu[x >> 1]);
        l[x >> 1] += p[x];
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // O += P V
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vs + (s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + np * 16 +
                          (lane >> 4) * 8);
        mma(oacc[2 * np], pa[s], bf[0], bf[1]);
        mma(oacc[2 * np + 1], pa[s], bf[2], bf[3]);
      }
    __syncthreads();  // every warp is done with this stage before it is refilled
    lo = nlo;
    hi = nhi;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = q0 + ub + g + 8 * h;
    if (i >= T_len) continue;
    const bool any = l[h] > 0.f;
    const float inv = any ? 1.f / l[h] : 0.f;
    __nv_bfloat16* orow = o + base + (size_t)i * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);
    if (t == 0) lse[(size_t)bh * T_len + i] = any ? m[h] * LN2 + logf(l[h]) : 1e30f;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   void* o, void* lse, int B, int H, int T_len, int max_seq, int causal,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<DH>;
  const int smem = Layout<DH>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, B * H);
  kernel<<<grid, NTH, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(e),
      static_cast<const uint8_t*>(pad), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      H, T_len, max_seq, causal, LOG2E * scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* e,
                        const void* pad, void* o, void* lse, int B, int H, int T_len, int dh,
                        int max_seq, int causal, float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<16>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, s);
    case 32: return launch<32>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, s);
    case 48: return launch<48>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, s);
    case 64: return launch<64>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, s);
    case 96: return launch<96>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, s);
    case 128: return launch<128>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. dtype: 0 = float32,
// 1 = bfloat16. pad may be null. scale multiplies q.(k + E) in the logits:
// 1/sqrt(d_head) of the caller's heads, which may have fewer columns than dh
// (zero columns padded up to an instantiated dh add nothing). Launches on
// `stream` and does not synchronise.
int flash_rel_attn_fwd(const void* q, const void* k, const void* v, const void* e,
                       const void* pad, void* o, void* lse, int B, int H, int T_len,
                       int dh, int max_seq, int causal, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > max_seq) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh(q, k, v, e, pad, o, lse, B, H, T_len, dh, max_seq, causal, scale, s);
  if (dtype == 1)
    return tc::dispatch_dh(q, k, v, e, pad, o, lse, B, H, T_len, dh, max_seq, causal, scale,
                              s);
  return cudaErrorInvalidValue;
}

const char* flash_rel_attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
