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
// tensor cores' 989 TFLOP/s, against 3 MB of inputs and outputs. Design
// (tc::flash_fwd_tc_kernel), on what Hopper added; the building blocks
// (wgmma, TMA, mbarriers) are in hopper_sm90.cuh:
//   * a block is one consumer warpgroup on 64 query rows and one producer
//     warp. The warpgroup's wgmma accumulators hold the 64 rows, warp w
//     rows 16 w .. 16 w + 15, in the layout of mma.sync's fragments, so the
//     skew, the online softmax and P stay inside the warp;
//   * one producer lane copies the query tile, then each key tile's K and
//     V into a two-stage ring and the E band's next 64-row chunk into a
//     ring of three (the band moves 64 distances a key tile, so a tile
//     copies one new chunk), by TMA, each stage guarded by a full and an
//     empty mbarrier. Tiles land in 16-column slabs with TMA's 32-byte
//     swizzle, which wgmma reads K-major or MN-major (a 96-byte row of
//     d_head 48 is three slabs); rows past T, and E rows of negative
//     distance, land as zeros, so Srel is 0 above the diagonal, which the
//     non-causal (regression) model needs;
//   * per key tile: S = Q K^T (m64n64) and the band Q E_band^T (two
//     m64n64, a chunk each) from shared memory; the band skewed into Srel
//     through a per-warp scratch (row r, key j reads band column 64 - r +
//     j); the online softmax in f32 (exp2 with log2(e) folded into the
//     scale), masks applied only by warps whose rows one reaches; P rounded
//     to bf16 straight from the score registers into wgmma's A fragments
//     (the TPU kernel casts P to the input dtype the same way) and O += P V
//     with V read MN-major;
//   * two blocks an SM up to d_head 64, one at 96 and 128. The wgmma sit in
//     no branch the compiler sees as divergent and no accumulator is
//     written while one is in flight, so ptxas does not serialize them;
//   * d_head 192 and 256: O's 64 x d_head f32 accumulator would pass a
//     thread's registers and the tiles a block's shared memory, so two
//     blocks share a query tile (grid z), each computing O's columns of
//     one half (m64n96 or m64n128 P V from a V tile of those columns) after
//     the whole score side (S, the band and the softmax, over every
//     16-column slab of d_head, as the narrower heads do); the first
//     writes lse. At 256 the K, V ring has one stage (Q, K, V and the E
//     ring of two 64-row chunks take 160 KB), at 192 two.
// Measured before this design, the mma.sync kernel it replaces took 0.1255
// ms at B 4 and 0.2203 ms at B 8, ptxas giving it 168 registers and 32
// bytes of spill at d_head 48 (scripts/torch_flash_bench.py, NVIDIA H100
// 80GB HBM3 at 700 W).
//
// f32 (the checks' path, held to 1e-4): CUDA cores, because TF32 tensor-core
// products keep about three decimal digits and cannot meet that. One block
// of 64 threads per 64-row query tile, a thread a query row with q (pre-
// scaled) and its f32 accumulator in registers; K, V and the band of BQ +
// BK - 1 E rows staged in shared memory as f32 per 64-key tile; since q.k +
// q.E = q.(k + E), each score costs dh FMAs. Shared-memory traffic and the
// 64-thread blocks bound it; from d_head 128 its two d_head-float rows pass
// the 255 registers a thread may hold and spill (correct, slower). At
// d_head 256 a key tile is 32 keys, so its K, V and band fit 227 KB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

constexpr int BQ = 64;             // query rows per block = threads per block
constexpr int CHUNK = 16;          // scores held in registers at once

// keys per shared-memory tile: 64, or 32 at d_head 256, whose 64-key K, V
// and band tiles would pass the 232,448 bytes a block may use
template <int DH>
__host__ __device__ constexpr int key_tile() { return DH > 192 ? 32 : 64; }
template <int DH>
__host__ __device__ constexpr int e_stride() { return DH + 4; }  // 16-byte aligned, conflict-free rows

template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int BK = key_tile<DH>(), BAND = BQ + BK - 1;  // BAND: distances i - j in a tile pair
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
  constexpr int BK = key_tile<DH>(), BAND = BQ + BK - 1, ES = e_stride<DH>();
  static_assert(BK % CHUNK == 0, "a chunk never crosses a tile");
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
    case 192:
      return launch<192>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, stream);
    case 256:
      return launch<256>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// the bf16 path: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;

constexpr int BQ = 64;              // query rows per block: one warpgroup's wgmma tile
constexpr int BK = 64;              // keys per tile
constexpr int EB = BQ + BK;         // band rows staged per key tile (the first one unused)
constexpr int NCW = 4;              // consumer warps: one warpgroup
constexpr int NTH = 32 * (NCW + 1); // + the producer warp
constexpr int WB = 80;              // band columns a warp reads: its rows' 79 distances
constexpr int WBS = WB + 8;         // row stride of a warp's band scratch (floats)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// DV: the output columns a block computes (the grid's z index picks which
// DV of the DH): DH itself up to d_head 128, DH / 2 at 192 and 256, where
// O's 64 x DH f32 accumulator would pass a thread's registers.
template <int DH, int DV>
struct Layout {
  static_assert(DH % DV == 0 && DV <= 128, "column chunks of at most 128");
  // the K, V ring: the next key tile lands under this one, where two
  // stages fit (at d_head 256 Q, K, V and the E ring take 160 KB a stage)
  static constexpr int NST = DH > 192 ? 1 : 2;
  static constexpr int NE = NST + 1;        // the E ring, in chunks of 64 rows
  static constexpr int TILE = BQ * DH * 2;  // a 64-row bf16 tile in slabs: Q, K or an E chunk
  static constexpr int VT = BK * DV * 2;    // the V tile: this block's DV columns
  static constexpr int STAGE = TILE + VT;   // K, V
  static constexpr int ST_AT = TILE;        // Q first
  static constexpr int E_AT = ST_AT + NST * STAGE;
  static constexpr int SCR_AT = E_AT + NE * TILE;
  static constexpr int BAR_AT = SCR_AT + NCW * 16 * WBS * 4;
  static constexpr int TOTAL = BAR_AT + 8 * (2 * NST + 1) + 1024;  // + room to align to 1024
  // blocks an SM's 228 KB hold (1 KB a block reserved), at most 2
  static constexpr int MIN_BLOCKS = 233472 / (TOTAL + 1024) < 2 ? 1 : 2;
  static_assert(TILE % 1024 == 0 && STAGE % 1024 == 0, "slabs stay 1024-byte aligned");
  static_assert(TOTAL <= 232448, "a block's shared memory");
};

struct Maps {
  CUtensorMap q, k, v, e;  // q, k, v: [B*H][T][dh], e: [max_seq][dh], in slabs
};

// One block: a 64-row query tile of one (b, h), the heaviest tiles first.
// Warp 4 is the producer: one lane copies the query tile, then each key
// tile's K, V and E band by TMA into a ring of NST stages, each guarded by a
// full and an empty mbarrier. Warps 0-3 are one consumer warpgroup; warp w
// owns rows 16 w .. 16 w + 15 of every 64-row accumulator, so the skew, the
// online softmax and P stay inside the warp, as in the mma.sync design this
// replaces. Per key tile: S = Q K^T (m64n64) and the band Q E_band^T
// (m64n128) by wgmma from shared memory; the band (row v at distance dist0 +
// 127 - v, zero where negative) skewed into Srel through a per-warp scratch;
// the online softmax in f32; P rounded to bf16 into wgmma A fragments; O +=
// P V (m64 n DV, A from registers, V read MN-major). Past d_head 128 a
// block computes O's columns DV z .. DV z + DV - 1 (z = blockIdx.z): the
// score side (S, the band, the softmax) runs over the whole d_head in
// each of the DH / DV blocks of a query tile, and only the first writes
// lse.
template <int DH, int DV>
__global__ void __launch_bounds__(NTH, (Layout<DH, DV>::MIN_BLOCKS))
flash_fwd_tc_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ pad,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int T_len,
                    int max_seq, int causal, float scale_log2) {
  using L = Layout<DH, DV>;
  constexpr int NST = L::NST, KS = DH / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_AT);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int g = lane >> 2, t = lane & 3;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tile first
  const int bh = blockIdx.y, b = bh / H;
  const int k_end = causal ? min(T_len, q0 + BQ) : T_len;
  const int n_kt = (k_end + BK - 1) / BK;
  auto stage = [&](int s) { return L::ST_AT + s * L::STAGE; };  // K, then V
  auto chunk = [&](int c) { return L::E_AT + (c % L::NE) * L::TILE; };
  // E chunk c: rows from e0 + 64 c. The band of key tile kt (row v at
  // distance dist0 + 127 - v) is E rows max_seq - EB - dist0 + v = e0 + 64
  // kt + v: chunks kt and kt + 1; rows past either end of E, negative
  // distances, land as zeros
  const int e0 = max_seq - EB - (q0 - (BK - 1));

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCW) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(qbar, L::TILE);
      tma_load(smem, &maps.q, 0, q0, 0, bh, qbar);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NST, k0 = kt * BK;
        if (kt >= NST) mbar_wait(&empty[s], (kt / NST - 1) & 1);
        // K, V and the band's new chunk (both chunks for the first tile);
        // the chunk's slot last held chunk kt - 2, which tile kt - 2 was
        // the last to read
        mbar_expect_tx(&full[s], (kt == 0 ? 3 : 2) * L::TILE + L::VT);
        unsigned char* st = smem + stage(s);
        tma_load(st, &maps.k, 0, k0, 0, bh, &full[s]);
        tma_load(st + L::TILE, &maps.v, 0, k0, blockIdx.z * (DV / 16), bh, &full[s]);
        if (kt == 0) tma_load(smem + chunk(0), &maps.e, 0, e0, 0, 0, &full[s]);
        tma_load(smem + chunk(kt + 1), &maps.e, 0, e0 + 64 * (kt + 1), 0, 0, &full[s]);
      }
    }
    return;
  }

  float* scr = reinterpret_cast<float*>(smem + L::SCR_AT) + warp * 16 * WBS;
  const int ub = 16 * warp;  // the warp's first row
  float oacc[DV / 2];
#pragma unroll
  for (int x = 0; x < DV / 2; ++x) oacc[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (log2 units)
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % NST, k0 = kt * BK;
    // key j of the tile is live at bit j % 32 of live[j / 32]
    uint32_t live[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = k0 + 32 * hf + lane;
      live[hf] = __ballot_sync(0xffffffffu,
                               key < T_len && !(pad != nullptr && pad[(size_t)b * T_len + key]));
    }
    // masks this warp's rows need: the causal one where a key of the tile
    // passes its first row, the key one where a key is dead
    const bool masked = (causal && k0 + BK - 1 > q0 + ub) || (live[0] & live[1]) != 0xffffffffu;
    const uint32_t st = base + stage(s);
    mbar_wait(&full[s], (kt / NST) & 1);

    // S = Q K^T and band = Q E_band^T, band rows 0..63 and 64..127 from
    // chunks kt and kt + 1 (the first k16 step overwrites)
    float sacc[BK / 2], bacc[2][BK / 2];
    const uint32_t c_lo = base + chunk(kt), c_hi = base + chunk(kt + 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t da = desc_k(base + kk * L::TILE / KS);
      mma_ss<BK, 0, 0>(sacc, da, desc_k(st + kk * L::TILE / KS), kk > 0);
      mma_ss<BK, 0, 0>(bacc[0], da, desc_k(c_lo + kk * L::TILE / KS), kk > 0);
      mma_ss<BK, 0, 0>(bacc[1], da, desc_k(c_hi + kk * L::TILE / KS), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs<BK / 2>(sacc);
    fence_regs<BK / 2>(bacc[0]);
    fence_regs<BK / 2>(bacc[1]);

    // the skew: Srel[r][j] = band[r][64 - (ub + r) + j]. The warp keeps
    // band columns 48 - ub .. 127 - ub (chunks 6 - 2 w .. 15 - 2 w), so row
    // r, key j reads its scratch column 16 - r + j
#pragma unroll
    for (int c = 0; c < EB / 8; ++c) {
      const int cc = c - (6 - 2 * warp);
      if (cc >= 0 && cc < WB / 8) {
        const float* bc = bacc[c / 8] + 4 * (c % 8);
        *reinterpret_cast<float2*>(scr + g * WBS + 8 * cc + 2 * t) = make_float2(bc[0], bc[1]);
        *reinterpret_cast<float2*>(scr + (g + 8) * WBS + 8 * cc + 2 * t) =
            make_float2(bc[2], bc[3]);
      }
    }
    __syncwarp();
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = g + 8 * (x >> 1), j = 8 * n + 2 * t + (x & 1);
        const int i = q0 + ub + r;
        float sc = (sacc[4 * n + x] + scr[r * WBS + 16 - r + j]) * scale_log2;
        if (masked && (!((live[j >> 5] >> (j & 31)) & 1) || (causal && k0 + j > i)))
          sc = -INFINITY;
        sacc[4 * n + x] = sc;
        mx[x >> 1] = fmaxf(mx[x >> 1], sc);
      }
    __syncwarp();  // the scratch is read before the next tile writes it
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mu[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];  // a row with no visible key yet
      alpha[hh] = exp2f(m[hh] - mu[hh]);
      m[hh] = mx[hh];
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int x = 0; x < DV / 2; ++x) oacc[x] *= alpha[(x >> 1) & 1];
    uint32_t pa[BK / 16][4];  // P as bf16 A fragments, one set per k16 step
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        p[x] = exp2f(sacc[4 * n + x] - mu[x >> 1]);
        l[x >> 1] += p[x];
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // O += P V: V [keys][dh] read MN-major (a k16 step is 16 key rows)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<DV, 1>(oacc, pa[kk], desc_mn(st + L::TILE + kk * 512, L::TILE / KS));
    wg_commit();
    wg_wait0();
    fence_regs<DV / 2>(oacc);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  const size_t obase = (size_t)bh * T_len * DH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + ub + g + 8 * hh;
    if (i >= T_len) continue;
    const bool any = l[hh] > 0.f;
    const float inv = any ? 1.f / l[hh] : 0.f;
    __nv_bfloat16* orow = o + obase + (size_t)i * DH + blockIdx.z * DV;
#pragma unroll
    for (int c = 0; c < DV / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t) =
          pack_bf16(oacc[4 * c + 2 * hh] * inv, oacc[4 * c + 2 * hh + 1] * inv);
    if (t == 0 && blockIdx.z == 0)
      lse[(size_t)bh * T_len + i] = any ? m[hh] * LN2 + logf(l[hh]) : 1e30f;
  }
}

template <int DH, int DV = DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e, const void* pad,
                   void* o, void* lse, int B, int H, int T_len, int max_seq, int causal,
                   float scale, cudaStream_t stream) {
  Maps maps;
  cudaError_t err;
  if ((err = sm90_host::slab_map(&maps.q, q, B * H, T_len, DH, BQ)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.k, k, B * H, T_len, DH, BK)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.v, v, B * H, T_len, DH, BK, DV / 16)) != cudaSuccess ||
      (err = sm90_host::slab_map(&maps.e, e, 1, max_seq, DH, BK)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_tc_kernel<DH, DV>;
  const int smem = Layout<DH, DV>::TOTAL;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, B * H, DH / DV);
  kernel<<<grid, NTH, smem, stream>>>(maps, static_cast<const uint8_t*>(pad),
                                      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
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
    case 192:
      return launch<192, 96>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, s);
    case 256:
      return launch<256, 128>(q, k, v, e, pad, o, lse, B, H, T_len, max_seq, causal, scale, s);
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
