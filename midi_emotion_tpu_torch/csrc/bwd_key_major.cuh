// The key-major flash backward sweep on Hopper (sm_90a), shared by kernel 4
// (flash_rel_attn_bwd.cu, tc::flash_bwd_tc_kernel: dQ, dK, dV and dE) and
// kernel 7 (flash_rel_attn_bwd_kv.cu, wg::flash_bwd_kv_wg_tc_kernel: the
// same without the distance-domain half): the shared-memory layout, a
// block's walk over the tile pairs and the thread that copies them by TMA,
// phase A of a pair, a warpgroup's accumulator rows in global and shared
// memory, and the block-order dQ reduction. kernels/build.py hashes it into
// both libraries' names.
//
// Block sp of the nsplit a (b, h) sweeps groups sp, sp + nsplit, ... of G
// consecutive key tiles and, inside, the query tiles that see them
// (causal: from the group's first key tile on), as the TPU's sequential
// grid did; a query tile meets the group's key tiles from the last down,
// skipping those whose keys all lie past its rows under the causal mask.
// The 8 warps are two warpgroups; warp wq of a warpgroup owns rows 16 wq ..
// 16 wq + 15 of each of its 64-row accumulators: lane 4 g + t holds rows
// 16 wq + g + 8 hh, columns 8 c + 2 t + x, at acc[4 c + 2 hh + x].

#pragma once

#include "hopper_sm90.cuh"

namespace km {

using namespace sm90;

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int EB = BQ + BK;    // band rows staged per tile pair (the first one unused)
constexpr int NCW = 8;         // warps: two warpgroups
constexpr int NTH = 32 * NCW;
constexpr int MAX_SPLIT = 2;   // blocks a (b, h), at most: the dQ scratch holds two partials
constexpr int WB = 48;         // band columns a warp reads in phase A: its 47 distances
constexpr int WBS = WB + 8;    // row stride of a warp's band scratch (floats)
constexpr int SLAB = BQ * 32;  // slab stride of a 64-row bf16 tile
constexpr float LOG2E = 1.4426950408889634f;

// A block's shared memory: the pair ring (Q, dO, the E band), the group
// ring (K and V of each key tile), the P and dS' tiles [64 q][64 k], EXTRA
// bytes of the caller's own (kernel 4: dS' by distance), the warps' band
// scratch, with G = 2 each key tile's f32 dV (warpgroup 0) and dK (1)
// between pairs, and the mbarriers.
template <int DH, int G_, int EXTRA>
struct Layout {
  static_assert(DH <= 128, "a 64 x d_head f32 accumulator in a warpgroup's registers");
  static_assert(G_ == 1 || G_ == 2, "groups of one or two key tiles");
  static constexpr int G = G_;
  static constexpr int TILE = BQ * DH * 2;      // a 64-row bf16 tile in slabs: Q, dO, K or V
  static constexpr int E_TILE = EB * DH * 2;    // the E band, slab stride 4096
  static constexpr int ST = 2 * TILE + E_TILE;  // a pair's stage: Q, dO, the E band
  static constexpr int KV = 2 * G * TILE;       // a group's K, V of each key tile
  static constexpr int NST = 2;                 // the pair ring
  static constexpr int NKV = DH <= 96 ? 2 : 1;  // the group ring, where it fits
  static constexpr int KV_AT = NST * ST;
  static constexpr int P_AT = KV_AT + NKV * KV;  // P, then dS': [64 q][64 k] in slabs
  static constexpr int EXTRA_AT = P_AT + 2 * 8192;
  static constexpr int SCR_AT = EXTRA_AT + EXTRA;
  static constexpr int ACC_AT = SCR_AT + NCW * 16 * WBS * 4;
  static constexpr int BAR_AT = ACC_AT + (G == 2 ? G * 2 * BK * DH * 4 : 0);
  static constexpr int TOTAL = BAR_AT + 8 * (NST + NKV) + 1024;  // + room to align to 1024
  static_assert(TOTAL <= 232448, "a block's shared memory");
  static_assert(TILE % 1024 == 0 && ST % 1024 == 0 && SCR_AT % 1024 == 0, "aligned slabs");
};

struct Maps {
  CUtensorMap q, k, v, d, e;  // q, k, v, dO: [B*H][T][dh]; e: [max_seq][dh], in slabs
};

// The G key tiles of a group, and the pairs of the walk above.
template <int G>
struct Walk {
  int n_tiles, causal, sp, nsplit;
  // a group's first query tile
  __device__ __forceinline__ int first_q(int grp) const { return causal ? grp * G : 0; }
  // whether key tile u of group grp meets query tile qt
  __device__ __forceinline__ bool meets(int grp, int qt, int u) const {
    const int kt = grp * G + u;
    return kt < n_tiles && !(causal && kt > qt);
  }
};

// The copies, thread 0's alone (a ninth, producer warp would put three
// warps on one of the SM's four schedulers and cap every thread at 168
// registers): each group's K and V into a ring of NKV, each pair's Q, dO
// and E band (128 rows, row v at distance dist0 + 127 - v, zero where
// negative) into a ring of NST, by TMA, each slot's arrival counted by an
// mbarrier. produce() refills the slots whose last reader has passed the
// barrier that ends it. The next pair to copy is group c_g, query tile
// c_qt, its key tile G - 1 - c_uu; n_pairs pairs and n_kv groups were
// copied.
template <class L>
struct Producer {
  static constexpr int G = L::G;
  Walk<G> w;
  int bh, max_seq;
  int c_g, c_qt, c_uu = 0, n_pairs = 0, n_kv = 0;

  __device__ __forceinline__ Producer(const Walk<G>& walk, int bh_, int max_seq_)
      : w(walk), bh(bh_), max_seq(max_seq_), c_g(walk.sp), c_qt(walk.first_q(walk.sp)) {
    settle();
  }
  __device__ __forceinline__ void step() {
    if (++c_uu == G) {
      c_uu = 0;
      if (++c_qt == w.n_tiles) c_qt = w.first_q(c_g += w.nsplit);
    }
  }
  __device__ __forceinline__ void settle() {  // on to the first pair from here that exists
    while (c_g * G < w.n_tiles && !w.meets(c_g, c_qt, G - 1 - c_uu)) step();
  }
  // copy every pair whose slot is free: pairs_done pairs and groups_done
  // groups have been consumed
  __device__ __forceinline__ void produce(unsigned char* smem, const Maps& maps, uint64_t* full,
                                          uint64_t* kv_full, int pairs_done, int groups_done) {
    while (c_g * G < w.n_tiles && n_pairs < pairs_done + L::NST) {
      const int gi = (c_g - w.sp) / w.nsplit, kt0 = c_g * G;
      if (n_kv == gi) {  // the pair opens a group: its K and V first
        if (gi >= groups_done + L::NKV) return;
        const int ks = gi % L::NKV, nt = min(G, w.n_tiles - kt0);
        unsigned char* kv = smem + L::KV_AT + ks * L::KV;
        mbar_expect_tx(&kv_full[ks], nt * 2 * L::TILE);
        for (int u = 0; u < nt; ++u) {
          tma_load(kv + 2 * u * L::TILE, &maps.k, 0, (kt0 + u) * BK, 0, bh, &kv_full[ks]);
          tma_load(kv + (2 * u + 1) * L::TILE, &maps.v, 0, (kt0 + u) * BK, 0, bh, &kv_full[ks]);
        }
        ++n_kv;
      }
      const int kt = kt0 + G - 1 - c_uu;
      const int s = n_pairs % L::NST, q0 = c_qt * BQ, dist0 = q0 - kt * BK - (BK - 1);
      unsigned char* st = smem + s * L::ST;
      mbar_expect_tx(&full[s], L::ST);
      tma_load(st, &maps.q, 0, q0, 0, bh, &full[s]);
      tma_load(st + L::TILE, &maps.d, 0, q0, 0, bh, &full[s]);
      tma_load(st + 2 * L::TILE, &maps.e, 0, max_seq - EB - dist0, 0, 0, &full[s]);
      ++n_pairs;
      step();
      settle();
    }
  }
};

// This thread's rows of a warpgroup's 64-row accumulators, rl = 16 wq + g
// + 8 hh, in global memory.
template <int DH>
struct Rows {
  int wq, g, t, T_len;
  // dst = the f32 [T][DH] rows row0 + step * rl at src (0 in the block's
  // first group, where they are not yet written, or outside [0, T))
  __device__ __forceinline__ void load(float* dst, const float* src, int row0, int step,
                                       bool first) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + step * (16 * wq + g + 8 * hh);
      const bool ok = !first && row >= 0 && row < T_len;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const float2 x = ok ? *reinterpret_cast<const float2*>(src + (size_t)row * DH + 8 * c +
                                                               2 * t)
                            : make_float2(0.f, 0.f);
        dst[4 * c + 2 * hh] = x.x;
        dst[4 * c + 2 * hh + 1] = x.y;
      }
    }
  }
  // those rows at dst = old + add
  __device__ __forceinline__ void add(float* dst, const float* add, const float* old, int row0,
                                      int step) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + step * (16 * wq + g + 8 * hh);
      if (row < 0 || row >= T_len) continue;
      float* at = dst + (size_t)row * DH + 2 * t;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        *reinterpret_cast<float2*>(at + 8 * c) =
            make_float2(old[4 * c + 2 * hh] + add[4 * c + 2 * hh],
                        old[4 * c + 2 * hh + 1] + add[4 * c + 2 * hh + 1]);
    }
  }
  // the bf16 [T][DH] rows row0 + rl at out = acc (a key tile's dK or dV)
  __device__ __forceinline__ void store(__nv_bfloat16* out, int row0, const float* acc) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = row0 + 16 * wq + g + 8 * hh;
      if (key < T_len) {
        __nv_bfloat16* row = out + (size_t)key * DH + 2 * t;
#pragma unroll
        for (int c = 0; c < DH / 8; ++c)
          *reinterpret_cast<uint32_t*>(row + 8 * c) =
              pack_bf16(acc[4 * c + 2 * hh], acc[4 * c + 2 * hh + 1]);
      }
    }
  }
  // lse (in log2 units) and dsum of the query rows q0 + rl, from [T] at lse
  // and dsum
  __device__ __forceinline__ void stats(float* lse_n, float* dsum_n, const float* lse,
                                        const float* dsum, int q0) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = q0 + 16 * wq + g + 8 * hh;
      lse_n[hh] = i < T_len ? lse[i] * LOG2E : 0.f;
      dsum_n[hh] = i < T_len ? dsum[i] : 0.f;
    }
  }
};

// G = 2: warpgroup wgi's f32 accumulator (dV or dK) of the group's key tile
// u in shared memory between pairs, a thread's own float4s (no bank
// conflicts); s is ACC_AT's float4s plus this thread's tid & 127.
template <int DH>
struct AccSlab {
  static constexpr int R = DH / 2;
  float4* s;
  int wgi;
  __device__ __forceinline__ float4& at(int u, int x4) const {
    return s[((u * 2 + wgi) * (R / 4) + x4) * 128];
  }
  __device__ __forceinline__ void zero(int u) const {
#pragma unroll
    for (int x4 = 0; x4 < R / 4; ++x4) at(u, x4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void load(int u, float* acc) const {
#pragma unroll
    for (int x4 = 0; x4 < R / 4; ++x4) {
      const float4 v = at(u, x4);
      acc[4 * x4] = v.x;
      acc[4 * x4 + 1] = v.y;
      acc[4 * x4 + 2] = v.z;
      acc[4 * x4 + 3] = v.w;
    }
  }
  // acc back (or zeros, at the key tile's last query tile)
  __device__ __forceinline__ void save(int u, const float* acc, bool zero) const {
#pragma unroll
    for (int x4 = 0; x4 < R / 4; ++x4)
      at(u, x4) = zero ? make_float4(0.f, 0.f, 0.f, 0.f)
                       : make_float4(acc[4 * x4], acc[4 * x4 + 1], acc[4 * x4 + 2],
                                     acc[4 * x4 + 3]);
  }
};

// Phase A of a pair for warpgroup wgi (keys 32 wgi .. of the key tile at
// kb): S = Q K^T, dP = dO V^T (m64n32) and the band Q E^T over the 96 band
// rows its keys reach (m64n96), by wgmma from the pair's stage at q_t (Q,
// dO, the E band) and the key tile at k_t (K, V); the band skewed into Srel
// through the warp's scratch scr; P = exp(s - lse) and dS' = c P (dP -
// dsum) in f32 (0 where masked: a row past T, a dead key in `live`, a key
// past its row under the causal mask), both rounded to bf16 into the P and
// dS' tiles at p_s and ds_s. on_ds(il, j, dsb) takes each rounded dS' pair
// (row il of the query tile, keys j and j + 1 of the key tile) for the
// caller's own use. The caller fences the async proxy and holds the
// barrier that hands P and dS' to phase B.
template <int DH, class OnDs>
__device__ __forceinline__ void phase_a(uint32_t q_t, uint32_t k_t, unsigned char* p_s,
                                        unsigned char* ds_s, float* scr, int wgi, int wq,
                                        int lane, int q0, int kb, uint32_t live, int T_len,
                                        int causal, const float* lse_r, const float* dsum_r,
                                        float scale, float scale_log2, OnDs&& on_ds) {
  constexpr int KS = DH / 16, TILE = BQ * DH * 2;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t d_t = q_t + TILE, e_t = q_t + 2 * TILE, v_t = k_t + TILE;
  float sacc[16], pacc[16], bacc[48];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t da = desc_k(q_t + kk * SLAB);
    mma_ss<32, 0, 0>(sacc, da, desc_k(k_t + 1024 * wgi + kk * SLAB), kk > 0);
    mma_ss<32, 0, 0>(pacc, desc_k(d_t + kk * SLAB), desc_k(v_t + 1024 * wgi + kk * SLAB), kk > 0);
    mma_ss<96, 0, 0>(bacc, da, desc_k(e_t + 1024 * wgi + kk * 2 * SLAB), kk > 0);
  }
  wg_commit();
  wg_wait0();
  fence_regs<16>(sacc);
  fence_regs<16>(pacc);
  fence_regs<48>(bacc);
  // the skew: band column (from row 32 wgi) of row r, key 32 wgi + j is 64
  // - (16 wq + r) + j; the warp keeps columns 48 - 16 wq .. 95 - 16 wq
  // (chunks 6 - 2 wq ..), so it reads scratch column 16 - r + j
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
  // whether any of the warp's pairs is masked: a row past T, a dead key, or
  // a key past a row under the causal mask
  const bool masked = q0 + 16 * wq + 15 >= T_len || live != 0xffffffffu ||
                      (causal && kb + 32 * wgi + 31 > q0 + 16 * wq);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh, il = 16 * wq + r, i = q0 + il;
      const int jl = 8 * n + 2 * t, j = 32 * wgi + jl;
      float p[2], ds[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float sc = sacc[4 * n + 2 * hh + x] + scr[r * WBS + 16 - r + jl + x];
        const bool ok = !masked || (i < T_len && ((live >> (jl + x)) & 1) &&
                                    !(causal && kb + j + x > i));
        p[x] = ok ? exp2f(sc * scale_log2 - lse_r[hh]) : 0.f;
        ds[x] = p[x] * (pacc[4 * n + 2 * hh + x] - dsum_r[hh]) * scale;
      }
      const uint32_t at = (j >> 4) * 2048 + sw32(il, j & 15);
      *reinterpret_cast<uint32_t*>(p_s + at) = pack_bf16(p[0], p[1]);
      const uint32_t dsb = pack_bf16(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(ds_s + at) = dsb;
      on_ds(il, j, dsb);
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

// ---- host

// the tensor maps of a launch over B * H = bh heads
inline cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                             const void* dout, const void* e, int bh, int T_len, int dh,
                             int max_seq) {
  cudaError_t err;
  if ((err = sm90_host::slab_map(&m->q, q, bh, T_len, dh, BQ)) != cudaSuccess ||
      (err = sm90_host::slab_map(&m->k, k, bh, T_len, dh, BK)) != cudaSuccess ||
      (err = sm90_host::slab_map(&m->v, v, bh, T_len, dh, BK)) != cudaSuccess ||
      (err = sm90_host::slab_map(&m->d, dout, bh, T_len, dh, BQ)) != cudaSuccess ||
      (err = sm90_host::slab_map(&m->e, e, 1, max_seq, dh, EB)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

// dq (bf16, n values) = the nsplit partials [nsplit][n] at dq_acc summed
inline cudaError_t reduce_dq(const void* dq_acc, void* dq, size_t n, int nsplit,
                             cudaStream_t stream) {
  dq_reduce_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), n, nsplit);
  return cudaGetLastError();
}

}  // namespace km
