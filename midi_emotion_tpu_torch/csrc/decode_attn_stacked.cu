// One-token attention over the stacked int8/bf16 KV cache of one layer, for
// Hopper (sm_90a).
//
// Replaces midi_emotion_tpu/ops/decode_attention.py::_kernel (the Pallas TPU
// kernel launched by _run). For the query of batch row b and head h at window
// position length + p_cnt it computes, over the `length` flushed cache rows,
//
//     logit[w] = (q . k[w] + q_bf16 . e_rows[w]) * scale,   w < length
//
// where scale is 1/sqrt(d_head) of the caller's heads, which may have fewer
// columns than the instantiated dh (the cache is then laid out at dh with
// zero columns, which change no product),
//
// with a softmax across window blocks of `bw` keys, and returns the
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
// q [B, H, dh] f32 or bf16, taken as it comes.
//
// int8 mode: q is quantised here (sq = max|q|/127 + 1e-20, q8 = rint(q / sq),
// f32, as ops/decode_attention.py::quantize_q does), the score is the exact
// integer dot of q8 and the raw int8 K, scaled by sq * ks. P times the value
// scales is re-quantised to int8 per (b, h, window block) with s_p =
// max/127 + 1e-20 and summed against the raw int8 V in integers. bf16 mode:
// bf16 products summed in f32, p rounded to bf16 before the PV sum. The
// plain twin (ops/decode_attention.py::decode_attn_cached_plain) walks the
// same blocks with a running max; block j here uses the prefix max m_j over
// blocks 0..j, which is that running max, so P re-quantises the same way.
//
// Bound on the H100: bytes. At B 64, length 1216, D 768, one layer's live
// int8 rows and scales are 126.1 MB, 37.6 us at 3.35 TB/s (bf16: 240.6 MB,
// 71.8 us). The first version (one 128-thread block per (b, h)) took 221 us
// in both modes, held back by latency, not bytes. What this design does
// about each cause:
//   * the serial PV loop (one 1-2 byte load per key and thread): every
//     product is an mma.sync over tiles in shared memory (int8 m16n8k32 with
//     exact s32 sums, bf16 m16n8k16): scores and the bias on 16 keys by 8
//     heads, PV on 64 channels by 8 heads, summed in registers over a block;
//   * block-wide reductions (eight barriers a window block): block maxima
//     by shared atomics as the scores are written, one cluster exchange of
//     them, then a warp a (block, head) pair for P; no barrier a tile;
//   * the head-slice gather (every row fetched by 16 blocks): one cluster of
//     CTAs per batch row covers all heads, so each cache row (all heads' K
//     and V) leaves HBM once a step. A producer warp copies tiles of 32
//     rows with tensor-map (TMA) copies into a ring of 2-4 stages (K halves
//     with their E rows and scales, then V halves), each completing on a
//     "full" mbarrier; the 15 consumer warps release a stage on an "empty"
//     one. Two groups of consumers take alternate K tiles, so two tiles are
//     in work at once. The cluster's CTAs split the live window blocks
//     (about one CTA an SM over the batch, at most 8 a cluster), publish
//     their block maxima in distributed shared memory and take the prefix
//     max after a cluster barrier; rank 0 sums the partial (acc, l) in rank
//     order (no atomics) and runs the staged tail (its logits computed
//     while the first tiles land), the self term and the stage write: one
//     launch a layer-step, no combine kernel;
//   * host launches: q is quantised and cast inside the kernel, so the
//     wrapper launches nothing else;
//   * widths: a CTA holds the channels of one head group, the most heads
//     dividing H within 1024 channels (all 16 heads at D 768; 2 groups of 5
//     heads of 128 at D 1280), and the grid's z index is the group. Heads are
//     independent in attention (softmax, P and PV never mix them), so the
//     groups need no combine: each runs the whole pipeline above on its
//     columns, addressed by a slab offset in the same tensor map. This keeps a
//     ring stage (32 rows of the group's K or V half) at the size the 1024
//     channel design has, so two or more stages fit at any width; a loop over
//     groups inside one CTA would instead re-run the window once a group with
//     the SMs split fewer ways. d_head 96 and 128 E rows (192 and 256 bytes)
//     are copied unswizzled.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the encoder is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;          // threads per CTA: 16 warps, one CTA an SM
constexpr int NW = NT / 32;
constexpr int TK = 32;           // cache rows per tile
constexpr int NS_MAX = 4;        // ring stages at most
constexpr int CHUNK = 64;        // channels per warp in the PV product
constexpr int MAX_D = 1024;       // channels of a head group (a CTA's H * dh) at most
constexpr int PRODUCER = NW - 1;   // the warp that issues the tile copies
constexpr int NC = NW - 1;         // the consumer warps, 0..NC - 1
constexpr int MAX_SLOTS = 2;       // PV chunks a consumer warp: D <= NC * CHUNK * 2
constexpr int MAX_CLUSTER = 8;   // portable cluster size
constexpr int MAX_STAGE = 128;   // stage rows folded by the tail
constexpr int SMEM_MAX = 232448; // bytes of shared memory a CTA may use
constexpr float NEG = -1e30f;

__host__ __device__ constexpr int up(int x, int m) { return (x + m - 1) / m * m; }

struct Params {
  CUtensorMap tmap;  // the cache rows of this call: [L][B][length rows][2D / slab][slab]
  CUtensorMap emap;  // e_rows [W][dh]
  CUtensorMap smap;  // the int8 scales [L][B][2H][W] (bulk_sc)
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
  int L, B, W, H, layer, length, S, p_cnt, bw, q_bf16;
  int Ht;       // heads of the model; H is a head group's, blockIdx.z the group
  int nblk, per, ns;  // live window blocks, blocks per CTA, ring stages
  int nsh;      // slabs in a head group's half row
  int nsh_t;    // slabs in a whole half row
  int bulk_sc;  // the scale rows are 16-byte multiples: copied by tensor map
  float scale;
};

// Byte offsets of the dynamic shared memory, the same on host and device.
struct Layout {
  int rstride, lstride, bwp, tpb, vpitch, e_at, ks_at, stage;
  int bar, ring, lg, vsc, q8, qh, sq, bmax, allmax, mj, wj, sp, lpart, lsum, mfin, acc, tail, total;
};

__host__ __device__ inline Layout layout(int H, int dh, int bw, int per, int ns, int S, bool quant) {
  Layout o;
  const int D = H * dh, item = quant ? 1 : 2;
  o.rstride = D * item;  // a tile row's bytes (the tile is dense and swizzled)
  o.bwp = up(bw, TK);
  o.tpb = o.bwp / TK;  // tiles a block
  o.lstride = o.bwp * 4 + 16;  // a (block, head) row of logits, then of P
  o.vpitch = up(H * TK * 2, 128);  // one tile's value scales [H][TK]
  // a stage: the cache rows, the E rows [TK][dh] (1024-aligned for their
  // swizzle), the key scales [H][TK]
  o.e_at = up(TK * o.rstride, 1024);
  o.ks_at = up(o.e_at + TK * dh * 2, 128);
  o.stage = up(o.ks_at + (quant ? o.vpitch : 0), 1024);
  int at = 0;
  auto take = [&](int bytes) { const int r = at; at += up(bytes, 128); return r; };
  o.ring = take(ns * o.stage > NW * MAX_STAGE * 4 ? ns * o.stage : NW * MAX_STAGE * 4);
  o.bar = take(2 * NS_MAX * 8);  // full[NS_MAX], then empty[NS_MAX]
  o.lg = take(per * H * o.lstride);
  o.vsc = take(quant ? per * o.tpb * o.vpitch : 0);
  o.q8 = take(up(D, 32) + 32);
  o.qh = take(D * 2 + 32);
  o.sq = take(H * 4);
  o.bmax = take(per * H * 4);
  o.allmax = take(MAX_CLUSTER * per * H * 4);
  o.mj = take(per * H * 4);
  o.wj = take(per * H * 4);
  o.sp = take(per * H * 4);
  o.lpart = take(per * H * 4);
  o.lsum = take(H * 4);
  o.mfin = take(H * 4);
  o.acc = take(D * 4);
  o.tail = take(H * (S + 1) * 4);  // the stage rows' and the self term's logits
  o.total = at + 1024;  // room to align the ring to 1024 bytes
  return o;
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// a float's order as a signed int (an involution): block maxima by atomicMax
__device__ __forceinline__ int ordered(int bits) { return bits >= 0 ? bits : bits ^ 0x7fffffff; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// one tensor-map box (5 coordinates, innermost first) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// f32 dot of DH bf16 values (16-byte aligned, global) with qh (shared).
template <int DH>
__device__ __forceinline__ float dot_bf16(const __nv_bfloat16* row, const __nv_bfloat16* qh) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const uint4 x = r4[i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a = fmaf(bf2f(qh[8 * i + 2 * j]), __uint_as_float(w[j] << 16), a);
      a = fmaf(bf2f(qh[8 * i + 2 * j + 1]), __uint_as_float(w[j] & 0xffff0000u), a);
    }
  }
  return a;
}

// Register transpose of four 4-byte words (rows r = 0..3) into four words
// (columns): b[c] byte r = w[r] byte c.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* b) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
  b[0] = __byte_perm(lo01, lo23, 0x5410);
  b[1] = __byte_perm(lo01, lo23, 0x7632);
  b[2] = __byte_perm(hi01, hi23, 0x5410);
  b[3] = __byte_perm(hi01, hi23, 0x7632);
}

// A tile's cache rows in shared memory: [slab][row][S bytes], as the copy
// engine writes a box. With S = 128 it swizzles each 16-byte unit by the row
// (unit ^= row % 8), so the eight rows of an mma fragment fall in eight
// distinct units; S = 16 (rows whose halves are not 128-byte multiples) is
// conflict-free as it is.
template <int S>
__device__ __forceinline__ int tile_at(int r, int x) {
  static_assert(S == 16 || S == 128, "slab of 16 or 128 bytes");
  constexpr int LS = S == 128 ? 7 : 4;
  return r * S + (x >> LS) * (TK * S) + ((x & (S - 1)) ^ (S == 128 ? (r & 7) << 4 : 0));
}

// One cluster per batch row b (gridDim = (cluster size, B)). CTA `rank` owns
// window blocks [rank * per, rank * per + per) below nblk. Its work is a
// sequence of tile jobs: the K tiles of its blocks, then their V tiles, each
// one box of cache rows (plus, for K, the E rows and scales) in a ring
// stage. The three products put the keys or channels on the mma's 16 rows
// and 8 heads on its columns, so only the reduction is block-diagonal:
//   scores  S^T [16 keys x 8 heads] = K [keys x ch] . Qbd [ch x heads], over
//           the channels of 4 of the 8 heads (a warp's unit);
//   bias    [16 keys x 8 heads] = E [keys x dh] . qh^T;
//   PV      O^T [channels x 8 heads] = V^T [ch x keys] . P^T [keys x heads],
//           a warp's 64-channel chunks, summed in registers over the tiles
//           of a block and folded into acc_s (scaled) at its last tile.
template <int DH, bool QUANT, int S>
__global__ void __launch_bounds__(NT, 1) decode_attn_stacked_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-static_cast<int>(smem_u32(smem_raw)) & 1023);  // 1024-aligned
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int H = p.H, D = H * DH, bw = p.bw;  // this head group's
  const int hg0 = blockIdx.z * H, Dt = p.Ht * DH;  // its first head; the model's width
  constexpr int ITEM = QUANT ? 1 : 2;
  constexpr int KS = QUANT ? 32 : 16;  // channels per score k-step (32 bytes)
  constexpr int NKS = 8 * DH / KS;     // k-steps over 8 heads' channels
  const Layout lo = layout(H, DH, bw, p.per, p.ns, p.S, QUANT);
  const int lsf = lo.lstride / 4;  // logits row stride in floats
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar);  // [ns] the tile has landed
  uint64_t* empty = full + NS_MAX;  // [ns] every consumer warp is done with the stage
  unsigned char* ring = smem + lo.ring;
  float* s_lg = reinterpret_cast<float*>(smem + lo.lg);  // [per][H][lsf]: logits, then P
  unsigned char* vsc_s = smem + lo.vsc;  // [per][tile][H][TK] bf16, tiles vpitch apart
  int8_t* q8_s = reinterpret_cast<int8_t*>(smem + lo.q8);
  __nv_bfloat16* qh_s = reinterpret_cast<__nv_bfloat16*>(smem + lo.qh);
  float* sq_s = reinterpret_cast<float*>(smem + lo.sq);
  int* bmax_s = reinterpret_cast<int*>(smem + lo.bmax);          // [per][H] ordered maxima
  float* allmax_s = reinterpret_cast<float*>(smem + lo.allmax);  // [nblk][H], every CTA's
  float* mj_s = reinterpret_cast<float*>(smem + lo.mj);          // [per][H] prefix maxima
  float* wj_s = reinterpret_cast<float*>(smem + lo.wj);          // [per][H] exp(m_j - m_fin)
  float* sp_s = reinterpret_cast<float*>(smem + lo.sp);          // [per][H] P scales
  float* lpart_s = reinterpret_cast<float*>(smem + lo.lpart);    // [per][H] sum(p) * w
  float* l_s = reinterpret_cast<float*>(smem + lo.lsum);
  float* mfin_s = reinterpret_cast<float*>(smem + lo.mfin);
  float* acc_s = reinterpret_cast<float*>(smem + lo.acc);
  float* tail_lg = reinterpret_cast<float*>(smem + lo.tail);  // [H][S + 1]
  float* tailp_s = reinterpret_cast<float*>(ring);  // the tail's p, once the ring is idle

  // ---- this CTA's tile jobs
  const int jb0 = rank * p.per;
  const int nmine = max(0, min(p.per, p.nblk - jb0));
  auto n_live = [&](int i) { return min(bw, p.length - (jb0 + i) * bw); };
  auto n_tiles = [&](int i) { return (n_live(i) + TK - 1) / TK; };
  int nK = 0;
  for (int i = 0; i < nmine; ++i) nK += n_tiles(i);
  const int njobs = 2 * nK;
  auto job = [&](int tj, int& i, int& tile) {
    int r = tj < nK ? tj : tj - nK;
    i = 0;
    while (r >= n_tiles(i)) r -= n_tiles(i++);
    tile = r;
  };
  const size_t lb = (size_t)p.layer * p.B + b;  // (layer, b)
  const __nv_bfloat16* sc_b = QUANT ? p.sc + lb * 2 * p.Ht * p.W : nullptr;
  const size_t slot = (size_t)p.L * p.B * 2 * Dt;  // one stage slot
  const __nv_bfloat16* pend_b = p.pend + lb * 2 * Dt;  // slot 0 (staged only)
  const int sh0 = hg0 * DH * ITEM / S;  // the group's first slab in a half row

  // the producer warp: copy job tj's tile into its stage as tensor-map
  // boxes (the cache rows, rows at and past length read as zeros; for a K
  // tile also the E rows and both scale halves, the value scales straight
  // into vsc_s), all completing on the stage's "full" barrier
  auto issue = [&](int tj) {
    if (tj >= njobs) return;
    int i, tile;
    job(tj, i, tile);
    const bool is_k = tj < nK;
    const int key0 = (jb0 + i) * bw + tile * TK;
    unsigned char* st = ring + (tj % p.ns) * lo.stage;
    uint64_t* bar = full + tj % p.ns;
    if (QUANT && is_k && !p.bulk_sc) {  // scale rows not 16-byte aligned: plain loads
      __nv_bfloat16* ks_dst = reinterpret_cast<__nv_bfloat16*>(st + lo.ks_at);
      __nv_bfloat16* vs_dst =
          reinterpret_cast<__nv_bfloat16*>(vsc_s + ((size_t)i * lo.tpb + tile) * lo.vpitch);
      for (int c = lane; c < 2 * H * TK; c += 32) {
        const int r = c / TK, k = c - r * TK;
        if (key0 + k < p.W)
          (r < H ? ks_dst : vs_dst)[(r % H) * TK + k] =
              sc_b[(size_t)(r < H ? hg0 + r : p.Ht + hg0 + r - H) * p.W + key0 + k];
      }
    }
    __syncwarp();
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const bool sc_tma = QUANT && is_k && p.bulk_sc;
      mbar_expect_tx(bar,
                     TK * D * ITEM + (is_k ? TK * DH * 2 : 0) + (sc_tma ? 2 * H * TK * 2 : 0));
      tma_load(st, &p.tmap, 0, key0, is_k ? sh0 : p.nsh_t + sh0, b, p.layer, bar);
      if (is_k) tma_load(st + lo.e_at, &p.emap, 0, key0, 0, 0, 0, bar);
      if (sc_tma) {  // key scales into the stage, value scales into vsc_s
        tma_load(st + lo.ks_at, &p.smap, key0, hg0, b, p.layer, 0, bar);
        tma_load(vsc_s + ((size_t)i * lo.tpb + tile) * lo.vpitch, &p.smap, key0, p.Ht + hg0, b,
                 p.layer, 0, bar);
      }
    }
  };

  // ---- q first (its latency overlaps the first tiles'): up to 4 heads a
  // warp (a group's D <= 1024 and dh >= 16), NE channels a lane
  constexpr int NE = (DH + 31) / 32;
  float qv[4][NE];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int h = warp + NW * k, c = lane + 32 * e;
      const size_t at = ((size_t)b * p.Ht + hg0 + h) * DH + c;
      qv[k][e] = h >= H || c >= DH ? 0.f
                 : p.q_bf16 ? bf2f(static_cast<const __nv_bfloat16*>(p.q)[at])
                            : static_cast<const float*>(p.q)[at];
    }
  if (tid == 0) {
    for (int s = 0; s < p.ns; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == PRODUCER)
    for (int tj = 0; tj < p.ns - 1; ++tj) issue(tj);
  if (warp == 1 && rank == 0 && p.pend != nullptr) {  // the tail's rows, into L2
    for (int s = lane; s < p.p_cnt; s += 32) prefetch_l2(pend_b + s * slot + hg0 * DH, D * 2);
    if (lane == 0) prefetch_l2(p.row + (size_t)b * 2 * Dt + hg0 * DH, D * 2);
  }

  // ---- bf16 cast and (int8 mode) per-head quantisation, one warp a head
  for (int i = D + tid; i < up(D, 32) + 32; i += NT) q8_s[i] = 0;
  for (int i = D + tid; i < D + 16; i += NT) qh_s[i] = __float2bfloat16(0.f);
  for (int i = tid; i < D; i += NT) acc_s[i] = 0.f;
  for (int i = tid; i < p.per * H; i += NT) bmax_s[i] = ordered(__float_as_int(NEG));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int h = warp + NW * k;
    if (h >= H) break;
    float qmax = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) qmax = fmaxf(qmax, fabsf(qv[k][e]));
    const float sq = warp_max(qmax) / 127.f + 1e-20f;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int c = lane + 32 * e;
      if (c < DH) {
        qh_s[h * DH + c] = __float2bfloat16(qv[k][e]);
        if (QUANT) q8_s[h * DH + c] = static_cast<int8_t>(rintf(qv[k][e] / sq));
      }
    }
    if (lane == 0) {
      sq_s[h] = sq;
      l_s[h] = 0.f;
      mfin_s[h] = NEG;
    }
  }
  // bit s of bm[par][w]: word w (0, or 16 bytes on) of score k-step s of a
  // unit of 4 heads at column 4 par of its 8 belongs to this lane's B column
  uint32_t bm[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int s = 0; s < 4 * DH / KS; ++s)
        bm[par][w] |= (uint32_t)(4 * par + (KS * s + w * KS / 2 + (4 / ITEM) * t) / DH == g) << s;

  // scores and bias of one K tile, and the block maxima. Unit u (one warp):
  // 16 keys (key group kg) by 4 heads (4 hq..4 hq + 3), over those heads'
  // channels, on the mma's 8 columns h8..h8 + 7 (the others zero); the
  // lanes whose t picks the unit's columns own its outputs.
  auto process_k = [&](int tj, int gw, int gsize) {  // warp gw of a group of gsize
    int i, tile;
    job(tj, i, tile);
    const int j = jb0 + i;
    const unsigned char* st = ring + (tj % p.ns) * lo.stage;
    const __nv_bfloat16* ks_st =
        reinterpret_cast<const __nv_bfloat16*>(st + lo.ks_at);
    float* lg_i = s_lg + (size_t)i * H * lsf;
    const int n_units = (TK / 16) * ((H + 3) / 4);
    for (int u = gw; u < n_units; u += gsize) {
      const int kg = u % (TK / 16), hq = u / (TK / 16), h4 = 4 * hq, h8 = h4 / 8 * 8;
      const int nh = min(4, H - h4), hn = h8 + g;  // hn: this lane's B column
      const bool col = hn >= h4 && hn < h4 + nh;
      const uint32_t m0 = col ? bm[hq & 1][0] : 0u, m1 = col ? bm[hq & 1][1] : 0u;
      const int r0 = kg * 16 + g, x_lo = h4 * DH * ITEM;  // A rows r0, r0 + 8; first byte
      const unsigned char* qb =
          (QUANT ? reinterpret_cast<const unsigned char*>(q8_s + h4 * DH)
                 : reinterpret_cast<const unsigned char*>(qh_s + h4 * DH)) + 4 * t;
      int ci[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};  // even and odd k-steps: two chains
      float cf[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      auto kstep = [&](int s, int chain) {
        const unsigned char* a0 = st + tile_at<S>(r0, x_lo + 32 * s + 4 * t);
        const unsigned char* a1 = st + tile_at<S>(r0, x_lo + 32 * s + 16 + 4 * t);
        const uint32_t a[4] = {ld32(a0), ld32(a0 + 8 * S), ld32(a1), ld32(a1 + 8 * S)};
        const uint32_t b0 = (m0 >> s) & 1 ? ld32(qb + 32 * s) : 0u;
        const uint32_t b1 = (m1 >> s) & 1 ? ld32(qb + 32 * s + 16) : 0u;
        if (QUANT) mma_s8(ci[chain], a, b0, b1);
        else mma_bf16(cf[chain], a, b0, b1);
      };
      if (nh == 4) {
#pragma unroll
        for (int s = 0; s < 4 * DH / KS; ++s) kstep(s, s & 1);
      } else {  // the last, partial set of heads
        for (int s = 0; s < (nh * DH + KS - 1) / KS; ++s) kstep(s, 0);
      }
      float s4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s4[e] = QUANT ? static_cast<float>(ci[0][e] + ci[1][e]) : cf[0][e] + cf[1][e];
      float bias[4] = {0.f, 0.f, 0.f, 0.f};  // E [keys x dh] . qh^T
      // E rows of dh * 2 bytes, swizzled as the copy engine writes them
      // where that is 32, 64 or 128 bytes (the same for rows r0 and r0 + 8)
      constexpr int EB = DH * 2, ELS = EB == 128 ? 7 : EB == 64 ? 6 : 5;
      const int ex = EB == 32 || EB == 64 || EB == 128 ? ((r0 >> (7 - ELS)) & (EB / 16 - 1)) << 4
                                                        : 0;  // 96, 192, 256: unswizzled
      const unsigned char* er = st + lo.e_at + r0 * EB;
      const unsigned char* qn =
          reinterpret_cast<const unsigned char*>(qh_s + (col ? hn : 0) * DH) + 4 * t;
#pragma unroll
      for (int kb = 0; kb < DH; kb += 16) {
        const int x0 = (kb * 2 + 4 * t) ^ ex, x1 = (kb * 2 + 16 + 4 * t) ^ ex;
        const uint32_t a[4] = {ld32(er + x0), ld32(er + 8 * EB + x0), ld32(er + x1),
                               ld32(er + 8 * EB + x1)};
        mma_bf16(bias, a, col ? ld32(qn + kb * 2) : 0u, col ? ld32(qn + kb * 2 + 16) : 0u);
      }
      // c[e]: key r0 + 8 (e >> 1), head h8 + 2t + (e & 1)
      float mx[2] = {NEG, NEG};
      const bool mine = 2 * t >= h4 - h8 && 2 * t < h4 - h8 + 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h8 + 2 * t + (e & 1), kk = r0 + 8 * (e >> 1), k = tile * TK + kk;
        if (mine && h < h4 + nh && k < bw) {
          float sc = s4[e];
          if (QUANT) sc = sc * sq_s[h] * bf2f(ks_st[h * TK + kk]);
          const float v = j * bw + k < p.length ? (sc + bias[e]) * p.scale : NEG;
          lg_i[h * lsf + k] = v;
          mx[e & 1] = fmaxf(mx[e & 1], v);
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // over g: the lanes of one t
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], o));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], o));
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = h8 + 2 * t + e;
        if (g == 0 && mine && h < h4 + nh)
          atomicMax(bmax_s + i * H + h, ordered(__float_as_int(mx[e])));
      }
    }
  };

  // P of block i, head h, in place of its logits: one warp, four keys a
  // lane. P overwrites the row's first bytes: each 128-key chunk is read
  // into registers before any lane writes, and earlier chunks are all read.
  auto make_p = [&](int i, int h) {
    const int n = n_live(i), nk = up(n, TK);
    const float mj = mj_s[i * H + h];
    float* lg = s_lg + ((size_t)i * H + h) * lsf;
    float psum = 0.f, s_p = 1.f;
    if (QUANT) {
      // the value scales of key k: tile k / TK, row h, column k % TK
      auto vs_at = [&](int k) {
        return reinterpret_cast<const uint2*>(vsc_s + ((size_t)i * lo.tpb + k / TK) * lo.vpitch +
                                              (h * TK + k % TK) * 2);
      };
      float pvmax = 0.f;
      float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f);  // the first chunk's pv, kept
      for (int k0 = 0; k0 < nk; k0 += 128) {  // pv = p * value scale
        const int k = k0 + 4 * lane;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        uint2 v2 = make_uint2(0u, 0u);
        if (k < n) {
          x = *reinterpret_cast<const float4*>(lg + k);
          v2 = *vs_at(k);
        }
        const float vsf[4] = {__uint_as_float(v2.x << 16), __uint_as_float(v2.x & 0xffff0000u),
                              __uint_as_float(v2.y << 16), __uint_as_float(v2.y & 0xffff0000u)};
        float* xs = reinterpret_cast<float*>(&x);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = k + e < n ? expf(xs[e] - mj) : 0.f;
          psum += pr;
          xs[e] = k + e < n ? pr * vsf[e] : 0.f;
          pvmax = fmaxf(pvmax, xs[e]);
        }
        if (k0 == 0) x0 = x;
        else if (k < nk) *reinterpret_cast<float4*>(lg + k) = x;
      }
      s_p = warp_max(pvmax) / 127.f + 1e-20f;
      __syncwarp();
      for (int k0 = 0; k0 < nk; k0 += 128) {
        const int k = k0 + 4 * lane;
        float4 x = x0;
        if (k0 > 0 && k < nk) x = *reinterpret_cast<const float4*>(lg + k);
        __syncwarp();
        if (k < nk) {
          const float* xs = reinterpret_cast<const float*>(&x);
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w |= (uint32_t)(uint8_t)static_cast<int8_t>(k + e < n ? rintf(xs[e] / s_p) : 0.f)
                 << (8 * e);
          *reinterpret_cast<uint32_t*>(reinterpret_cast<int8_t*>(lg) + k) = w;
        }
        __syncwarp();
      }
    } else {
      for (int k0 = 0; k0 < nk; k0 += 128) {
        const int k = k0 + 4 * lane;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < n) x = *reinterpret_cast<const float4*>(lg + k);
        __syncwarp();
        if (k < nk) {
          const float* xs = reinterpret_cast<const float*>(&x);
          float pr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pr[e] = k + e < n ? expf(xs[e] - mj) : 0.f;
            psum += pr[e];
          }
          const __nv_bfloat162 lo2 = __floats2bfloat162_rn(pr[0], pr[1]);
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(pr[2], pr[3]);
          uint2 w;
          w.x = *reinterpret_cast<const uint32_t*>(&lo2);
          w.y = *reinterpret_cast<const uint32_t*>(&hi2);
          *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(lg) + k) = w;
        }
        __syncwarp();
      }
    }
    psum = warp_sum(psum);
    if (lane == 0) {
      sp_s[i * H + h] = s_p;
      lpart_s[i * H + h] = psum * wj_s[i * H + h];
    }
  };

  // every CTA's block maxima -> prefix maxima m_j, the final max, the block
  // weights exp(m_j - m_fin) and P of every block; all warps, once, after
  // the K tiles (a warp a (block, head) pair)
  auto exchange = [&]() {
    cluster.sync();  // every CTA's block maxima are final
    for (int x = tid; x < p.nblk * H; x += NT) {
      const int jj = x / H, h = x - jj * H, owner = jj / p.per;
      allmax_s[x] = __int_as_float(
          ordered(cluster.map_shared_rank(bmax_s, owner)[(jj - owner * p.per) * H + h]));
    }
    __syncthreads();
    for (int h = tid; h < H; h += NT) {
      float run = NEG;
      for (int jj = 0; jj < p.nblk; ++jj) {
        run = fmaxf(run, allmax_s[jj * H + h]);
        if (jj >= jb0 && jj < jb0 + nmine) mj_s[(jj - jb0) * H + h] = run;
      }
      mfin_s[h] = run;
      for (int i = 0; i < nmine; ++i) wj_s[i * H + h] = expf(mj_s[i * H + h] - run);
    }
    __syncthreads();
    for (int u = warp; u < nmine * H; u += NW) make_p(u / H, u - u / H * H);
    __syncthreads();
  };

  // PV accumulators of this warp's 64-channel chunks: [slot][channel tile][fragment]
  int acc_i[MAX_SLOTS][4][4];
  float acc_f[MAX_SLOTS][4][4];
#pragma unroll
  for (int sl = 0; sl < MAX_SLOTS; ++sl)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_i[sl][c][e] = 0;
        acc_f[sl][c][e] = 0.f;
      }

  // PV of one V tile: each of the warp's 64-channel chunks against P^T (8
  // heads from the chunk's first); at the block's last tile each channel's
  // owner (the lane whose column is the channel's head) folds it into acc_s
  auto process_v = [&](int tj) {
    int i, tile;
    job(tj, i, tile);
    const bool last = tile == n_tiles(i) - 1;
    const unsigned char* st = ring + (tj % p.ns) * lo.stage;
    const unsigned char* pblk = reinterpret_cast<const unsigned char*>(s_lg + (size_t)i * H * lsf);
#pragma unroll
    for (int sl = 0; sl < MAX_SLOTS; ++sl) {
      const int cb = (warp + NC * sl) * CHUNK;
      if (cb >= D) continue;
      const int h0 = cb / DH, hb = h0 + g;  // hb: this lane's B column
      const unsigned char* prow = pblk + min(hb, H - 1) * lo.lstride;
      if (QUANT) {
        const int kk = tile * TK + t * 4;
        const uint32_t b0 = hb < H ? ld32(prow + kk) : 0u, b1 = hb < H ? ld32(prow + kk + 16) : 0u;
        // A = V^T: row g <-> channel cb + 4g + c, row g + 8 <-> cb + 32 + 4g + c;
        // key rows 4t + r (+ 16 for the upper half of k)
        uint32_t x[4][4];  // [k half * 2 + channel half][c]
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int o = tile_at<S>(t * 4 + r, cb + 32 * hf + 4 * g);
            x[hf][r] = ld32(st + o);
            x[2 + hf][r] = ld32(st + o + 16 * S);
          }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t w[4] = {x[q][0], x[q][1], x[q][2], x[q][3]};
          transpose4(w, x[q]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t a[4] = {x[0][c], x[1][c], x[2][c], x[3][c]};
          mma_s8(acc_i[sl][c], a, b0, b1);
        }
      } else {
        const int mi = lane >> 3, rr = lane & 7;  // ldmatrix: this lane's row address
        int la[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          la[c] = tile_at<S>(rr + (mi >> 1) * 8, (cb + c * 16 + (mi & 1) * 8) * 2);
#pragma unroll
        for (int ks = 0; ks < TK; ks += 16) {
          const int kk = (tile * TK + ks + t * 2) * 2;
          const uint32_t b0 = hb < H ? ld32(prow + kk) : 0u;
          const uint32_t b1 = hb < H ? ld32(prow + kk + 16) : 0u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            uint32_t a[4];
            ldsm_x4_trans(a, st + la[c] + ks * S);
            mma_bf16(acc_f[sl][c], a, b0, b1);
          }
        }
      }
      if (last) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ch = QUANT ? cb + (e >> 1) * 32 + 4 * g + c : cb + c * 16 + (e >> 1) * 8 + g;
            const int h = h0 + 2 * t + (e & 1);
            if (ch < D && ch / DH == h) {
              const float v = QUANT ? static_cast<float>(acc_i[sl][c][e]) * sp_s[i * H + h]
                                    : acc_f[sl][c][e];
              acc_s[ch] += v * wj_s[i * H + h];
            }
            acc_i[sl][c][e] = 0;
            acc_f[sl][c][e] = 0.f;
          }
      }
    }
  };

  const int np = p.p_cnt;
  const __nv_bfloat16* row = p.row + (size_t)b * 2 * Dt;
  __syncthreads();  // q is ready
  if (rank == 0 && p.pend != nullptr && warp < NC) {
    // the tail's logits, while the first tiles land: stage rows (a lane a
    // row) and the self term (row_t, bias row e_pend[p_cnt])
    for (int h = warp; h < H; h += NC) {
      const __nv_bfloat16* qh = qh_s + h * DH;
      for (int s = lane; s < np; s += 32)
        tail_lg[h * (p.S + 1) + s] = (dot_bf16<DH>(pend_b + s * slot + (hg0 + h) * DH, qh) +
                                      dot_bf16<DH>(p.e_pend + (size_t)s * DH, qh)) * p.scale;
      float qk = 0.f, qe = 0.f;
      for (int c = lane; c < DH; c += 32) {
        qk += bf2f(qh[c]) * bf2f(row[(hg0 + h) * DH + c]);
        qe += bf2f(qh[c]) * bf2f(p.e_pend[(size_t)np * DH + c]);
      }
      qk = warp_sum(qk);
      qe = warp_sum(qe);
      if (lane == 0) tail_lg[h * (p.S + 1) + p.S] = (qk + qe) * p.scale;
    }
  }

  // ---- the pipeline. The producer warp issues each job once its stage's
  // previous job is released; consumer warps take the K tiles in two groups
  // (warps 0-7 the even tiles, 8..NC-1 the odd ones, so two tiles are in
  // work at once), then every V tile, and release each stage as they leave it.
  if (warp == PRODUCER) {
    auto produce = [&](int tj) {
      if (tj >= p.ns) mbar_wait(empty + tj % p.ns, (tj / p.ns - 1) & 1);
      issue(tj);
    };
    int tj = p.ns - 1;
    for (; tj < min(njobs, nK + p.ns - 1); ++tj) produce(tj);  // needs only K releases
    if (nK > 0) exchange();
    for (; tj < njobs; ++tj) produce(tj);
  } else {
    const int grp = warp < 8 ? 0 : 1, gw = warp - 8 * grp, gsize = grp ? NC - 8 : 8;
    for (int tj = 0; tj < njobs; ++tj) {
      if (tj == nK) exchange();
      // every consumer waits for every tile, so that its release of the
      // stage below cannot count toward the stage's previous job
      mbar_wait(full + tj % p.ns, (tj / p.ns) & 1);
      if (tj >= nK) process_v(tj);
      else if ((tj & 1) == grp) process_k(tj, gw, gsize);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + tj % p.ns);
    }
  }
  __syncthreads();
  for (int h = tid; h < H; h += NT) {
    float s = 0.f;
    for (int i = 0; i < nmine; ++i) s += lpart_s[i * H + h];
    l_s[h] = s;
  }
  __syncthreads();

  if (p.nblk > 0) {
    cluster.sync();  // every CTA's partial (acc, l) is final
    if (rank == 0) {  // fixed order: rank 0, 1, ...
      for (int c = tid; c < D; c += NT) {
        float s = acc_s[c];
        for (int r = 1; r < n_cta; ++r) s += cluster.map_shared_rank(acc_s, r)[c];
        acc_s[c] = s;
      }
      for (int h = tid; h < H; h += NT) {
        float s = l_s[h];
        for (int r = 1; r < n_cta; ++r) s += cluster.map_shared_rank(l_s, r)[h];
        l_s[h] = s;
      }
    }
    cluster.sync();  // the other CTAs keep their shared memory until read
    if (rank != 0) return;
  }
  __syncthreads();

  if (p.pend == nullptr) {
    for (int c = tid; c < D; c += NT) p.acc[(size_t)b * Dt + hg0 * DH + c] = acc_s[c];
    for (int h = tid; h < H; h += NT) {
      p.m[(size_t)b * p.Ht + hg0 + h] = mfin_s[h];
      p.l[(size_t)b * p.Ht + hg0 + h] = l_s[h];
    }
    return;
  }

  // ---- the staged tail (rows 0..p_cnt-1 of this layer's stage, bf16), the
  // self term and the normalisation: one warp a head ----
  float* tp = tailp_s + warp * MAX_STAGE;
  for (int h = warp; h < H; h += NW) {
    const float* tl = tail_lg + h * (p.S + 1);
    float lg[MAX_STAGE / 32];
    float mt = NEG;
#pragma unroll
    for (int u = 0; u < MAX_STAGE / 32; ++u) {
      const int s = lane + 32 * u;
      lg[u] = s < np ? tl[s] : NEG;
      mt = fmaxf(mt, lg[u]);
    }
    const float m = mfin_s[h];
    const float m_new = fmaxf(m, warp_max(mt));
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_STAGE / 32; ++u) {
      const int s = lane + 32 * u;
      const float pr = s < np ? expf(lg[u] - m_new) : 0.f;
      ps += pr;
      tp[s] = bf_round(pr);
    }
    const float l = l_s[h] * alpha + warp_sum(ps);
    __syncwarp();
    const float logit_s = tl[p.S];
    const float m_fin = fmaxf(m_new, logit_s);
    const float a_old = expf(m_new - m_fin), a_new = expf(logit_s - m_fin);
    const float denom = l * a_old + a_new;
    for (int c = lane; c < DH; c += 32) {
      float res = 0.f;
#pragma unroll 4
      for (int s = 0; s < np; ++s)
        res = fmaf(tp[s], bf2f(pend_b[s * slot + Dt + (hg0 + h) * DH + c]), res);
      const float a = acc_s[h * DH + c] * alpha + res;
      p.out[(size_t)b * Dt + (hg0 + h) * DH + c] =
          __float2bfloat16((a * a_old + bf2f(row[Dt + (hg0 + h) * DH + c]) * a_new) / denom);
    }
    __syncwarp();  // tp is the next head's
  }

  // ---- append the current row at stage slot p_cnt: one writer per b (head
  // group 0 writes the whole row). The slot is never read above (rows >=
  // p_cnt are not live). ----
  if (np < p.S && blockIdx.z == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
    uint4* dst = reinterpret_cast<uint4*>(p.pend + (size_t)np * slot + lb * 2 * Dt);
    for (int i = tid; i < 2 * Dt * 2 / 16; i += NT) dst[i] = src[i];
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (the build links no -lcuda)
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The call's tensor maps. kv: the cache rows as a 5-D map over
// [L][B][length][2D / S][S bytes], S = 128 (swizzled) where it divides a
// half row, else 16; rows at and past length read as zeros, so dead keys
// add nothing to PV; a box is one tile's half rows, laid out [slab][row][S
// bytes]: the row is the faster index, so a fragment's eight rows fall in
// eight distinct 16-byte units. e_rows: [W][dh], a box of TK rows, swizzled
// at its row's width where that is 32, 64 or 128 bytes. sc (int8, rows of
// 16-byte multiples): [L][B][2H][W], a box of H rows of TK keys.
cudaError_t encode_maps(Params& p, int dh, bool quant) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int item = quant ? 1 : 2, half = p.H * dh * item, half_t = p.Ht * dh * item;
  const int slab = half % 128 == 0 ? 128 : 16;
  p.nsh = half / slab;
  p.nsh_t = half_t / slab;
  const cuuint64_t row = 2 * (cuuint64_t)half_t, elems = slab / item;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  auto swizzle = [](int bytes) {
    return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
           : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
           : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                         : CU_TENSOR_MAP_SWIZZLE_NONE;
  };
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t kv_dims[5] = {elems, (cuuint64_t)p.length, 2 * (cuuint64_t)p.nsh_t,
                                 (cuuint64_t)p.B, (cuuint64_t)p.L};
  const cuuint64_t kv_strides[4] = {row, (cuuint64_t)slab, p.W * row, p.B * p.W * row};
  const cuuint32_t kv_box[5] = {(cuuint32_t)elems, TK, (cuuint32_t)p.nsh, 1, 1};
  CUresult r = encode(&p.tmap, quant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : bf16, 5,
                      const_cast<void*>(p.kv), kv_dims, kv_strides, kv_box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(slab),
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  // every map has 5 dimensions (trailing ones of extent 1), for one copy
  // instruction
  const cuuint64_t e_row = (cuuint64_t)dh * 2, e_all = e_row * p.W;
  const cuuint64_t e_dims[5] = {(cuuint64_t)dh, (cuuint64_t)p.W, 1, 1, 1};
  const cuuint64_t e_strides[4] = {e_row, e_all, e_all, e_all};
  const cuuint32_t e_box[5] = {(cuuint32_t)dh, TK, 1, 1, 1};
  r = encode(&p.emap, bf16, 5, const_cast<__nv_bfloat16*>(p.e_rows), e_dims, e_strides, e_box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(dh * 2),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  p.bulk_sc = quant && p.W % 8 == 0;
  if (!p.bulk_sc) return cudaSuccess;
  const cuuint64_t s_row = (cuuint64_t)p.W * 2, s_b = s_row * 2 * p.Ht, s_l = s_b * p.B;
  const cuuint64_t s_dims[5] = {(cuuint64_t)p.W, 2 * (cuuint64_t)p.Ht, (cuuint64_t)p.B,
                                (cuuint64_t)p.L, 1};
  const cuuint64_t s_strides[4] = {s_row, s_b, s_l, s_l * p.L};
  const cuuint32_t s_box[5] = {TK, (cuuint32_t)p.H, 1, 1, 1};
  r = encode(&p.smap, bf16, 5, const_cast<__nv_bfloat16*>(p.sc), s_dims, s_strides, s_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH, bool QUANT, int S>
cudaError_t launch(Params p, cudaStream_t stream) {
  p.nblk = (p.length + p.bw - 1) / p.bw;
  // about one CTA an SM over the batch: the cluster size the SMs allow per
  // batch row, grown where a CTA's blocks do not fit its shared memory
  const int groups = p.Ht / p.H;
  int want = max(1, min(MAX_CLUSTER, sm_count() / (p.B * groups)));
  Layout lo;
  for (;;) {
    p.per = p.nblk ? (p.nblk + want - 1) / want : 1;
    for (p.ns = NS_MAX; p.ns >= 2; --p.ns) {
      lo = layout(p.H, DH, p.bw, p.per, p.ns, p.S, QUANT);
      if (lo.total <= SMEM_MAX) break;
    }
    if (lo.total <= SMEM_MAX) break;
    if (want == MAX_CLUSTER || p.per == 1) return cudaErrorInvalidValue;
    ++want;
  }
  cudaError_t err = cudaSuccess;
  if (p.nblk > 0 && (err = encode_maps(p, DH, QUANT)) != cudaSuccess) return err;
  const int n_cta = p.nblk ? (p.nblk + p.per - 1) / p.per : 1;
  auto kernel = decode_attn_stacked_kernel<DH, QUANT, S>;
  static bool smem_set[64] = {};  // per device: this instantiation may use SMEM_MAX
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_cta, p.B, groups);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = lo.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool QUANT, int S>
cudaError_t dispatch_dh(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<16, QUANT, S>(p, stream);
    case 32: return launch<32, QUANT, S>(p, stream);
    case 48: return launch<48, QUANT, S>(p, stream);
    case 64: return launch<64, QUANT, S>(p, stream);
    case 96: return launch<96, QUANT, S>(p, stream);
    case 128: return launch<128, QUANT, S>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the tile layout's slab: 128 swizzled bytes where they divide a half row
template <bool QUANT>
cudaError_t dispatch(const Params& p, int dh, cudaStream_t stream) {
  return p.H * dh * (QUANT ? 1 : 2) % 128 == 0 ? dispatch_dh<QUANT, 128>(p, dh, stream)
                                                : dispatch_dh<QUANT, 16>(p, dh, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. quant: 1 = int8
// cache (sc required), 0 = bf16 cache. q_bf16: q is bf16, else f32. Staged
// when pend is not null (then e_pend, row and out are required), else acc,
// m and l are. scale multiplies the logits: 1/sqrt(d_head). Launches on
// `stream` and does not synchronise.
int decode_attn_stacked(const void* q, const void* kv, const void* sc, const void* e_rows,
                        void* pend, const void* e_pend, const void* row, void* acc, void* m,
                        void* l, void* out, int L, int B, int W, int H, int dh, int layer,
                        int length, int S, int p_cnt, int bw, int quant, int q_bf16, float scale,
                        void* stream) {
  if (L <= 0 || B <= 0 || W <= 0 || H <= 0 || dh <= 0 || dh > MAX_D || layer < 0 ||
      layer >= L || length < 0 || length > W || bw <= 0 || W % bw != 0 || q == nullptr ||
      kv == nullptr || e_rows == nullptr)
    return cudaErrorInvalidValue;
  if (quant && sc == nullptr) return cudaErrorInvalidValue;
  if (pend != nullptr) {
    if (S < 1 || S > MAX_STAGE || p_cnt < 0 || p_cnt > S || e_pend == nullptr ||
        row == nullptr || out == nullptr)
      return cudaErrorInvalidValue;
  } else if (acc == nullptr || m == nullptr || l == nullptr) {
    return cudaErrorInvalidValue;
  }
  Params p = {};
  p.q = q;
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
  p.Ht = H;
  p.H = 1;  // the head group: the most heads, dividing H, within MAX_D channels
  for (int hg = H; hg >= 1; --hg)
    if (H % hg == 0 && hg * dh <= MAX_D) {
      p.H = hg;
      break;
    }
  p.layer = layer;
  p.length = length;
  p.S = S;
  p.p_cnt = p_cnt;
  p.bw = bw;
  p.q_bf16 = q_bf16;
  p.scale = scale;  // the caller's 1/sqrt(d_head), the twin's f32 constant
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quant ? dispatch<true>(p, dh, s) : dispatch<false>(p, dh, s);
}

const char* decode_attn_stacked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
