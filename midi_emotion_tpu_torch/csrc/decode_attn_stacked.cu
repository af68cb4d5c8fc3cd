// Kernel 13 at the head widths of flash_attention.KERNEL_DHS (d_head 16 to
// 256): the instantiations of decode_attn_stacked.cuh's kernel and the C
// entry point. The design is described in that header.

#include "decode_attn_stacked.cuh"

namespace {

template <bool QUANT, int S>
cudaError_t dispatch_dh(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<16, QUANT, S>(p, stream);
    case 32: return launch<32, QUANT, S>(p, stream);
    case 48: return launch<48, QUANT, S>(p, stream);
    case 64: return launch<64, QUANT, S>(p, stream);
    case 96: return launch<96, QUANT, S>(p, stream);
    case 128: return launch<128, QUANT, S>(p, stream);
    case 192: return launch<192, QUANT, S>(p, stream);
    case 256: return launch<256, QUANT, S>(p, stream);
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
  Params p = {};
  const cudaError_t err = make_params(p, q, kv, sc, e_rows, pend, e_pend, row, acc, m, l, out, L,
                                      B, W, H, dh, layer, length, S, p_cnt, bw, quant, q_bf16,
                                      scale);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quant ? dispatch<true>(p, dh, s) : dispatch<false>(p, dh, s);
}

const char* decode_attn_stacked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
