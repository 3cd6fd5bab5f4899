// The bf16 score tiers on Hopper's tensor cores, shared by ncc_mega.cu (K1-K3)
// and ncc_pallas.cu (K4, K5): the counterpart of the TPU kernels' MXU passes
// (pvot/ops/ncc_mega.py:384-440 `_shear_score_tiles`, pvot/ops/ncc_pallas.py
// :63-87 `_dot_hl3`).  A value v is held as one 32-bit slot: hi = bf16_rn(v)
// in the low half, lo = bf16_rn(v - hi) in the high half, so the hi/lo rows
// take the bytes of the float32 rows they replace.  With passes p, one
// template row's correlation is corr(hi w, hi t) (p >= 1) + corr(hi w, lo t)
// (p >= 2) + corr(lo w, hi t) (p == 3): bf16 products are exact in float32,
// and the sums run in float32 on the tensor cores.
//
// Both kernels tile the output in 8 x 16 tiles and give each warp a share of
// the template rows; row_mma computes one template row's contribution to a
// whole tile with warp-level mma.sync.m16n8k16 (bf16 in, float32 out).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pvot_tiers {

__device__ __forceinline__ uint32_t split_pack(float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const __nv_bfloat16 lo = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  return static_cast<uint32_t>(__bfloat16_as_ushort(hi)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(lo)) << 16);
}

// The hi (low halves) or lo (high halves) of two slots as one bf16x2
// operand register, x's value in the low half.
__device__ __forceinline__ uint32_t hi_pair(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x5410);
}
__device__ __forceinline__ uint32_t lo_pair(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x7632);
}

// c += A (16 x 16, row-major fragment a0..a3) * B (16 x 8, col-major b0, b1):
// bf16 products, float32 sums, one warp-wide tensor-core instruction.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One template row's correlation for a whole 8 x 16 output tile by one warp,
// in ks = ceil((tw + 7) / 16) tensor-core steps a pass.  in_row: the tile's
// window row for output row 0 and this template row (rows in_w slots
// apart, in_wl of them staged); t_row: the template row's slots.  Rows of
// the 16 x 16 A operand are (output row y, column group cg): A[y + 8 cg][k]
// = w[y][8 cg + 16 s + k]; B is the row's Toeplitz band, B[k][n] = t[16 s +
// k - n], 0 outside [0, tw); so C[y + 8 cg][n] is output (y, 8 cg + n).  A
// thread ends with outputs (g, 2q), (g, 2q + 1), (g, 8 + 2q), (g, 9 + 2q) in
// c[0..3], g = lane / 4, q = lane % 4 (`tile_output`).  Window columns at or
// past in_wl multiply only zero taps and read 0.  The fragment starts from 0
// for each row: the caller adds it to its float32 sums with one
// round-to-nearest addition per row, so the tensor core's own accumulation,
// which is not round-to-nearest float32, never spans more than one row's
// taps.
template <int kPasses>
__device__ __forceinline__ void row_mma(float (&c)[4], const uint32_t* in_row,
                                        const uint32_t* t_row, int in_w, int in_wl, int tw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const uint32_t* w_row = in_row + g * in_w;
  const int ks = (tw + 22) / 16;
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  for (int s = 0; s < ks; ++s) {
    const int col = 16 * s + 2 * q;
    const uint2 z = make_uint2(0u, 0u);
    const uint2 w0 = col < in_wl ? *reinterpret_cast<const uint2*>(w_row + col) : z;
    const uint2 w1 = col + 8 < in_wl ? *reinterpret_cast<const uint2*>(w_row + col + 8) : z;
    const uint2 w2 = col + 16 < in_wl ? *reinterpret_cast<const uint2*>(w_row + col + 16) : z;
    const int j = col - g;  // the template column of b0's first tap
    // 0 <= tap < tw as one unsigned comparison.
    const uint32_t t0 = static_cast<unsigned>(j) < static_cast<unsigned>(tw) ? t_row[j] : 0u;
    const uint32_t t1 =
        static_cast<unsigned>(j + 1) < static_cast<unsigned>(tw) ? t_row[j + 1] : 0u;
    const uint32_t t2 =
        static_cast<unsigned>(j + 8) < static_cast<unsigned>(tw) ? t_row[j + 8] : 0u;
    const uint32_t t3 =
        static_cast<unsigned>(j + 9) < static_cast<unsigned>(tw) ? t_row[j + 9] : 0u;
    // A's registers: (row g, k 2q) at col, (row g + 8, k 2q) and (row g, k
    // 2q + 8) both at col + 8, (row g + 8, k 2q + 8) at col + 16.
    const uint32_t ah0 = hi_pair(w0.x, w0.y), ah1 = hi_pair(w1.x, w1.y),
                   ah3 = hi_pair(w2.x, w2.y);
    const uint32_t bh0 = hi_pair(t0, t1), bh1 = hi_pair(t2, t3);
    mma_bf16(c, ah0, ah1, ah1, ah3, bh0, bh1);  // hi w * hi t
    if (kPasses >= 2) mma_bf16(c, ah0, ah1, ah1, ah3, lo_pair(t0, t1), lo_pair(t2, t3));
    if (kPasses == 3) {
      const uint32_t al1 = lo_pair(w1.x, w1.y);
      mma_bf16(c, lo_pair(w0.x, w0.y), al1, al1, lo_pair(w2.x, w2.y), bh0, bh1);  // lo w * hi t
    }
  }
}

// The tile output (row * 16 + column) that row_mma leaves in c[k] of lane.
__device__ __forceinline__ int tile_output(int lane, int k) {
  return (lane >> 2) * 16 + 2 * (lane & 3) + (k < 2 ? k : 6 + k);
}

// Staged float32 window rows (in_rows x in_wl of them, rows in_w apart), in
// place, as hi/lo slots: a warp a row at a time, a lane a column.
__device__ __forceinline__ void split_rows_in_place(float* s_in, int in_rows, int in_wl,
                                                    int in_w) {
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < in_rows; r += n_warps) {
    float* row = s_in + r * in_w;
    for (int c = lane; c < in_wl; c += 32) {
      *reinterpret_cast<uint32_t*>(row + c) = split_pack(row[c]);
    }
  }
}

}  // namespace pvot_tiers
