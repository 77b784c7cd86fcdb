// What the port's field kernels share: the packed, frame-folded field
// (ops/pack.py), its weight and bias blob layout, and the small helpers
// around mma.sync (the narrow sigma and rgb heads).
//
//   torso: deform MLP 64 -> 128 (x4, PE skip at block 2) -> + sig_pad + pe
//          -> trunk;  head: trunk on the PE directly;
//   trunk: input layer + 7 relu blocks of 256, PE skip after block 3, fused
//          256 -> 384 output (sigma col 0, view feature cols 128:384);
//   colour: sigmoid(W_out . relu(feature + view_bias)), only cols 0:3.
//
// The device core over it is field_wgmma.cuh (wgmma, weights through a
// shared-memory ring), included by every kernel source; they are built with
// --fmad=false (see render_rays.cu): the PE argument reaches ~500 rad.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int RT = 256;    // rays per tile
constexpr int SS = 8;      // samples per slab
constexpr int M = 128;     // rows per chunk
constexpr int HID = 256;   // trunk width
constexpr int DEF = 128;   // block-diagonal deform width
constexpr int PEW = 64;    // padded PE width
constexpr int LDH = HID + 8;  // row stride (elements) of the activation buffers
constexpr int LDP = DEF + 8;  // row stride of the PE / deformed-input buffer

// Weight blob (bf16, every matrix stored [out][in]), per field:
//   w_in [256][KIN], w_blocks 7 x [256][256], w_skip [256][KIN],
//   w_sf [384][256], w_out rows 0:8 [8][256];
// the torso (KIN = 128) appends d_w1 [128][64], d_wk 4 x [128][128],
//   d_wskip [128][64], d_wout [128][128].
template <int KIN>
struct WOff {
  static constexpr int IN = 0;
  static constexpr int BLK = IN + HID * KIN;
  static constexpr int SKIP = BLK + 7 * HID * HID;
  static constexpr int SF = SKIP + HID * KIN;
  static constexpr int OUT = SF + 384 * HID;
  static constexpr int END = OUT + 8 * HID;
};
constexpr int D_W1 = WOff<DEF>::END;
constexpr int D_WK = D_W1 + DEF * PEW;
constexpr int D_WSKIP = D_WK + 4 * DEF * DEF;
constexpr int D_WOUT = D_WSKIP + DEF * PEW;
constexpr int TORSO_WEND = D_WOUT + DEF * DEF;

// Bias blob (fp32), per field: b_in 256, b_blocks 7 x 256, b_skip 256,
// b_sf 384, b_out 8; the torso appends d_b1 128, d_bk 4 x 128, d_bskip 128,
// d_bout 128, sig_pad 128.
constexpr int B_IN = 0;
constexpr int B_BLK = B_IN + HID;
constexpr int B_SKIP = B_BLK + 7 * HID;
constexpr int B_SF = B_SKIP + HID;
constexpr int B_OUT = B_SF + 384;
constexpr int B_END = B_OUT + 8;
constexpr int DB_1 = B_END;
constexpr int DB_K = DB_1 + DEF;
constexpr int DB_SKIP = DB_K + 4 * DEF;
constexpr int DB_OUT = DB_SKIP + DEF;
constexpr int SIG_PAD = DB_OUT + DEF;
constexpr int TORSO_BEND = SIG_PAD + DEF;

enum { RELU = 0, SKIP = 1, VIEW = 2, DEFORM_OUT = 3 };

__device__ __forceinline__ uint32_t ldg_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's 16 rows x 8 columns of A[., 0:256] . W[0:8, 0:256]^T (the sigma
// column of w_sf, or the rgb columns of w_out).
__device__ __forceinline__ void narrow8(float (&d)[4], const bf16* A, const bf16* W, int warp,
                                        int lane) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  const bf16* wrow = W + (lane >> 2) * HID + (lane & 3) * 2;
  const bf16* arow = A + (warp * 16 + (lane & 15)) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < HID / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, arow + ks * 16);
    const uint32_t b0 = ldg_pair(wrow + ks * 16), b1 = ldg_pair(wrow + ks * 16 + 8);
    mma_bf16(d, a, b0, b1);
  }
}

__device__ __forceinline__ float density_act(float x, int softplus) {
  return softplus ? fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) : fmaxf(x, 0.f);
}

}  // namespace
