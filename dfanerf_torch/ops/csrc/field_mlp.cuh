// The mma.sync device core of the port's far-plane kernels (far_eval.cu:
// far_head, far_torso, far_joint): one packed, frame-folded field
// (ops/pack.py, layout in field_common.cuh) evaluated over a chunk of 128
// rows by a block of 8 warps. Every other field kernel (render_rays.cu,
// pair_field.cu, render_head.cu, pair_perz.cu, sigma_head.cu, pair_hier.cu)
// runs the wgmma core instead (field_wgmma.cuh).
//
// Matrix products are mma.sync m16n8k16 bf16 x bf16 -> fp32. Each warp owns
// 32 output columns (16 in the 128-wide deform net) for all 128 rows; A
// fragments come from shared memory through ldmatrix, B fragments straight
// from global memory (L2-resident weights, stored [out][in] so a fragment
// pair is one 32-bit load), prefetched one k-step ahead. Activations are
// rounded to bf16 exactly where the TPU kernels round them; sigma and the
// colour sigmoid stay fp32.
//
// Ragged row counts: encode and the colour head take a GUARD template flag;
// with it, rows at or past n_rows read no input (their PE is zero and their
// view bias zero) and the caller writes none of their outputs. Without it
// the code is the same as before the flag existed.

#pragma once

#include "field_common.cuh"

namespace {

constexpr int NTHR = 256;  // threads per block (8 warps)

// Shared memory of the field (bytes): two ping-pong [128 x 256] bf16
// activation buffers X, Y and the PE / deformed-input buffer P.
constexpr int SM_X = 0;
constexpr int SM_Y = SM_X + M * LDH * 2;
constexpr int SM_P = SM_Y + M * LDH * 2;
constexpr int SM_FIELD_END = SM_P + M * LDP * 2;

// acc[mt][nt] += A[0:128, 0:K] . W[n0 + 8 nt + (0:8), 0:K]^T for the calling
// warp: A in shared memory (row stride lda), W in global memory [N][K].
template <int K, int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[8][NT][4], const bf16* A, int lda,
                                          const bf16* W, int n0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const bf16* wrow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) wrow[nt] = W + (n0 + nt * 8 + g) * K + q * 2;
  const bf16* arow = A + (lane & 15) * lda + (lane >> 4) * 8;
  uint32_t b[2][NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    b[0][nt][0] = ldg_pair(wrow[nt]);
    b[0][nt][1] = ldg_pair(wrow[nt] + 8);
  }
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    const int cur = ks & 1;
    if (ks + 1 < K / 16) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[cur ^ 1][nt][0] = ldg_pair(wrow[nt] + (ks + 1) * 16);
        b[cur ^ 1][nt][1] = ldg_pair(wrow[nt] + (ks + 1) * 16 + 8);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + mt * 16 * lda + ks * 16);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[cur][nt][0], b[cur][nt][1]);
    }
  }
}

// One dense layer over the chunk's 128 rows; the warp owns NT x 8 output
// columns. MODE picks the epilogue:
//   RELU:       out = bf16(relu(A W^T + b))
//   SKIP:       out = bf16(relu(A W^T + b) + P Wp^T + bp)      (trunk block 3,
//               deform block 2; P has KP columns)
//   VIEW:       out = bf16(relu((A W^T + b) + vr[ray]))        (view feature;
//               with GUARD, rays at or past n_rows read a zero view bias)
//   DEFORM_OUT: out = bf16(((A W^T + b) + bp) + pe)  written in place over
//               the PE buffer `out` (pe = 0 beyond column 64; bp = sig_pad)
template <int K, int NT, int MODE, int KP, bool GUARD = false>
__device__ __forceinline__ void layer(const bf16* A, int lda, const bf16* W, const float* bias,
                                      bf16* out, int ldo, const bf16* P, const bf16* Wp,
                                      const float* bp, const bf16* vr, int ray0, int warp,
                                      int lane, int n_rows = 0) {
  float acc[8][NT][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int n0 = warp * NT * 8, g = lane >> 2, q = lane & 3;
  warp_gemm<K, NT>(acc, A, lda, W, n0, lane);
  if (MODE == SKIP) {
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] = fmaxf(acc[mt][nt][i] + bias[n0 + nt * 8 + q * 2 + (i & 1)], 0.f);
    warp_gemm<KP, NT>(acc, P, LDP, Wp, n0, lane);
  }
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + nt * 8 + q * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + g + h * 8;
        float x0 = acc[mt][nt][2 * h], x1 = acc[mt][nt][2 * h + 1];
        bf16* dst = out + row * ldo + col;
        if (MODE == RELU) {
          x0 = fmaxf(x0 + bias[col], 0.f);
          x1 = fmaxf(x1 + bias[col + 1], 0.f);
        } else if (MODE == SKIP) {
          x0 = x0 + bp[col];
          x1 = x1 + bp[col + 1];
        } else if (MODE == VIEW) {
          float2 v = make_float2(0.f, 0.f);
          if (!GUARD || ray0 + row < n_rows)
            v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(vr + (ray0 + row) * HID + col));
          x0 = fmaxf((x0 + bias[col]) + v.x, 0.f);
          x1 = fmaxf((x1 + bias[col + 1]) + v.y, 0.f);
        } else {  // DEFORM_OUT
          float p0 = 0.f, p1 = 0.f;
          if (col < PEW) {
            const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
            p0 = v.x;
            p1 = v.y;
          }
          x0 = ((x0 + bias[col]) + bp[col]) + p0;
          x1 = ((x1 + bias[col + 1]) + bp[col + 1]) + p1;
        }
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// sin((o + d z) * freq + phase) for the chunk's 128 rays in the 64 PE slots
// (slot c reads coordinate c % 3; slots 60:64 are zero), rounded to bf16.
// With GUARD, rays at or past n_rows are encoded as zeros.
template <bool GUARD = false>
__device__ __forceinline__ void encode(bf16* P, const float* o, const float* d, float zs,
                                       const float* freq, const float* phase, int ray0,
                                       int tid, int n_rows = 0) {
  for (int idx = tid; idx < M * PEW; idx += NTHR) {
    const int row = idx >> 6, c = idx & (PEW - 1);
    float v = 0.f;
    if (c < 60 && (!GUARD || ray0 + row < n_rows)) {
      const int k = (ray0 + row) * 3 + c % 3;
      const float pts = o[k] + d[k] * zs;
      const float arg = pts * freq[c] + phase[c];
      v = sinf(arg);
    }
    P[row * LDP + c] = __float2bfloat16_rn(v);
  }
}

// The torso's deformation net over the chunk: PE in P -> p' = deform + sig_pad
// + pe, written over P (bf16). Uses X and Y as scratch; ends with a barrier.
__device__ __forceinline__ void deform(bf16* X, bf16* Y, bf16* P, const bf16* w, const float* b,
                                       int warp, int lane) {
  const bf16* nul = nullptr;
  layer<PEW, 2, RELU, 16>(P, LDP, w + D_W1, b + DB_1, X, LDH, nul, nul, nullptr, nul, 0, warp,
                          lane);
  __syncthreads();
  layer<DEF, 2, RELU, 16>(X, LDH, w + D_WK, b + DB_K, Y, LDH, nul, nul, nullptr, nul, 0, warp,
                          lane);
  __syncthreads();
  layer<DEF, 2, RELU, 16>(Y, LDH, w + D_WK + DEF * DEF, b + DB_K + DEF, X, LDH, nul, nul, nullptr,
                          nul, 0, warp, lane);
  __syncthreads();
  layer<DEF, 2, SKIP, PEW>(X, LDH, w + D_WK + 2 * DEF * DEF, b + DB_K + 2 * DEF, Y, LDH, P,
                           w + D_WSKIP, b + DB_SKIP, nul, 0, warp, lane);
  __syncthreads();
  layer<DEF, 2, RELU, 16>(Y, LDH, w + D_WK + 3 * DEF * DEF, b + DB_K + 3 * DEF, X, LDH, nul, nul,
                          nullptr, nul, 0, warp, lane);
  __syncthreads();
  layer<DEF, 2, DEFORM_OUT, 16>(X, LDH, w + D_WOUT, b + DB_OUT, P, LDP, nul, nul, b + SIG_PAD,
                                nul, 0, warp, lane);
  __syncthreads();
}

// The trunk over the chunk: input (P) -> input layer -> 7 blocks. Returns
// the buffer holding its output h (Y) and sets `spare` to the other (X).
template <int KIN>
__device__ __forceinline__ bf16* trunk(bf16* X, bf16* Y, bf16* P, const bf16* w, const float* b,
                                       int warp, int lane, bf16*& spare) {
  typedef WOff<KIN> O;
  const bf16* nul = nullptr;
  layer<KIN, 4, RELU, 16>(P, LDP, w + O::IN, b + B_IN, X, LDH, nul, nul, nullptr, nul, 0, warp, lane);
  __syncthreads();
  bf16* src = X;
  bf16* dst = Y;
#pragma unroll 1
  for (int i = 0; i < 7; ++i) {
    if (i == 3) {
      layer<HID, 4, SKIP, KIN>(src, LDH, w + O::BLK + i * HID * HID, b + B_BLK + i * HID, dst,
                               LDH, P, w + O::SKIP, b + B_SKIP, nul, 0, warp, lane);
    } else {
      layer<HID, 4, RELU, 16>(src, LDH, w + O::BLK + i * HID * HID, b + B_BLK + i * HID, dst,
                              LDH, nul, nul, nullptr, nul, 0, warp, lane);
    }
    __syncthreads();
    bf16* t = src;
    src = dst;
    dst = t;
  }
  spare = dst;
  return src;
}

// sigma [M] = density_act(h . w_sf[:, 0] + b_sf[0]) from the trunk output h.
template <int KIN>
__device__ __forceinline__ void sigma_head(const bf16* h, const bf16* w, const float* b,
                                           int softplus, float* sig, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  float d[4];
  narrow8(d, h, w + WOff<KIN>::SF, warp, lane);
  if (q == 0) {
    sig[warp * 16 + g] = density_act(d[0] + b[B_SF], softplus);
    sig[warp * 16 + g + 8] = density_act(d[2] + b[B_SF], softplus);
  }
}

// rgb [M][3] = sigmoid(relu(h . w_sf[:, 128:384] + b + vr) . w_out[:, 0:3]
// + b_out) from the trunk output h; the view feature goes through `feat`.
template <int KIN, bool GUARD = false>
__device__ __forceinline__ void color_head(const bf16* h, bf16* feat, const bf16* w,
                                           const float* b, const bf16* vr, int ray0, float* rgb,
                                           int warp, int lane, int n_rows = 0) {
  typedef WOff<KIN> O;
  const bf16* nul = nullptr;
  const int g = lane >> 2, q = lane & 3;
  layer<HID, 4, VIEW, 16, GUARD>(h, LDH, w + O::SF + 128 * HID, b + B_SF + 128, feat, LDH, nul,
                                 nul, nullptr, vr, ray0, warp, lane, n_rows);
  __syncthreads();
  float d[4];
  narrow8(d, feat, w + O::OUT, warp, lane);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = q * 2 + e;
    if (c < 3) {
      rgb[(warp * 16 + g) * 3 + c] = 1.f / (1.f + expf(-(d[e] + b[B_OUT + c])));
      rgb[(warp * 16 + g + 8) * 3 + c] = 1.f / (1.f + expf(-(d[2 + e] + b[B_OUT + c])));
    }
  }
}

}  // namespace
