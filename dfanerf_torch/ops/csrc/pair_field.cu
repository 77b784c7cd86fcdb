// Pair-compacted field kernel for Hopper (sm_90a).
//
// Replaces: dfanerf_tpu/ops/fused_render.py _pair_field_kernel (the Pallas
// TPU kernel behind pair_field_eval_prepped), for one field per launch:
// the head, or the torso with its block-diagonal deformation net first. Its
// plain PyTorch version is dfanerf_torch/ops/pair_field.py
// pair_field_eval_reference.
//
// What it computes. The caller lists K occupied (tile, slab) pairs of one
// field. For each pair k, with t = t_idx[k] and j = j_idx[k], the field is
// evaluated at the 8 samples z[8j .. 8j+7] of the 256 rays of tile t (2048
// rows, sample-major), and the block [j][s][t*256 + r] of four per-sample
// buffers is written: sigma after the density activation (fp32) and the
// sigmoid colour's r, g, b (bf16, rounded to nearest even, as the TPU
// kernel stores them). Blocks of pairs that are not listed are never
// written; the composite masks them with the flags that built the list.
//
// What bounds it on the H100. The same ~1.2 MFLOP (head) or ~1.3 MFLOP
// (torso, with the deform net) of matrix products per row as the dense
// render kernel against a few hundred bytes of per-row input and output:
// bound by operations (bf16 tensor-core rate), not by device memory.
//
// Design (simple and right first; the device code is render_rays.cu's,
// shared through field_mlp.cuh):
// - One block of 8 warps per listed pair, so the grid is exactly K blocks
//   and no padding pair runs. The block walks its pair in 16 chunks of 128
//   rows (one sample, half the tile's rays), runs the field on each chunk
//   with activations in shared memory and weights streamed from L2, and
//   stores the chunk's 128 sigma and rgb values straight to the buffers.
// - The sample's z comes from z_vals[8j + s]; the PE, activations and
//   output roundings are those of render_rays.cu, built with the same
//   --fmad=false and accurate sinf/expf.

#include "field_mlp.cuh"

namespace {

constexpr int SM_SIG = SM_FIELD_END;      // sigma [M]
constexpr int SM_RGB = SM_SIG + M * 4;    // rgb [M][3]
constexpr int SMEM_BYTES = SM_RGB + M * 3 * 4;

struct Params {
  const float *o, *d;          // [n_rows][3] rays in tile order
  const float* z;              // [S]
  const bf16* vr;              // [n_rows][256] view bias
  const float *freq, *phase;   // [64]
  const int *t_idx, *j_idx;    // [K] listed pairs
  const bf16* w;               // weight blob
  const float* b;              // bias blob
  float* sig;                  // [J][8][row_stride]
  bf16 *r, *g, *bl;            // [J][8][row_stride]
  int row_stride;              // (n_tiles + 1) * 256
  int softplus;
};

template <bool TORSO>
__global__ void __launch_bounds__(NTHR, 1) pair_field_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* Y = reinterpret_cast<bf16*>(smem + SM_Y);
  bf16* P = reinterpret_cast<bf16*>(smem + SM_P);
  float* sig = reinterpret_cast<float*>(smem + SM_SIG);
  float* rgb = reinterpret_cast<float*>(smem + SM_RGB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = p.t_idx[blockIdx.x], j = p.j_idx[blockIdx.x];

#pragma unroll 1
  for (int c = 0; c < 2 * SS; ++c) {
    const int s = c >> 1;
    const int ray0 = t * RT + (c & 1) * M;
    encode(P, p.o, p.d, p.z[j * SS + s], p.freq, p.phase, ray0, tid);
    __syncthreads();
    if constexpr (TORSO) {
      deform(X, Y, P, p.w, p.b, warp, lane);
      trunk_and_heads<DEF>(X, Y, P, p.w, p.b, p.vr, ray0, p.softplus, sig, rgb, warp, lane);
    } else {
      trunk_and_heads<PEW>(X, Y, P, p.w, p.b, p.vr, ray0, p.softplus, sig, rgb, warp, lane);
    }
    __syncthreads();
    if (tid < M) {
      const int o = (j * SS + s) * p.row_stride + ray0 + tid;
      p.sig[o] = sig[tid];
      p.r[o] = __float2bfloat16_rn(rgb[tid * 3]);
      p.g[o] = __float2bfloat16_rn(rgb[tid * 3 + 1]);
      p.bl[o] = __float2bfloat16_rn(rgb[tid * 3 + 2]);
    }
    // the next chunk rewrites sig/rgb only after several barriers
  }
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head weight and bias
// blob lengths, torso weight and bias blob lengths, dynamic shared memory.
int pair_field_layout(int* sizes) {
  sizes[0] = WOff<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = TORSO_WEND;
  sizes[3] = TORSO_BEND;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// Launches one block per listed pair on `stream`; returns the cudaError_t
// of the launch.
int pair_field_launch(int torso, const float* o, const float* d, const float* z, const void* vr,
                      const float* freq, const float* phase, const int* t_idx, const int* j_idx,
                      const void* w, const float* b, float* sig, void* r, void* g, void* bl,
                      int n_pairs, int row_stride, int softplus, void* stream) {
  Params p;
  p.o = o;
  p.d = d;
  p.z = z;
  p.vr = static_cast<const bf16*>(vr);
  p.freq = freq;
  p.phase = phase;
  p.t_idx = t_idx;
  p.j_idx = j_idx;
  p.w = static_cast<const bf16*>(w);
  p.b = b;
  p.sig = sig;
  p.r = static_cast<bf16*>(r);
  p.g = static_cast<bf16*>(g);
  p.bl = static_cast<bf16*>(bl);
  p.row_stride = row_stride;
  p.softplus = softplus;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (torso) {
    err = cudaFuncSetAttribute(pair_field_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    pair_field_kernel<true><<<n_pairs, NTHR, SMEM_BYTES, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(pair_field_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    pair_field_kernel<false><<<n_pairs, NTHR, SMEM_BYTES, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
