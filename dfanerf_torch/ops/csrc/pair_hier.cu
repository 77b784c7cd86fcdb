// Pair-compacted head sigma kernel of the hierarchical render, for Hopper
// (sm_90a): the coarse pass.
//
// Replaces: dfanerf_tpu/ops/fused_render.py _pair_sigma_kernel (behind
// pair_sigma_eval). Its plain PyTorch version is
// dfanerf_torch/ops/pair_hier.py pair_sigma_eval_reference. The fine pass's
// kernel, pair_field_perz, is in a library of its own (pair_perz.cu).
//
// What it computes. The caller lists K occupied (tile, slab) pairs of the
// head field. For each pair k, with t = t_idx[k] and j = j_idx[k], the 2048
// rows (8 samples x 256 rays, sample-major) of tile t's rays are evaluated
// at the shared depths z[8j + s], the trunk and the sigma column only, and
// the block [j][s][t*256 + r] of a float32 buffer is written with sigma
// after the density activation. Blocks of pairs that are not listed are
// never written; the callers mask them with the flags that built the list.
//
// What bounds it on the H100. 979,456 FLOP of matrix products per row at
// live widths against tens of bytes of per-row input and output: bound by
// operations (bf16 tensor-core rate), not by device memory. The trunk's
// weights stream from L2 once per 128-row chunk (987,136 B), as in
// sigma_head.cu.
//
// Design: sigma_head.cu's over the listed pairs (the wgmma core's
// density-only walk, field_wgmma.cuh wg_sigma_walk): one block per listed
// pair, so the grid is exactly K blocks and no padding pair runs; a producer
// warp streams the trunk's weight slabs for the pair's 16 chunks through the
// shared-memory ring, the head's biases are staged into shared memory once
// per block, and the lane holding a row's density stores it straight to the
// buffer. With every pair listed it computes sigma_head's values bit for bit:
// each (tile, slab) runs the same code on the same rows. Built with
// --fmad=false and the accurate sinf/expf, as the other field kernels.

#include "field_wgmma.cuh"

namespace {

// Shared memory (bytes): the field's ring, buffers and barriers
// (field_wgmma.cuh), then the head's biases.
constexpr int SM_BIAS = SMW_FIELD_END;    // head bias blob [B_END]
constexpr int SMEM_BYTES = SM_BIAS + B_END * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const float *o, *d;          // [n_rows][3] rays in tile order
  const float* z;              // [S]
  const float *freq, *phase;   // [64]
  const int *t_idx, *j_idx;    // [K] listed pairs
  const bf16* w;               // staged head weight blob
  const float* b;              // head bias blob
  float* sig;                  // [J][8][row_stride]
  int row_stride;              // (n_tiles + 1) * 256
  int softplus;
};

__global__ void __launch_bounds__(NTHR_W, 1) pair_sigma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H = reinterpret_cast<bf16*>(smem + SMW_H);
  bf16* P = reinterpret_cast<bf16*>(smem + SMW_P);
  float* b = reinterpret_cast<float*>(smem + SM_BIAS);
  stage_biases(b, p.b, B_END);
  Ring ring;
  ring.init(smem);
  ring_init(smem);
  if (threadIdx.x >= NCONS) {  // the producer warp
    if (threadIdx.x == NCONS) ring.produce(p.w, NS_HEAD_TRUNK, 2 * SS);
    return;
  }
  const int t = p.t_idx[blockIdx.x], j = p.j_idx[blockIdx.x];
  float* sig = p.sig + j * SS * p.row_stride;
  const int stride = p.row_stride;
  wg_sigma_walk(H, P, p.o, p.d, p.z + j * SS, p.freq, p.phase, p.w, b, p.softplus, t, ring,
                [&](int s, int ray, float v) { sig[s * stride + ray] = v; });
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head staged weight and
// bias blob lengths (ops/_build.py ring_blob, as for sigma_head), two unused
// torso slots, dynamic shared memory.
int pair_hier_layout(int* sizes) {
  sizes[0] = Staged<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = 0;
  sizes[3] = 0;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// pair_sigma over the K >= 1 listed pairs on `stream` (sig
// [J][8][row_stride]); returns the cudaError_t of the launch.
int pair_sigma_launch(const float* o, const float* d, const float* z, const float* freq,
                      const float* phase, const int* t_idx, const int* j_idx, const void* w,
                      const float* b, float* sig, int n_pairs, int row_stride, int softplus,
                      void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(pair_sigma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.o = o;
  p.d = d;
  p.z = z;
  p.freq = freq;
  p.phase = phase;
  p.t_idx = t_idx;
  p.j_idx = j_idx;
  p.w = static_cast<const bf16*>(w);
  p.b = b;
  p.sig = sig;
  p.row_stride = row_stride;
  p.softplus = softplus;
  pair_sigma_kernel<<<n_pairs, NTHR_W, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
