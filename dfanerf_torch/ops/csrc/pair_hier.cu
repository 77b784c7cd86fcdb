// Pair-compacted head sigma kernel of the hierarchical render, for Hopper
// (sm_90a): the coarse pass.
//
// Replaces: dfanerf_tpu/ops/fused_render.py _pair_sigma_kernel (behind
// pair_sigma_eval). Its plain PyTorch version is
// dfanerf_torch/ops/pair_hier.py pair_sigma_eval_reference. The fine pass's
// kernel, pair_field_perz, runs the wgmma core in its own library
// (pair_perz.cu).
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
// operations (bf16 tensor-core rate), not by device memory.
//
// Design (simple and right first): sigma_head.cu's walk (field_mlp.cuh
// sigma_walk, the mma.sync core) over the listed pairs, one block of 8 warps
// per pair, so the grid is exactly K blocks and no padding pair runs; with
// every pair listed it computes sigma_head's values bit for bit. Built with
// --fmad=false and the accurate sinf/expf, as the other field kernels.

#include "field_mlp.cuh"

namespace {

constexpr int SM_SIG = SM_FIELD_END;      // sigma [M]
constexpr int SMEM_BYTES = SM_SIG + M * 4;

struct Params {
  const float *o, *d;          // [n_rows][3] rays in tile order
  const float* z;              // [S]
  const float *freq, *phase;   // [64]
  const int *t_idx, *j_idx;    // [K] listed pairs
  const bf16* w;               // head weight blob
  const float* b;              // head bias blob
  float* sig;                  // [J][8][row_stride]
  int row_stride;              // (n_tiles + 1) * 256
  int softplus;
};

__global__ void __launch_bounds__(NTHR, 1) pair_sigma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* Y = reinterpret_cast<bf16*>(smem + SM_Y);
  bf16* P = reinterpret_cast<bf16*>(smem + SM_P);
  float* sig = reinterpret_cast<float*>(smem + SM_SIG);

  const int t = p.t_idx[blockIdx.x], j = p.j_idx[blockIdx.x];
  sigma_walk(X, Y, P, sig, p.o, p.d, p.z + j * SS, p.freq, p.phase, p.w, p.b, p.softplus, t,
             [&](int s, int ray, float v) { p.sig[(j * SS + s) * p.row_stride + ray] = v; });
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head weight and bias
// blob lengths, two unused torso slots, dynamic shared memory.
int pair_hier_layout(int* sizes) {
  sizes[0] = WOff<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = 0;
  sizes[3] = 0;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// pair_sigma over the K listed pairs on `stream` (sig [J][8][row_stride]);
// returns the cudaError_t of the launch.
int pair_sigma_launch(const float* o, const float* d, const float* z, const float* freq,
                      const float* phase, const int* t_idx, const int* j_idx, const void* w,
                      const float* b, float* sig, int n_pairs, int row_stride, int softplus,
                      void* stream) {
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
  pair_sigma_kernel<<<n_pairs, NTHR, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
