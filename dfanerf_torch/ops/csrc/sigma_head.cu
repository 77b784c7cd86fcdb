// Density-only head kernel for Hopper (sm_90a): the coarse pass of the
// hierarchical head render.
//
// Replaces: dfanerf_tpu/ops/fused_render.py _sigma_kernel (the Pallas TPU
// kernel behind fused_sigma_head). Its plain PyTorch version is
// dfanerf_torch/ops/sigma_head.py fused_sigma_head_reference.
//
// What it computes. For each (tile, slab) whose occupancy flag is set, the
// head field's trunk runs at the slab's 8 shared depths z[8j .. 8j+7] of the
// tile's 256 rays, then only the sigma column of the fused output layer and
// the density activation: sig[ray][8j + s], float32. A clear flag writes
// exact zeros for the whole (tile, slab). No view or colour head runs.
//
// What bounds it on the H100. 979,456 FLOP of matrix products per (ray,
// sample) at live widths (field_flops_per_sample("head", color=False))
// against 24 bytes of ray input and 4 bytes of output: bound by operations
// (bf16 tensor-core rate), not by device memory.
//
// Design (simple and right first; the field's device code is
// render_rays.cu's, shared through field_mlp.cuh): one block of 8 warps per
// (tile, slab), so the grid is n_tiles x n_slabs blocks and a clear slab
// costs one block that writes zeros. The block walks its 2048 rows in 16
// chunks of 128 (one sample, half the tile's rays); each chunk runs the
// trunk with activations in shared memory and weights streamed from L2, and
// the warps' sigma columns go straight to device memory (field_mlp.cuh
// sigma_walk, shared with pair_hier.cu's pair_sigma). Built with
// --fmad=false and the accurate sinf, as the other field kernels.

#include "field_mlp.cuh"

namespace {

constexpr int SM_SIG = SM_FIELD_END;       // sigma [M]
constexpr int SMEM_BYTES = SM_SIG + M * 4;

struct Params {
  const float *o, *d;         // [n_pad][3]
  const float* z;             // [S]
  const float *freq, *phase;  // [64]
  const int* occ;             // [T][J]
  const bf16* w;              // head weight blob
  const float* b;             // head bias blob
  float* sig;                 // [n_pad][S]
  int n_slabs, softplus;
};

__global__ void __launch_bounds__(NTHR, 1) sigma_head_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* Y = reinterpret_cast<bf16*>(smem + SM_Y);
  bf16* P = reinterpret_cast<bf16*>(smem + SM_P);
  float* sig = reinterpret_cast<float*>(smem + SM_SIG);

  const int J = p.n_slabs, S = J * SS;
  const int tile = blockIdx.x / J, j = blockIdx.x % J;

  if (p.occ[tile * J + j] == 0) {
    for (int idx = threadIdx.x; idx < RT * SS; idx += NTHR)
      p.sig[(tile * RT + idx / SS) * S + j * SS + idx % SS] = 0.f;
    return;
  }
  sigma_walk(X, Y, P, sig, p.o, p.d, p.z + j * SS, p.freq, p.phase, p.w, p.b, p.softplus, tile,
             [&](int s, int ray, float v) { p.sig[ray * S + j * SS + s] = v; });
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head weight and bias
// blob lengths, two unused torso slots, dynamic shared memory.
int sigma_head_layout(int* sizes) {
  sizes[0] = WOff<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = 0;
  sizes[3] = 0;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// Launches one block per (tile, slab) on `stream`; returns the cudaError_t
// of the launch.
int sigma_head_launch(const float* o, const float* d, const float* z, const float* freq,
                      const float* phase, const int* occ, const void* w, const float* b,
                      float* sig, int n_tiles, int n_slabs, int softplus, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(sigma_head_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.o = o;
  p.d = d;
  p.z = z;
  p.freq = freq;
  p.phase = phase;
  p.occ = occ;
  p.w = static_cast<const bf16*>(w);
  p.b = b;
  p.sig = sig;
  p.n_slabs = n_slabs;
  p.softplus = softplus;
  sigma_head_kernel<<<n_tiles * n_slabs, NTHR, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
