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
// (bf16 tensor-core rate), not by device memory. The trunk's weights stream
// from L2 once per 128-row chunk (987,136 B: 60 ring slabs and the sigma
// rows).
//
// Design: the wgmma core (field_wgmma.cuh, whose note says what bounded the
// mma.sync design and what the core does about it), through its density-only
// walk wg_sigma_walk, shared with pair_hier.cu's pair_sigma:
// - One block per (tile, slab), so the grid is n_tiles x n_slabs blocks: two
//   consumer warpgroups and a producer warp that streams the trunk's weight
//   slabs for the block's 16 chunks through the 5-stage shared-memory ring
//   (NS_HEAD_TRUNK a chunk: the view feature's slabs at the end of the staged
//   blob are never copied); the head's biases are staged into shared memory.
// - The flag is uniform across the block: a clear (tile, slab) writes its
//   zeros and returns, all 288 threads, before the biases and the ring are
//   set up, so it starts no copy and waits at no barrier.
// - A running block walks its 2048 rows in 16 chunks of 128 (one sample,
//   half the tile's rays); the lane holding a row's density stores it
//   straight to device memory.
// - Built with --fmad=false and the accurate sinf, as the other field
//   kernels.

#include "field_wgmma.cuh"

namespace {

// Shared memory (bytes): the field's ring, buffers and barriers
// (field_wgmma.cuh), then the head's biases.
constexpr int SM_BIAS = SMW_FIELD_END;     // head bias blob [B_END]
constexpr int SMEM_BYTES = SM_BIAS + B_END * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const float *o, *d;         // [n_pad][3]
  const float* z;             // [S]
  const float *freq, *phase;  // [64]
  const int* occ;             // [T][J]
  const bf16* w;              // staged head weight blob
  const float* b;             // head bias blob
  float* sig;                 // [n_pad][S]
  int n_slabs, softplus;
};

__global__ void __launch_bounds__(NTHR_W, 1) sigma_head_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int J = p.n_slabs, S = J * SS;
  const int tile = blockIdx.x / J, j = blockIdx.x % J;

  if (p.occ[tile * J + j] == 0) {
    for (int idx = threadIdx.x; idx < RT * SS; idx += NTHR_W)
      p.sig[(tile * RT + idx / SS) * S + j * SS + idx % SS] = 0.f;
    return;
  }
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
  float* sig = p.sig + j * SS;
  wg_sigma_walk(H, P, p.o, p.d, p.z + j * SS, p.freq, p.phase, p.w, b, p.softplus, tile, ring,
                [&](int s, int ray, float v) { sig[ray * S + s] = v; });
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head staged weight and
// bias blob lengths (ops/_build.py ring_blob: the same staged blob as
// render_head's, of which this kernel reads the trunk's slabs and the sigma
// rows), two unused torso slots, dynamic shared memory.
int sigma_head_layout(int* sizes) {
  sizes[0] = Staged<PEW>::END;
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
  sigma_head_kernel<<<n_tiles * n_slabs, NTHR_W, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
