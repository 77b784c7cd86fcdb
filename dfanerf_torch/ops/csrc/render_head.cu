// Head-field volume-render kernel with a depth per ray, for Hopper (sm_90a):
// the fine pass of the hierarchical head render.
//
// Replaces: dfanerf_tpu/ops/fused_render.py _head_kernel (the Pallas TPU
// kernel behind fused_render_head). Its plain PyTorch version is
// dfanerf_torch/ops/render_head.py fused_render_head_reference.
//
// What it computes. For every ray of a 256-ray tile, at its own depths z[.][ray]
// (the sorted coarse + importance union), the head field (trunk, sigma, view
// feature + view bias, colour) and the head stack's float32 composite,
// sample by sample, with the reference's background concat at the final
// sample: the colour there is the background pixel and the density gets
// +1e-6 before alpha = 1 - exp(-(sigma + 1e-6) * dist). A slab is skipped
// when the tile's largest transmittance is <= ert_eps (early ray
// termination) or its occupancy flag is 0; the last slab always runs.
//
// What bounds it on the H100. 1,112,064 FLOP of matrix products per (ray,
// sample) at live widths (field_flops_per_sample("head")) against 8 bytes of
// per-sample input (depth, interval) and ~550 bytes per ray: bound by
// operations (bf16 tensor-core rate), not by device memory. The head's
// weights stream from L2 once per 128-row chunk (1.1 MB as staged ring
// slabs), so at the operation bound the L2 would have to deliver ~7.5 TB/s,
// as in render_rays.cu.
//
// Design: render_rays.cu's with the head stack only (the field's device code
// is field_wgmma.cuh, whose note says what bounded the mma.sync design and
// what the wgmma core does about it):
// - One block per 256-ray tile: two consumer warpgroups and a producer warp
//   that streams the head's weight slabs through the 5-stage shared-memory
//   ring; the head's biases are staged into shared memory once per block.
//   The block loops over the slabs (the TPU's sequential slab grid axis);
//   the per-ray transmittance and rgb sum live in shared memory, and the
//   ERT test at each slab start is a block-wide max over the 256 rays in
//   which the producer takes part, so the kernel skips exactly the slabs the
//   TPU kernel skips, and the producer issues a slab's weights only once the
//   slab is known to run: no copy is left in flight at the end.
// - A slab runs in 16 chunks of 128 rows (one sample, half the rays). Each
//   warpgroup encodes its 64 rows at their rays' own depths
//   (wg_encode_perz), runs the head on them and composites its 64 rays'
//   sample straight away, since every chunk of sample s precedes every
//   chunk of sample s + 1.
// - Built with --fmad=false and the accurate sinf/expf, as the other field
//   kernels.

#include "field_wgmma.cuh"

namespace {

// Shared memory (bytes): the field's ring, buffers and barriers
// (field_wgmma.cuh), the head's biases, then the compositing state.
constexpr int SM_BIAS = SMW_FIELD_END;          // head bias blob [B_END]
constexpr int SM_STATE = SM_BIAS + B_END * 4;   // t_acc [RT]
constexpr int SM_ACC = SM_STATE + RT * 4;       // acc [RT][3]
constexpr int SM_RES = SM_ACC + RT * 3 * 4;     // sig [M], rgb [M][3]
constexpr int SM_RED = SM_RES + M * 4 * 4;      // one float per consumer warp
constexpr int SMEM_BYTES = SM_RED + NCONS / 32 * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const float *o, *d;         // [n_pad][3]
  const float* z;             // [S][n_pad] per-ray depths
  const float* dists;         // [S][n_pad]
  const bf16* vr;             // [n_pad][256] view bias
  const float* bc;            // [n_pad][3]
  const float *freq, *phase;  // [64]
  const int* occ;             // [T][J]
  const bf16* w;              // staged head weight blob
  const float* b;             // head bias blob
  float* out;                 // [n_pad][3]
  int* slabs;                 // [T] slabs evaluated per tile
  int n_tiles, n_slabs, softplus;
  float ert_eps;
};

__global__ void __launch_bounds__(NTHR_W, 1) render_head_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H = reinterpret_cast<bf16*>(smem + SMW_H);
  bf16* P = reinterpret_cast<bf16*>(smem + SMW_P);
  float* b = reinterpret_cast<float*>(smem + SM_BIAS);
  float* t_acc = reinterpret_cast<float*>(smem + SM_STATE);
  float* acc = reinterpret_cast<float*>(smem + SM_ACC);
  float* sig = reinterpret_cast<float*>(smem + SM_RES);
  float* rgb = sig + M;
  float* red = reinterpret_cast<float*>(smem + SM_RED);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, t = tid & 127, row0 = wg * WG_ROWS;
  const int tile = blockIdx.x;
  const int J = p.n_slabs;
  const int n_pad = p.n_tiles * RT;

  if (tid < RT) {
    t_acc[tid] = 1.f;
    for (int c = 0; c < 3; ++c) acc[tid * 3 + c] = 0.f;
  }
  stage_biases(b, p.b, B_END);
  Ring ring;
  ring.init(smem);
  ring_init(smem);
  int n_run = 0;

#pragma unroll 1
  for (int j = 0; j < J; ++j) {
    const bool is_last = j == J - 1;
    __syncthreads();
    float m = tid < RT ? t_acc[tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0 && tid < NCONS) red[warp] = m;
    __syncthreads();
    float mx = red[0];
#pragma unroll
    for (int w = 1; w < NCONS / 32; ++w) mx = fmaxf(mx, red[w]);
    // red is written again only after the next slab's first barrier
    const bool alive = (mx > p.ert_eps && p.occ[tile * J + j] != 0) || is_last;
    if (!alive) continue;
    ++n_run;

    if (tid >= NCONS) {  // the producer warp: this slab's chunks' weights
      if (tid == NCONS) ring.produce(p.w, NS_HEAD, 2 * SS);
      __syncwarp();
      continue;
    }

    // The weight pointer, made opaque to the compiler once per slab: left
    // visible, ptxas hoists narrow8's per-thread weight addresses out of the
    // slab loop and spills them (368 B at the core's 168 registers).
    const bf16* w = p.w;
    asm volatile("" : "+l"(w));
#pragma unroll 1
    for (int c = 0; c < 2 * SS; ++c) {
      const int s = c >> 1;
      const int r0 = (c & 1) * M;
      const int ray0 = tile * RT + r0;
      const int sg = j * SS + s;
      wg_encode_perz(P, p.o, p.d, p.z + sg * n_pad + ray0, p.freq, p.phase, ray0, row0, t);
      wg_sync(wg);
      wg_trunk_and_heads<PEW>(H, P, w, b, p.vr, ray0, p.softplus, sig, rgb, ring, wg, warp,
                              lane);
      wg_sync(wg);

      // composite sample s of the warpgroup's 64 rays
      if (t < WG_ROWS) {
        const int row = row0 + t;
        const int r = r0 + row;
        const int gr = tile * RT + r;
        const float lastf = (is_last && s == SS - 1) ? 1.f : 0.f;
        const float sh = sig[row] + 1e-6f * lastf;
        const float th = t_acc[r];
        const float alpha = 1.f - expf(-(sh + 1e-6f) * p.dists[sg * n_pad + gr]);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ch = rgb[row * 3 + k] * (1.f - lastf) + p.bc[gr * 3 + k] * lastf;
          acc[r * 3 + k] = acc[r * 3 + k] + (alpha * th) * ch;
        }
        t_acc[r] = th * (1.f - alpha + 1e-10f);
      }
      // the next chunk's head pass rewrites the warpgroup's sig/rgb rows
      // only after several of its barriers
    }
  }
  __syncthreads();
  if (tid < RT) {
    const int gr = tile * RT + tid;
    for (int k = 0; k < 3; ++k) p.out[gr * 3 + k] = acc[tid * 3 + k];
  }
  if (tid == 0) p.slabs[tile] = n_run;
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head staged weight and
// bias blob lengths (ops/_build.py ring_blob), two unused torso slots,
// dynamic shared memory.
int render_head_layout(int* sizes) {
  sizes[0] = Staged<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = 0;
  sizes[3] = 0;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// Launches one block per tile on `stream`; returns the cudaError_t of the
// launch.
int render_head_launch(const float* o, const float* d, const float* z, const float* dists,
                       const void* vr, const float* bc, const float* freq, const float* phase,
                       const int* occ, const void* w, const float* b, float* out, int* slabs,
                       int n_tiles, int n_slabs, int softplus, float ert_eps, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      render_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.o = o;
  p.d = d;
  p.z = z;
  p.dists = dists;
  p.vr = static_cast<const bf16*>(vr);
  p.bc = bc;
  p.freq = freq;
  p.phase = phase;
  p.occ = occ;
  p.w = static_cast<const bf16*>(w);
  p.b = b;
  p.out = out;
  p.slabs = slabs;
  p.n_tiles = n_tiles;
  p.n_slabs = n_slabs;
  p.softplus = softplus;
  p.ert_eps = ert_eps;
  render_head_kernel<<<n_tiles, NTHR_W, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
