// Pair-compacted head-field kernel with a depth per ray, for Hopper
// (sm_90a): the fine pass of the pair-compacted hierarchical render.
//
// Replaces: dfanerf_tpu/ops/fused_render.py _pair_field_perz_kernel (the
// Pallas TPU kernel behind pair_field_eval_perz). Its plain PyTorch version
// is dfanerf_torch/ops/pair_hier.py pair_field_eval_perz_reference.
//
// What it computes. The caller lists K occupied (tile, slab) pairs of the
// head field. For each pair k, with t = t_idx[k] and j = j_idx[k], the 2048
// rows (8 samples x 256 rays, sample-major) of tile t's rays are evaluated
// at each ray's own depth z_buf[j][s][t*256 + r], and the block
// [j][s][t*256 + r] of four per-sample buffers is written: sigma after the
// density activation (float32) and the sigmoid colour's r, g, b (bf16,
// rounded to nearest even, as the TPU kernel stores them). Blocks of pairs
// that are not listed are never written; the callers mask them with the
// flags that built the list.
//
// What bounds it on the H100. 1,112,064 FLOP of matrix products per row at
// live widths against tens of bytes of per-row input and output: bound by
// operations (bf16 tensor-core rate), not by device memory. The head's
// weights stream from L2 once per 128-row chunk (1.1 MB as staged ring
// slabs), as in pair_field.cu.
//
// Design: pair_field.cu's for the head, with the per-row depths of
// render_head.cu (the device code is field_wgmma.cuh, whose note says what
// bounded the mma.sync design and what the wgmma core does about it). One
// block per listed pair, so the grid is exactly K blocks and no padding pair
// runs. The block walks its pair in 16 chunks of 128 rows (one sample, half
// the tile's rays). A producer warp streams the head's weight slabs for all
// of them through the shared-memory ring (it knows the count, 16 chunks x
// the head's slabs, from the start); the head's biases are staged into
// shared memory once per block; each of the two consumer warpgroups encodes
// its 64 rows of every chunk at their rays' depths (wg_encode_perz), runs the
// head on them and stores their sigma and rgb straight to the buffers. No
// barrier spans the block after the ring's set-up. Built with --fmad=false
// and the accurate sinf/expf, as the other field kernels.
//
// A library of its own, beside pair_hier.cu's pair_sigma (the coarse pass,
// also on the wgmma core).

#include "field_wgmma.cuh"

namespace {

constexpr int SM_BIAS = SMW_FIELD_END;    // head bias blob [B_END]
constexpr int SM_SIG = SM_BIAS + B_END * 4;  // sigma [M]
constexpr int SM_RGB = SM_SIG + M * 4;    // rgb [M][3]
constexpr int SMEM_BYTES = SM_RGB + M * 3 * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const float *o, *d;          // [n_rows][3] rays in tile order
  const float* z;              // [J][8][row_stride] per-ray depths
  const bf16* vr;              // [n_rows][256] view bias
  const float *freq, *phase;   // [64]
  const int *t_idx, *j_idx;    // [K] listed pairs
  const bf16* w;               // staged head weight blob
  const float* b;              // head bias blob
  float* sig;                  // [J][8][row_stride]
  bf16 *r, *g, *bl;            // [J][8][row_stride]
  int row_stride;              // (n_tiles + 1) * 256
  int softplus;
};

__global__ void __launch_bounds__(NTHR_W, 1) pair_field_perz_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H = reinterpret_cast<bf16*>(smem + SMW_H);
  bf16* P = reinterpret_cast<bf16*>(smem + SMW_P);
  float* b = reinterpret_cast<float*>(smem + SM_BIAS);
  float* sig = reinterpret_cast<float*>(smem + SM_SIG);
  float* rgb = reinterpret_cast<float*>(smem + SM_RGB);
  stage_biases(b, p.b, B_END);
  Ring ring;
  ring.init(smem);
  ring_init(smem);
  if (threadIdx.x >= NCONS) {  // the producer warp
    if (threadIdx.x == NCONS) ring.produce(p.w, NS_HEAD, 2 * SS);
    return;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, tw = tid & 127, row0 = wg * WG_ROWS;
  const int t = p.t_idx[blockIdx.x], j = p.j_idx[blockIdx.x];

#pragma unroll 1
  for (int c = 0; c < 2 * SS; ++c) {
    const int s = c >> 1;
    const int ray0 = t * RT + (c & 1) * M;
    const int o = (j * SS + s) * p.row_stride + ray0;
    wg_encode_perz(P, p.o, p.d, p.z + o, p.freq, p.phase, ray0, row0, tw);
    wg_sync(wg);
    wg_trunk_and_heads<PEW>(H, P, p.w, b, p.vr, ray0, p.softplus, sig, rgb, ring, wg, warp,
                            lane);
    wg_sync(wg);
    if (tw < WG_ROWS) {
      const int row = row0 + tw;
      p.sig[o + row] = sig[row];
      p.r[o + row] = __float2bfloat16_rn(rgb[row * 3]);
      p.g[o + row] = __float2bfloat16_rn(rgb[row * 3 + 1]);
      p.bl[o + row] = __float2bfloat16_rn(rgb[row * 3 + 2]);
    }
    // the next chunk rewrites the warpgroup's sig/rgb rows only after
    // several of its barriers
  }
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head staged weight and
// bias blob lengths (ops/_build.py ring_blob), two unused torso slots,
// dynamic shared memory.
int pair_perz_layout(int* sizes) {
  sizes[0] = Staged<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = 0;
  sizes[3] = 0;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// pair_field_perz over the K >= 1 listed pairs on `stream` (z_buf and the
// four outputs [J][8][row_stride], vr [n_rows][256]); returns the
// cudaError_t of the launch.
int pair_field_perz_launch(const float* o, const float* d, const float* z_buf, const void* vr,
                           const float* freq, const float* phase, const int* t_idx,
                           const int* j_idx, const void* w, const float* b, float* sig, void* r,
                           void* g, void* bl, int n_pairs, int row_stride, int softplus,
                           void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_field_perz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.o = o;
  p.d = d;
  p.z = z_buf;
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
  pair_field_perz_kernel<<<n_pairs, NTHR_W, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
