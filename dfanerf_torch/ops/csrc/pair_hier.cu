// Pair-compacted head kernels of the hierarchical render, for Hopper
// (sm_90a).
//
// Replaces: dfanerf_tpu/ops/fused_render.py _pair_sigma_kernel (behind
// pair_sigma_eval, the coarse pass) and _pair_field_perz_kernel (behind
// pair_field_eval_perz, the fine pass). Their plain PyTorch versions are
// dfanerf_torch/ops/pair_hier.py pair_sigma_eval_reference and
// pair_field_eval_perz_reference.
//
// What they compute. The caller lists K occupied (tile, slab) pairs of the
// head field. For each pair k, with t = t_idx[k] and j = j_idx[k], the 2048
// rows (8 samples x 256 rays, sample-major) of tile t's rays are evaluated
// and the block [j][s][t*256 + r] of per-sample buffers is written:
// - pair_sigma: at the shared depths z[8j + s], the trunk and the sigma
//   column only (sigma float32 after the density activation);
// - pair_field_perz: at each ray's own depth z_buf[j][s][t*256 + r], the
//   whole field (sigma float32; the sigmoid colour's r, g, b as bf16,
//   rounded to nearest even, as the TPU kernel stores them).
// Blocks of pairs that are not listed are never written; the callers mask
// them with the flags that built the list.
//
// What bounds them on the H100. 979,456 (pair_sigma) and 1,112,064
// (pair_field_perz) FLOP of matrix products per row at live widths against
// tens of bytes of per-row input and output: bound by operations (bf16
// tensor-core rate), not by device memory.
//
// Design (simple and right first): pair_field.cu's, for the head. One block
// of 8 warps per listed pair, so the grid is exactly K blocks and no padding
// pair runs. The block walks its pair in 16 chunks of 128 rows (one sample,
// half the tile's rays), runs the field's device code of field_mlp.cuh on
// each chunk and stores the chunk's results straight to the buffers
// (pair_sigma's walk is sigma_head.cu's: field_mlp.cuh sigma_walk). Built
// with --fmad=false and the accurate sinf/expf, as the other field kernels.

#include "field_mlp.cuh"

namespace {

constexpr int SM_SIG = SM_FIELD_END;      // sigma [M]
constexpr int SM_RGB = SM_SIG + M * 4;    // rgb [M][3]
constexpr int SMEM_BYTES = SM_RGB + M * 3 * 4;

struct Params {
  const float *o, *d;          // [n_rows][3] rays in tile order
  const float* z;              // pair_sigma: [S]; pair_field_perz: [J][8][row_stride]
  const bf16* vr;              // [n_rows][256] view bias (pair_field_perz)
  const float *freq, *phase;   // [64]
  const int *t_idx, *j_idx;    // [K] listed pairs
  const bf16* w;               // head weight blob
  const float* b;              // head bias blob
  float* sig;                  // [J][8][row_stride]
  bf16 *r, *g, *bl;            // [J][8][row_stride] (pair_field_perz)
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

__global__ void __launch_bounds__(NTHR, 1) pair_field_perz_kernel(const Params p) {
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
    const int o = (j * SS + s) * p.row_stride + ray0;
    encode_perz(P, p.o, p.d, p.z + o, p.freq, p.phase, ray0, tid);
    __syncthreads();
    trunk_and_heads<PEW>(X, Y, P, p.w, p.b, p.vr, ray0, p.softplus, sig, rgb, warp, lane);
    __syncthreads();
    if (tid < M) {
      p.sig[o + tid] = sig[tid];
      p.r[o + tid] = __float2bfloat16_rn(rgb[tid * 3]);
      p.g[o + tid] = __float2bfloat16_rn(rgb[tid * 3 + 1]);
      p.bl[o + tid] = __float2bfloat16_rn(rgb[tid * 3 + 2]);
    }
    // the next chunk rewrites sig/rgb only after several barriers
  }
}

int launch(bool field, const Params& p, int n_pairs, void* stream) {
  const auto kernel = field ? pair_field_perz_kernel : pair_sigma_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_pairs, NTHR, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  Params p = {};
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
  return launch(false, p, n_pairs, stream);
}

// pair_field_perz over the K listed pairs on `stream` (z_buf and the four
// outputs [J][8][row_stride], vr [n_rows][256]); returns the cudaError_t of
// the launch.
int pair_field_perz_launch(const float* o, const float* d, const float* z_buf, const void* vr,
                           const float* freq, const float* phase, const int* t_idx,
                           const int* j_idx, const void* w, const float* b, float* sig, void* r,
                           void* g, void* bl, int n_pairs, int row_stride, int softplus,
                           void* stream) {
  Params p = {};
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
  return launch(true, p, n_pairs, stream);
}

}  // extern "C"
