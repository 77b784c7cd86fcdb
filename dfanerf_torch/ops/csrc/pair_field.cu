// Pair-compacted field kernels for Hopper (sm_90a): one listed pair per
// block, or two.
//
// Replaces: dfanerf_tpu/ops/fused_render.py _pair_field_kernel (the Pallas
// TPU kernel behind pair_field_eval_prepped) with pair_field_kernel, and
// _pair2_field_kernel (behind pair2_field_eval_prepped, the occ_pack2 path)
// with pair2_field_kernel, each for one field per launch: the head, or the
// torso with its block-diagonal deformation net first. Their plain PyTorch
// versions are dfanerf_torch/ops/pair_field.py pair_field_eval_reference and
// pair2_field_eval_reference.
//
// What they compute. The caller lists K occupied (tile, slab) pairs of one
// field, at SP samples per slab (8, or 4 for the half-slabs of occ_pack2),
// both kernels built for both.
// For each pair k, with t = t_idx[k] and j = j_idx[k], the field is
// evaluated at the SP samples z[SP j .. SP j + SP - 1] of the 256 rays of
// tile t (SP * 256 rows, sample-major), and the block [j][s][t*256 + r] of
// four per-sample buffers is written: sigma after the density activation
// (fp32) and the sigmoid colour's r, g, b (bf16, rounded to nearest even,
// as the TPU kernel stores them). Blocks of pairs that are not listed are
// never written; the composite masks them with the flags that built the
// list. pair2 takes two disjoint lists, A with ceil(K/2) pairs and B with
// floor(K/2), and writes each to its own quartet of buffers.
//
// What bounds them on the H100. The same ~1.2 MFLOP (head) or ~1.3 MFLOP
// (torso, with the deform net) of matrix products per row as the dense
// render kernel against a few hundred bytes of per-row input and output:
// bound by operations (bf16 tensor-core rate), not by device memory. The
// field's weights (1.1 MB head, 1.4 MB torso as staged ring slabs) stream
// from L2 once per 128-row chunk, so at the operation bound the L2 would
// have to deliver ~7.5 TB/s: L2 bandwidth is this design's floor
// (perf/probe_pair_field.py prints the rate reached).
//
// Design (the device code is render_rays.cu's, shared through
// field_wgmma.cuh, whose note says what bounded the mma.sync design and what
// the wgmma core does about it):
// - pair_field: one block per listed pair, so the grid is exactly K blocks
//   and no padding pair runs. The block walks its pair in 2 SP chunks of
//   128 rows (one sample, half the tile's rays). A producer warp streams
//   the field's weight slabs for all of them through the shared-memory ring
//   (it knows the count, 2 SP chunks x the field's slabs, from the start);
//   the field's biases are staged into shared memory once per block; each
//   of the two consumer warpgroups runs the field on its 64 rows of every
//   chunk and stores their sigma and rgb straight to the buffers. No
//   barrier spans the block after the ring's set-up.
// - pair2: one block per A pair, so the grid is exactly ceil(K/2) blocks.
//   Block k walks A pair k and then B pair k through the same device code
//   (the last block skips its B half when the B list is one shorter, a
//   block-uniform branch; its producer streams one pair's slabs). On the
//   TPU two half-slab pairs filled the 2048-row MXU step; here every block
//   already works in 128-row chunks, so the pairing changes only the block
//   count and the wave shape, and each quartet equals pair_field's on the
//   same list bit for bit (the same eval_pair, the same sums in the same
//   order).
// - The sample's z comes from z_vals[SP j + s]; the PE, activations and
//   output roundings are those of render_rays.cu, built with the same
//   --fmad=false and accurate sinf/expf. SP is a template parameter.

#include "field_wgmma.cuh"

namespace {

constexpr int SM_BIAS = SMW_FIELD_END;    // the field's bias blob [B_END or TORSO_BEND]
constexpr int SM_SIG = SM_BIAS + TORSO_BEND * 4;  // sigma [M]
constexpr int SM_RGB = SM_SIG + M * 4;    // rgb [M][3]
constexpr int SMEM_BYTES = SM_RGB + M * 3 * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const float *o, *d;          // [n_rows][3] rays in tile order
  const float* z;              // [S]
  const bf16* vr;              // [n_rows][256] view bias
  const float *freq, *phase;   // [64]
  const int *t_idx, *j_idx;    // [K] listed pairs
  const bf16* w;               // staged weight blob
  const float* b;              // bias blob
  float* sig;                  // [J][SP][row_stride]
  bf16 *r, *g, *bl;            // [J][SP][row_stride]
  int row_stride;              // (n_tiles + 1) * 256
  int softplus;
};

// pair2: the A list and its quartet in `a`, the B list and quartet beside.
struct Params2 {
  Params a;
  const int *tb_idx, *jb_idx;  // [n_b]
  float* sig_b;
  bf16 *r_b, *g_b, *bl_b;
  int n_b;
};

// The field on pair (t, j) at SP samples per slab, stored into p's quartet,
// for a consumer thread: its warpgroup's rows of each chunk, their weights
// from the ring. A following call rewrites sig/rgb only after several of
// the warpgroup's barriers.
template <bool TORSO, int SP>
__device__ __forceinline__ void eval_pair(const Params& p, int t, int j, unsigned char* smem,
                                          Ring& ring) {
  bf16* H = reinterpret_cast<bf16*>(smem + SMW_H);
  bf16* P = reinterpret_cast<bf16*>(smem + SMW_P);
  float* sig = reinterpret_cast<float*>(smem + SM_SIG);
  float* rgb = reinterpret_cast<float*>(smem + SM_RGB);
  const float* b = reinterpret_cast<const float*>(smem + SM_BIAS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, tw = tid & 127, row0 = wg * WG_ROWS;

#pragma unroll 1
  for (int c = 0; c < 2 * SP; ++c) {
    const int s = c >> 1;
    const int ray0 = t * RT + (c & 1) * M;
    wg_encode(P, p.o, p.d, p.z[j * SP + s], p.freq, p.phase, ray0, row0, tw);
    wg_sync(wg);
    if constexpr (TORSO) {
      wg_deform(H, P, b, ring, wg, warp & 3, lane);
      wg_trunk_and_heads<DEF>(H, P, p.w, b, p.vr, ray0, p.softplus, sig, rgb, ring, wg,
                              warp, lane);
    } else {
      wg_trunk_and_heads<PEW>(H, P, p.w, b, p.vr, ray0, p.softplus, sig, rgb, ring, wg,
                              warp, lane);
    }
    wg_sync(wg);
    if (tw < WG_ROWS) {
      const int row = row0 + tw;
      const int o = (j * SP + s) * p.row_stride + ray0 + row;
      p.sig[o] = sig[row];
      p.r[o] = __float2bfloat16_rn(rgb[row * 3]);
      p.g[o] = __float2bfloat16_rn(rgb[row * 3 + 1]);
      p.bl[o] = __float2bfloat16_rn(rgb[row * 3 + 2]);
    }
  }
}

template <bool TORSO, int SP>
__global__ void __launch_bounds__(NTHR_W, 1) pair_field_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  stage_biases(reinterpret_cast<float*>(smem + SM_BIAS), p.b, TORSO ? TORSO_BEND : B_END);
  Ring ring;
  ring.init(smem);
  ring_init(smem);
  if (threadIdx.x >= NCONS) {  // the producer warp
    if (threadIdx.x == NCONS) ring.produce(p.w, TORSO ? NS_TORSO : NS_HEAD, 2 * SP);
    return;
  }
  eval_pair<TORSO, SP>(p, p.t_idx[blockIdx.x], p.j_idx[blockIdx.x], smem, ring);
}

// SP = 4 (the half-slabs the packed-2 path runs) or 8 (the reference's
// s_slab accepts any size that divides S). One loop over the block's A and B
// pairs keeps a single copy of the field code.
template <bool TORSO, int SP>
__global__ void __launch_bounds__(NTHR_W, 1) pair2_field_kernel(const Params2 p2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = blockIdx.x;
  const int pairs = k < p2.n_b ? 2 : 1;  // block-uniform: no B pair in the last block of odd K
  stage_biases(reinterpret_cast<float*>(smem + SM_BIAS), p2.a.b, TORSO ? TORSO_BEND : B_END);
  Ring ring;
  ring.init(smem);
  ring_init(smem);
  if (threadIdx.x >= NCONS) {  // the producer warp
    if (threadIdx.x == NCONS) ring.produce(p2.a.w, TORSO ? NS_TORSO : NS_HEAD, pairs * 2 * SP);
    return;
  }
#pragma unroll 1
  for (int h = 0; h < pairs; ++h) {
    Params p = p2.a;
    int t = p.t_idx[k], j = p.j_idx[k];
    if (h) {
      p.sig = p2.sig_b;
      p.r = p2.r_b;
      p.g = p2.g_b;
      p.bl = p2.bl_b;
      t = p2.tb_idx[k];
      j = p2.jb_idx[k];
    }
    eval_pair<TORSO, SP>(p, t, j, smem, ring);
  }
}

template <typename P>
int launch(void (*kernel)(P), const P& p, int blocks, void* stream) {
  if (kernel == nullptr || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, NTHR_W, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params common(const float* o, const float* d, const float* z, const void* vr, const float* freq,
              const float* phase, const int* t_idx, const int* j_idx, const void* w,
              const float* b, float* sig, void* r, void* g, void* bl, int row_stride,
              int softplus) {
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
  return p;
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head staged weight and
// bias blob lengths, torso staged weight and bias blob lengths (ops/_build.py
// ring_blob), dynamic shared memory (the same for both kernels and both slab
// sizes).
int pair_field_layout(int* sizes) {
  sizes[0] = Staged<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = Staged<DEF>::END;
  sizes[3] = TORSO_BEND;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// Launches one block per listed pair on `stream`, at sp samples per slab
// (4 or 8); returns the cudaError_t of the launch.
int pair_field_launch(int torso, const float* o, const float* d, const float* z, const void* vr,
                      const float* freq, const float* phase, const int* t_idx, const int* j_idx,
                      const void* w, const float* b, float* sig, void* r, void* g, void* bl,
                      int n_pairs, int row_stride, int softplus, int sp, void* stream) {
  const Params p = common(o, d, z, vr, freq, phase, t_idx, j_idx, w, b, sig, r, g, bl,
                          row_stride, softplus);
  void (*kernel)(Params) = nullptr;
  if (sp == 8) kernel = torso ? pair_field_kernel<true, 8> : pair_field_kernel<false, 8>;
  if (sp == 4) kernel = torso ? pair_field_kernel<true, 4> : pair_field_kernel<false, 4>;
  return launch(kernel, p, n_pairs, stream);
}

// Launches one block per A pair on `stream`, each also walking the B pair of
// its index when there is one (n_b is n_a or n_a - 1), at sp samples per slab
// (4 or 8); returns the cudaError_t of the launch.
int pair2_field_launch(int torso, const float* o, const float* d, const float* z, const void* vr,
                       const float* freq, const float* phase, const int* ta_idx,
                       const int* ja_idx, const int* tb_idx, const int* jb_idx, const void* w,
                       const float* b, float* sig_a, void* r_a, void* g_a, void* bl_a,
                       float* sig_b, void* r_b, void* g_b, void* bl_b, int n_a, int n_b,
                       int row_stride, int softplus, int sp, void* stream) {
  if (n_b != n_a && n_b != n_a - 1) return static_cast<int>(cudaErrorInvalidValue);
  Params2 p2;
  p2.a = common(o, d, z, vr, freq, phase, ta_idx, ja_idx, w, b, sig_a, r_a, g_a, bl_a,
                row_stride, softplus);
  p2.tb_idx = tb_idx;
  p2.jb_idx = jb_idx;
  p2.sig_b = sig_b;
  p2.r_b = static_cast<bf16*>(r_b);
  p2.g_b = static_cast<bf16*>(g_b);
  p2.bl_b = static_cast<bf16*>(bl_b);
  p2.n_b = n_b;
  void (*kernel)(Params2) = nullptr;
  if (sp == 8) kernel = torso ? pair2_field_kernel<true, 8> : pair2_field_kernel<false, 8>;
  if (sp == 4) kernel = torso ? pair2_field_kernel<true, 4> : pair2_field_kernel<false, 4>;
  return launch(kernel, p2, n_a, stream);
}

}  // extern "C"
