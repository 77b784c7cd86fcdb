// Occupancy node-grid kernel for Hopper (sm_90a): one field's density at
// every fine node of the occupancy grid, in one launch.
//
// Replaces: the z-group loop of dfanerf_torch/ops/occupancy.py
// node_density_reference (its plain PyTorch version), the port of the XLA
// grid of dfanerf_tpu/ops/fused_render.py :407-423; the reference package
// has no Pallas kernel for it.
//
// What it computes. For node n = (z * gf + y) * gf + x of the gf^3 grid:
// the point p[a] = lo[a] + g[i[a]] * span[a] on each axis a of (x, y, z),
// with i = (x, y, z) and g the grid's float32 linspace table (a product,
// then a sum: the plain version's order; --fmad=false keeps it); its PE;
// for the torso the deformation net; the trunk; only the sigma column of
// the fused output layer; the density activation: sig[n], float32.
//
// What bounds it on the H100. 979,456 FLOP of matrix products per node for
// the head and 1,124,096 for the torso at live widths
// (field_flops_per_sample(branch, color=False)) against 4 bytes of output:
// bound by operations (bf16 tensor-core rate). The weights stream from L2
// once per 128-node chunk: the head's trunk slabs and sigma rows (987,136
// B), the torso's deform and trunk slabs and sigma rows (1,249,280 B;
// staged_weight_bytes(branch, color=False)).
//
// Design: the wgmma core (field_wgmma.cuh), density only, as sigma_head.cu
// and far_eval.cu's far_head walk it:
// - One block per SM (its 195 KB of shared memory leave one), or per chunk
//   where there are fewer chunks; block b walks the 128-node chunks b,
//   b + grid, ... The chunk count is computed once for the producer and the
//   consumers, so the producer issues exactly the slabs its consumers take.
//   A block per fixed 2048 nodes would leave the last of its waves mostly
//   empty (432 blocks at grid 48 over 132 SMs: 4 waves for 3.3 of work);
//   per chunk, the last wave is at most one chunk.
// - A chunk: each warpgroup encodes its 64 nodes (wg_encode_nodes), the
//   torso runs wg_deform, then wg_trunk and the sigma column (narrow8 over
//   the staged blob's sigma rows). The producer streams the first
//   NS_HEAD_TRUNK (60) or NS_TORSO_TRUNK (76) slabs of the staged blob a
//   chunk: the view feature's 8 slabs at its end are never copied.
// - The last chunk may be ragged: its rows at or past n encode node n - 1
//   and are never stored. A node's value depends only on its node.
// - Built with --fmad=false and the accurate sinf, as the other field
//   kernels.

#include "field_wgmma.cuh"

namespace {

// Ring slabs a density-only chunk of the torso consumes: the deform net and
// the trunk, without the view feature's slabs.
constexpr int NS_TORSO_TRUNK = NS_TORSO - slabs(HID, HID);
static_assert(NS_TORSO_TRUNK == 76, "torso trunk ring");

// Shared memory (bytes): the field's ring, buffers and barriers
// (field_wgmma.cuh), then the field's biases (the torso's blob is the
// larger).
constexpr int SM_BIAS = SMW_FIELD_END;
constexpr int SMEM_BYTES = SM_BIAS + TORSO_BEND * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const float* g;             // [gf] node coordinates along an axis, 0 .. 1
  const float *lo, *span;     // [3] (x, y, z)
  const float *freq, *phase;  // [64]
  const bf16* w;              // staged weight blob of the field
  const float* b;             // its bias blob
  float* sig;                 // [gf][gf][gf] (z, y, x)
  int gf, n, softplus;        // n = gf^3
};

// The staged weight blob w, made opaque to the compiler once per chunk, as
// far_eval.cu does: left visible, ptxas may hoist narrow8's per-thread
// weight addresses out of the chunk loop and spill them.
__device__ __forceinline__ const bf16* opaque(const bf16* w) {
  asm volatile("" : "+l"(w));
  return w;
}

// sin(p[c % 3] * freq + phase) for warpgroup rows row0 .. row0 + 63 of the
// chunk, row `row` at node min(node0 + row, n - 1), in the 64 PE slots
// (slots 60:64 are zero), rounded to bf16: wg_encode's expression with the
// node's point in place of a ray's. t is the thread's index in its
// warpgroup; it encodes slot t % 64 (so one axis) of every other row, from
// row t / 64, and steps its node's (x, y, z) along with the rows instead of
// dividing for each.
__device__ __forceinline__ void wg_encode_nodes(bf16* P, const Params& p, int node0, int row0,
                                                int t) {
  // t made opaque: the values below would otherwise be hoisted out of the
  // chunk loop and held (spilled) through the trunk
  asm volatile("" : "+r"(t));
  const int c = t & (PEW - 1), a = c % 3, gf = p.gf;
  const float lo = p.lo[a], span = p.span[a], freq = p.freq[c], phase = p.phase[c];
  const int first = row0 + (t >> 6), node = node0 + first;
  int x = node % gf, y = node / gf % gf, z = node / (gf * gf);
#pragma unroll 4
  for (int row = first; row < row0 + WG_ROWS; row += 2) {
    float v = 0.f;
    if (c < 60) {
      // a row at or past n (z == gf) encodes node n - 1 = (gf - 1, gf - 1, gf - 1)
      const int i = z >= gf ? gf - 1 : a == 0 ? x : a == 1 ? y : z;
      const float step = p.g[i] * span;
      const float pts = lo + step;
      const float arg = pts * freq + phase;
      v = sinf(arg);
    }
    P[row * LDP + c] = __float2bfloat16_rn(v);
    x += 2;  // the node two rows on (gf >= 2, so x wraps at most once)
    if (x >= gf) {
      x -= gf;
      if (++y == gf) {
        y = 0;
        ++z;
      }
    }
  }
}

// The field (trunk input width KIN: PEW head, DEF torso) at the block's
// chunks of nodes.
template <int KIN>
__global__ void __launch_bounds__(NTHR_W, 1) node_grid_kernel(const Params p) {
  constexpr bool TORSO = KIN == DEF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H = reinterpret_cast<bf16*>(smem + SMW_H);
  bf16* P = reinterpret_cast<bf16*>(smem + SMW_P);
  float* b = reinterpret_cast<float*>(smem + SM_BIAS);
  // chunks blockIdx.x, blockIdx.x + gridDim.x, ... below n_chunks; the
  // producer and the consumers both take this count
  const int n_chunks = (p.n + M - 1) / M;
  const int mine = (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;

  stage_biases(b, p.b, TORSO ? TORSO_BEND : B_END);
  Ring ring;
  ring.init(smem);
  ring_init(smem);
  if (threadIdx.x >= NCONS) {  // the producer warp
    if (threadIdx.x == NCONS) ring.produce(p.w, TORSO ? NS_TORSO_TRUNK : NS_HEAD_TRUNK, mine);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3, t = tid & 127, row0 = wg * WG_ROWS;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int i = 0; i < mine; ++i) {
    const int node0 = (blockIdx.x + i * gridDim.x) * M;
    wg_encode_nodes(P, p, node0, row0, t);
    wg_sync(wg);
    if constexpr (TORSO) wg_deform(H, P, b, ring, wg, wi, lane);
    wg_trunk<KIN>(H, P, b, ring, wg, wi, lane);
    float x[4];
    narrow8(x, H, opaque(p.w) + Staged<KIN>::SIGW, warp, lane);
    if (q == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int node = node0 + warp * 16 + g + h * 8;
        if (node < p.n) p.sig[node] = density_act(x[2 * h] + b[B_SF], p.softplus);
      }
    }
    // the next chunk's encode rewrites P only after the trunk's last
    // barrier, and its first layer rewrites the warp's rows of H (read by
    // narrow8 above) only after the encode's barrier
  }
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head staged weight and
// bias blob lengths, torso staged weight and bias blob lengths (ops/_build.py
// ring_blob; the kernel reads each field's trunk slabs and sigma rows, and
// the torso's deform slabs), dynamic shared memory.
int node_grid_layout(int* sizes) {
  sizes[0] = Staged<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = Staged<DEF>::END;
  sizes[3] = TORSO_BEND;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// The density of the head (torso = 0) or the torso (torso = 1) at the gf^3
// nodes into sig [gf][gf][gf], on `stream`; returns the cudaError_t of the
// launch (cudaErrorInvalidValue unless 2 <= gf <= 1290, where gf^3 fits an
// int).
int node_grid_launch(int torso, const float* g, const float* lo, const float* span,
                     const float* freq, const float* phase, const void* w, const float* b,
                     float* sig, int gf, int softplus, void* stream) {
  if (gf < 2 || gf > 1290) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const Params) = torso ? node_grid_kernel<DEF> : node_grid_kernel<PEW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.g = g;
  p.lo = lo;
  p.span = span;
  p.freq = freq;
  p.phase = phase;
  p.w = static_cast<const bf16*>(w);
  p.b = b;
  p.sig = sig;
  p.gf = gf;
  p.n = gf * gf * gf;
  p.softplus = softplus;
  const int n_chunks = (p.n + M - 1) / M;
  const int grid = n_chunks < sms ? n_chunks : sms;
  kernel<<<grid, NTHR_W, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
