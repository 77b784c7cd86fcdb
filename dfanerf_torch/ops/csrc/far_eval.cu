// Far-plane field kernels for Hopper (sm_90a): the background catch-all's
// two field evaluations, as two kernels or one.
//
// Replaces: dfanerf_tpu/ops/fused_render.py _far_head_kernel and
// _far_torso_kernel (the Pallas TPU kernels behind
// fused_far_eval_split_prepped), and _far_kernel (behind fused_far_eval,
// their joint form). The plain PyTorch version of all three is
// dfanerf_torch/ops/far_eval.py far_eval_reference.
//
// What they compute, for every ray at its far-plane point o + d * far:
// - far_head: the head field's density only, density_act(h . w_sf[:, 0] +
//   b_sf[0]) after the trunk. Only column 0 of w_sf is read (the TPU kernel
//   slices 128 columns because its lanes are 128 wide; here the sigma
//   product is one 8-column mma tile).
// - far_torso: the torso field's colour only: deform net, trunk, w_sf
//   columns 128:384 plus the view bias, then the 3 live columns of w_out
//   and a sigmoid. The sigma column is not computed.
// - far_joint: far_head then far_torso on the same 128 rays, chunk by
//   chunk in one block, through the same device code, so it equals the two
//   bit for bit.
// Outputs are sh [n] and ct [n][3] in fp32; the TPU kernels' [n, 8]
// broadcast outputs were a lane layout, not part of the function.
//
// What bounds them on the H100. 979,456 FLOP (head, sigma only) and
// ~1.26 MFLOP (torso, colour only) of matrix products per ray at live widths
// (field_flops_per_sample) against ~30 bytes of per-ray input (and the
// torso's 512-byte view bias) and 4-12 bytes of output: bound by
// operations (bf16 tensor-core rate). The weights stream from L2 once per
// 128-ray chunk: the head's trunk and sigma rows (987,136 B), the torso's
// 84 slabs and rgb rows.
//
// Design: the wgmma core (field_wgmma.cuh, whose note says what bounded the
// port's first core and what this one does about it), through two walks of
// this file, one per field:
// - far_head_chunk: wg_encode at z = far, wg_trunk<PEW>, the sigma column
//   by narrow8 over the staged blob's sigma rows; the ring carries
//   NS_HEAD_TRUNK = 60 slabs a chunk (the view feature's 8 are never
//   copied), as wg_sigma_walk's.
// - far_torso_chunk: wg_encode, wg_deform, wg_trunk<DEF>, the view-feature
//   layer with the per-ray view bias, then the rgb columns by narrow8 and a
//   sigmoid; all NS_TORSO = 84 slabs. It is a twin of wg_trunk_and_heads<DEF>
//   without the sigma column, because its view-feature layer needs the
//   ragged chunk's clamp (below) anyway.
// - Several chunks per block: the block's 210 KB of shared memory leave one
//   block per SM, and a block per chunk (1,583 in a 450x450 frame) would pay
//   the bias staging, ring_init and a cold ring each time (2-3% of the
//   kernels' time on an H100, perf/probe_far_eval.py). The grid is
//   min(chunks, SMs) and block b walks chunks b, b + grid, ...; far_block
//   counts them once, before the producer and the consumers part, so the
//   producer issues exactly the slabs its consumers take.
// - far_joint runs, per chunk, the head walk and then the torso walk; its
//   producer issues the head's 60 slabs then the torso's 84, and both bias
//   blobs are staged. The three kernels share one shared-memory layout.
// - The last chunk may be ragged: its rows at or past n encode and read the
//   view bias of ray n - 1 (wg_encode / wg_layer with CLAMP), so they read
//   nothing beyond the rays, and are never stored; the caller passes the
//   rays unpadded. A row's value depends only on its row.
// - Each lane stores the values it holds straight to device memory.
// - Built with --fmad=false and the accurate sinf/expf, as the other field
//   kernels.

#include "field_wgmma.cuh"

namespace {

// Shared memory (bytes): the field's ring, buffers and barriers
// (field_wgmma.cuh), then the head's and the torso's biases.
constexpr int SM_BIAS_H = SMW_FIELD_END;              // head bias blob [B_END]
constexpr int SM_BIAS_T = SM_BIAS_H + B_END * 4;      // torso bias blob [TORSO_BEND]
constexpr int SMEM_BYTES = SM_BIAS_T + TORSO_BEND * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const float *o_h, *d_h;     // head rays [n][3]
  const float *o_t, *d_t;     // torso rays [n][3]
  float far;
  const bf16* vr;             // [n][256] torso view bias
  const float *freq, *phase;  // [64]
  const bf16 *w_h, *w_t;      // staged weight blobs
  const float *b_h, *b_t;     // bias blobs
  float *sh, *ct;             // [n], [n][3]
  int n, softplus;
};

// The staged weight blob w, made opaque to the compiler once per chunk:
// left visible, ptxas may hoist narrow8's per-thread weight addresses out of
// the chunk loop and spill them (render_head.cu).
__device__ __forceinline__ const bf16* opaque(const bf16* w) {
  asm volatile("" : "+l"(w));
  return w;
}

// sh of the chunk's rays ray0 .. ray0 + 127 (those below n): the head's
// trunk at the far plane and its sigma column. The next walk's encode
// rewrites P only after the trunk's last barrier, and its first layer
// rewrites the warp's rows of H (read by narrow8 here) only after the
// encode's barrier.
__device__ __forceinline__ void far_head_chunk(const Params& p, bf16* H, bf16* P, const float* b,
                                               int ray0, Ring& r) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3, t = tid & 127, row0 = wg * WG_ROWS;
  const int g = lane >> 2, q = lane & 3;
  wg_encode<true>(P, p.o_h, p.d_h, p.far, p.freq, p.phase, ray0, row0, t, p.n);
  wg_sync(wg);
  wg_trunk<PEW>(H, P, b, r, wg, wi, lane);
  float x[4];
  narrow8(x, H, opaque(p.w_h) + Staged<PEW>::SIGW, warp, lane);
  if (q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ray = ray0 + warp * 16 + g + h * 8;
      if (ray < p.n) p.sh[ray] = density_act(x[2 * h] + b[B_SF], p.softplus);
    }
  }
}

// ct of the chunk's rays below n: the torso's deform net and trunk at the
// far plane, the view feature (in place over h) and the rgb columns.
__device__ __forceinline__ void far_torso_chunk(const Params& p, bf16* H, bf16* P, const float* b,
                                                int ray0, Ring& r) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3, t = tid & 127, row0 = wg * WG_ROWS;
  const int g = lane >> 2, q = lane & 3;
  wg_encode<true>(P, p.o_t, p.d_t, p.far, p.freq, p.phase, ray0, row0, t, p.n);
  wg_sync(wg);
  wg_deform(H, P, b, r, wg, wi, lane);
  wg_trunk<DEF>(H, P, b, r, wg, wi, lane);
  wg_layer<HID, HID, VIEW, 0, true>(H, LDH, b + B_SF + 128, H, LDH, nullptr, nullptr, p.vr, ray0,
                                    r, row0, wi, lane, p.n);
  wg_sync(wg);
  float x[4];
  narrow8(x, H, opaque(p.w_t) + Staged<DEF>::OUTW, warp, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ray = ray0 + warp * 16 + g + h * 8;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = q * 2 + e;
      if (c < 3 && ray < p.n)
        p.ct[ray * 3 + c] = 1.f / (1.f + expf(-(x[2 * h + e] + b[B_OUT + c])));
    }
  }
}

// The block's chunks, head walk then torso walk for each (either may be
// left out).
template <bool HEAD, bool TORSO>
__device__ __forceinline__ void far_block(const Params& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H = reinterpret_cast<bf16*>(smem + SMW_H);
  bf16* P = reinterpret_cast<bf16*>(smem + SMW_P);
  float* b_h = reinterpret_cast<float*>(smem + SM_BIAS_H);
  float* b_t = reinterpret_cast<float*>(smem + SM_BIAS_T);
  // chunks blockIdx.x, blockIdx.x + gridDim.x, ... below n_chunks; the
  // producer and the consumers both take this count
  const int n_chunks = (p.n + M - 1) / M;
  const int mine = (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;

  if constexpr (HEAD) stage_biases(b_h, p.b_h, B_END);
  if constexpr (TORSO) stage_biases(b_t, p.b_t, TORSO_BEND);
  Ring ring;
  ring.init(smem);
  ring_init(smem);
  if (threadIdx.x >= NCONS) {  // the producer warp
    if (threadIdx.x == NCONS) {
#pragma unroll 1
      for (int i = 0; i < mine; ++i) {
        if constexpr (HEAD) ring.produce(p.w_h, NS_HEAD_TRUNK, 1);
        if constexpr (TORSO) ring.produce(p.w_t, NS_TORSO, 1);
      }
    }
    return;
  }
#pragma unroll 1
  for (int i = 0; i < mine; ++i) {
    const int ray0 = (blockIdx.x + i * gridDim.x) * M;
    if constexpr (HEAD) far_head_chunk(p, H, P, b_h, ray0, ring);
    if constexpr (TORSO) far_torso_chunk(p, H, P, b_t, ray0, ring);
  }
}

__global__ void __launch_bounds__(NTHR_W, 1) far_head_kernel(const Params p) {
  far_block<true, false>(p);
}

__global__ void __launch_bounds__(NTHR_W, 1) far_torso_kernel(const Params p) {
  far_block<false, true>(p);
}

__global__ void __launch_bounds__(NTHR_W, 1) far_joint_kernel(const Params p) {
  far_block<true, true>(p);
}

// One block per SM, or per chunk where there are fewer chunks.
int launch(void (*kernel)(const Params), const Params& p, void* stream) {
  if (p.n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (p.n + M - 1) / M;
  const int grid = n_chunks < sms ? n_chunks : sms;
  kernel<<<grid, NTHR_W, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head staged weight and
// bias blob lengths, torso staged weight and bias blob lengths (ops/_build.py
// ring_blob; far_head reads the head's trunk slabs and sigma rows, far_torso
// the torso's slabs and rgb rows), dynamic shared memory.
int far_eval_layout(int* sizes) {
  sizes[0] = Staged<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = Staged<DEF>::END;
  sizes[3] = TORSO_BEND;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// far_head (torso = 0: out = sh [n]) or far_torso (torso = 1: out = ct
// [n][3], vr = the torso view bias [n][256]) on `stream`; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for n <= 0).
int far_eval_launch(int torso, const float* o, const float* d, float far, const void* vr,
                    const float* freq, const float* phase, const void* w, const float* b,
                    float* out, int n, int softplus, void* stream) {
  Params p = {};
  p.far = far;
  p.freq = freq;
  p.phase = phase;
  p.n = n;
  p.softplus = softplus;
  if (torso) {
    p.o_t = o;
    p.d_t = d;
    p.vr = static_cast<const bf16*>(vr);
    p.w_t = static_cast<const bf16*>(w);
    p.b_t = b;
    p.ct = out;
    return launch(far_torso_kernel, p, stream);
  }
  p.o_h = o;
  p.d_h = d;
  p.w_h = static_cast<const bf16*>(w);
  p.b_h = b;
  p.sh = out;
  return launch(far_head_kernel, p, stream);
}

// far_joint on `stream`: sh [n] of the head rays (o, d) and ct [n][3] of the
// torso rays (o_t, d_t, torso view bias vr); returns the cudaError_t of the
// launch (cudaErrorInvalidValue for n <= 0).
int far_joint_launch(const float* o, const float* d, const float* o_t, const float* d_t,
                     float far, const void* vr, const float* freq, const float* phase,
                     const void* w_h, const float* b_h, const void* w_t, const float* b_t,
                     float* sh, float* ct, int n, int softplus, void* stream) {
  Params p = {};
  p.o_h = o;
  p.d_h = d;
  p.o_t = o_t;
  p.d_t = d_t;
  p.far = far;
  p.vr = static_cast<const bf16*>(vr);
  p.freq = freq;
  p.phase = phase;
  p.w_h = static_cast<const bf16*>(w_h);
  p.b_h = b_h;
  p.w_t = static_cast<const bf16*>(w_t);
  p.b_t = b_t;
  p.sh = sh;
  p.ct = ct;
  p.n = n;
  p.softplus = softplus;
  return launch(far_joint_kernel, p, stream);
}

}  // extern "C"
