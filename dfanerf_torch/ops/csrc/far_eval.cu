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
// - far_joint: far_head then far_torso on the same 128 rays in one block,
//   through the same device code, so it equals the two bit for bit.
// Outputs are sh [n] and ct [n][3] in fp32; the TPU kernels' [n, 8]
// broadcast outputs were a lane layout, not part of the function.
//
// What bounds them on the H100. ~1.1 MFLOP (head, sigma only) and ~1.3
// MFLOP (torso, colour only) of matrix products per ray against ~30 bytes
// of per-ray input and 4-12 bytes of output: bound by operations.
//
// Design: one block of 8 warps per 128-ray chunk (grid = ceil(n / 128)),
// running the shared field code of field_mlp.cuh. The last chunk may be
// ragged: its rays past n read no input (GUARD) and write nothing, so the
// caller passes the rays unpadded.

#include "field_mlp.cuh"

namespace {

constexpr int SM_OUT = SM_FIELD_END;           // sigma [M] or rgb [M][3]
constexpr int SMEM_BYTES = SM_OUT + M * 3 * 4;

struct Params {
  const float *o, *d;         // [n][3]
  float far;
  const bf16* vr;             // [n][256] torso view bias (far_torso, far_joint)
  const float *freq, *phase;  // [64]
  const bf16* w;              // weight blob of the field (far_joint: the head's)
  const float* b;             // bias blob of the field (far_joint: the head's)
  float* out;                 // far_head, far_joint: sh [n]; far_torso: ct [n][3]
  int n, softplus;
  // far_joint only: the torso's rays [n][3], blobs and colour ct [n][3]
  const float *o_t, *d_t;
  const bf16* w_t;
  const float* b_t;
  float* out_t;
};

__global__ void __launch_bounds__(NTHR, 1) far_head_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* Y = reinterpret_cast<bf16*>(smem + SM_Y);
  bf16* P = reinterpret_cast<bf16*>(smem + SM_P);
  float* sig = reinterpret_cast<float*>(smem + SM_OUT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = blockIdx.x * M;

  encode<true>(P, p.o, p.d, p.far, p.freq, p.phase, ray0, tid, p.n);
  __syncthreads();
  bf16* spare;
  const bf16* h = trunk<PEW>(X, Y, P, p.w, p.b, warp, lane, spare);
  sigma_head<PEW>(h, p.w, p.b, p.softplus, sig, warp, lane);
  __syncthreads();
  if (tid < M && ray0 + tid < p.n) p.out[ray0 + tid] = sig[tid];
}

__global__ void __launch_bounds__(NTHR, 1) far_torso_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* Y = reinterpret_cast<bf16*>(smem + SM_Y);
  bf16* P = reinterpret_cast<bf16*>(smem + SM_P);
  float* rgb = reinterpret_cast<float*>(smem + SM_OUT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = blockIdx.x * M;

  encode<true>(P, p.o, p.d, p.far, p.freq, p.phase, ray0, tid, p.n);
  __syncthreads();
  deform(X, Y, P, p.w, p.b, warp, lane);
  bf16* spare;
  const bf16* h = trunk<DEF>(X, Y, P, p.w, p.b, warp, lane, spare);
  color_head<DEF, true>(h, spare, p.w, p.b, p.vr, ray0, rgb, warp, lane, p.n);
  __syncthreads();
  for (int idx = tid; idx < M * 3; idx += NTHR) {
    if (ray0 + idx / 3 < p.n) p.out[ray0 * 3 + idx] = rgb[idx];
  }
}

__global__ void __launch_bounds__(NTHR, 1) far_joint_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* Y = reinterpret_cast<bf16*>(smem + SM_Y);
  bf16* P = reinterpret_cast<bf16*>(smem + SM_P);
  float* res = reinterpret_cast<float*>(smem + SM_OUT);  // sigma [M], then rgb [M][3]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = blockIdx.x * M;

  encode<true>(P, p.o, p.d, p.far, p.freq, p.phase, ray0, tid, p.n);
  __syncthreads();
  bf16* spare;
  const bf16* h = trunk<PEW>(X, Y, P, p.w, p.b, warp, lane, spare);
  sigma_head<PEW>(h, p.w, p.b, p.softplus, res, warp, lane);
  __syncthreads();
  if (tid < M && ray0 + tid < p.n) p.out[ray0 + tid] = res[tid];

  // the torso pass rewrites P, X, Y and res only after the barriers below
  encode<true>(P, p.o_t, p.d_t, p.far, p.freq, p.phase, ray0, tid, p.n);
  __syncthreads();
  deform(X, Y, P, p.w_t, p.b_t, warp, lane);
  h = trunk<DEF>(X, Y, P, p.w_t, p.b_t, warp, lane, spare);
  color_head<DEF, true>(h, spare, p.w_t, p.b_t, p.vr, ray0, res, warp, lane, p.n);
  __syncthreads();
  for (int idx = tid; idx < M * 3; idx += NTHR) {
    if (ray0 + idx / 3 < p.n) p.out_t[ray0 * 3 + idx] = res[idx];
  }
}

int launch(void (*kernel)(const Params), const Params& p, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(p.n + M - 1) / M, NTHR, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head weight and bias
// blob lengths, torso weight and bias blob lengths, dynamic shared memory.
int far_eval_layout(int* sizes) {
  sizes[0] = WOff<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = TORSO_WEND;
  sizes[3] = TORSO_BEND;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// far_head (torso = 0: out = sh [n]) or far_torso (torso = 1: out = ct
// [n][3], vr = the torso view bias [n][256]) on `stream`; returns the
// cudaError_t of the launch.
int far_eval_launch(int torso, const float* o, const float* d, float far, const void* vr,
                    const float* freq, const float* phase, const void* w, const float* b,
                    float* out, int n, int softplus, void* stream) {
  Params p = {};
  p.o = o;
  p.d = d;
  p.far = far;
  p.vr = static_cast<const bf16*>(vr);
  p.freq = freq;
  p.phase = phase;
  p.w = static_cast<const bf16*>(w);
  p.b = b;
  p.out = out;
  p.n = n;
  p.softplus = softplus;
  return launch(torso ? far_torso_kernel : far_head_kernel, p, stream);
}

// far_joint on `stream`: sh [n] of the head rays (o, d) and ct [n][3] of the
// torso rays (o_t, d_t, torso view bias vr); returns the cudaError_t of the
// launch.
int far_joint_launch(const float* o, const float* d, const float* o_t, const float* d_t,
                     float far, const void* vr, const float* freq, const float* phase,
                     const void* w_h, const float* b_h, const void* w_t, const float* b_t,
                     float* sh, float* ct, int n, int softplus, void* stream) {
  Params p = {};
  p.o = o;
  p.d = d;
  p.o_t = o_t;
  p.d_t = d_t;
  p.far = far;
  p.vr = static_cast<const bf16*>(vr);
  p.freq = freq;
  p.phase = phase;
  p.w = static_cast<const bf16*>(w_h);
  p.b = b_h;
  p.w_t = static_cast<const bf16*>(w_t);
  p.b_t = b_t;
  p.out = sh;
  p.out_t = ct;
  p.n = n;
  p.softplus = softplus;
  return launch(far_joint_kernel, p, stream);
}

}  // extern "C"
