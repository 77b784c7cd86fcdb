// Dense head+torso volume-render kernel for Hopper (sm_90a).
//
// Replaces: dfanerf_tpu/ops/fused_render.py _render_kernel (the Pallas TPU
// kernel behind fused_render_rays). Its plain PyTorch version is
// dfanerf_torch/ops/fused_render.py fused_render_rays_reference.
//
// What it computes. For every ray of a 256-ray tile and every sample z of
// each 8-sample slab, both frame-folded fields (ops/pack.py) are evaluated:
//   torso: deform MLP 64 -> 128 (x4, PE skip at block 2) -> + sig_pad + pe
//          -> trunk;  head: trunk on the PE directly;
//   trunk: input layer + 7 relu blocks of 256, PE skip after block 3, fused
//          256 -> 384 output (sigma col 0, view feature cols 128:384);
//   colour: sigmoid(W_out . relu(feature + view_bias)), only cols 0:3.
// Then the head-only stack and the composite stack are composited in fp32,
// sample by sample. A slab is skipped when the tile's max transmittance over
// both stacks is <= ert_eps (early ray termination) or its occupancy flag is
// 0.
//
// Six instantiations of render_rays_kernel<EVAL_H, EVAL_T, BG_IN_KERNEL>,
// every combination of the TPU kernel's static eval_head / eval_torso /
// bg_in_kernel:
// - <true, true, true>: both fields, the reference's bg-concat rules at the
//   final sample, the last slab always run (fields="both");
// - <true, false, true>, <false, true, true>: one field with the same rules
//   (fields="head" or "torso" without the epilogue). At the final sample the
//   head colour is the background pixel, the head stack's density gets its
//   1e-6 bump and the composite's torso density becomes 1e-6 whichever field
//   runs: without the head the composite's last sample is the torso colour
//   and the head stack's the background;
// - <true, true, false>, <true, false, false>, <false, true, false>: the
//   epilogue mode of the occupancy serving paths (bg_epilogue=True): no
//   sample gets the bg rules and the last slab is not forced (the caller's
//   dists make the final sample a no-op), and the per-ray transmittances are
//   written beside the sums for the caller's epilogue.
// A field left out (the per-field tile classes) runs no MLP and counts as
// sigma 0, rgb 0 in both stacks.
//
// What bounds it on the H100. About 2.4 MFLOP of matrix products per
// (ray, sample) for the two fields at their live widths (2.5 at the
// kernel's padded ones) against a few tens of bytes of per-ray
// input: the work is bound by operations (bf16 tensor-core rate), not by
// device memory. The TPU kernel keeps all ~2.3 MB of packed weights resident
// in VMEM; a Hopper block has 227 KB of shared memory, so the weights cannot
// stay on chip and stream from L2 once per 128-row chunk: 2.49 MB a chunk
// for both fields (the staged blobs' ring slabs), ~250 GB for a 450x450
// frame of 64 samples, so at the 33 ms operation bound the L2 would have to
// deliver ~7.5 TB/s. L2 bandwidth, not the tensor cores, is this design's
// floor (perf/probe_render_rays.py prints the rate reached).
//
// Design (the field's device code is field_wgmma.cuh, shared with
// pair_field.cu; its note says what bounded the mma.sync design and what the
// wgmma core does about it):
// - One block per 256-ray tile: two consumer warpgroups and a producer warp
//   that streams both fields' weight slabs through a 5-stage shared-memory
//   ring (cp.async.bulk, mbarriers); both fields' biases are staged into
//   shared memory once per block. The TPU's sequential slab grid axis and
//   its scratch carry become a loop over the slabs inside the block; the
//   per-ray transmittances and rgb sums live in shared memory, and the ERT
//   test at each slab start is a block-wide max over the 256 rays, the one
//   block-wide step, so the kernel skips exactly the slabs the TPU kernel
//   skips. The producer takes part in it and issues a slab's weights only
//   once the slab is known to run, so no copy is left in flight at the end.
// - A slab (8 samples x 256 rays = 2048 rows, sample-major) runs in chunks
//   of 128 rows (one sample, half the rays). Each warpgroup owns 64 rows of
//   the chunk and runs the whole MLP chain of each field on them (wgmma
//   m64n256k16 / m64n128k16, A through ldmatrix from one activation buffer
//   updated in place, B from the ring), separated by its own named
//   barriers; then composites its 64 rays' sample straight away, since
//   every chunk of sample s precedes every chunk of sample s + 1.
// - Activations are rounded to bf16 exactly where the TPU kernel rounds
//   them; sigma, alphas, transmittances and sums stay fp32.
// - Built with --fmad=false: no mul+add is contracted into an FMA, so the
//   PE argument (o + d*z)*freq + phase, which reaches ~500 rad, and the
//   compositing recurrences round as in the plain version. sinf/expf are
//   the accurate library functions (never --use_fast_math).


#include "field_wgmma.cuh"

namespace {

// Shared memory (bytes): the field's ring, buffers and barriers
// (field_wgmma.cuh), both fields' biases, then the compositing state.
constexpr int SM_BIAS_H = SMW_FIELD_END;            // head bias blob [B_END]
constexpr int SM_BIAS_T = SM_BIAS_H + B_END * 4;    // torso bias blob [TORSO_BEND]
constexpr int SM_STATE = SM_BIAS_T + TORSO_BEND * 4;  // t_head, t_com [RT]
constexpr int SM_ACC = SM_STATE + 2 * RT * 4;      // acc_h, acc_c [RT][3]
constexpr int SM_RES = SM_ACC + 2 * RT * 3 * 4;    // sig_h, sig_t [M]; rgb_h, rgb_t [M][3]
constexpr int SM_RED = SM_RES + 2 * M * 4 * 4;     // one float per consumer warp
constexpr int SMEM_BYTES = SM_RED + NCONS / 32 * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const float *o_h, *d_h, *o_t, *d_t;  // [n_pad][3]
  const float* z;                      // [S]
  const float *dists_h, *dists_t;      // [S][n_pad]
  const bf16 *vr_h, *vr_t;             // [n_pad][256]
  const float* bc;                     // [n_pad][3]
  const float *freq, *phase;           // [64]
  const int* occ;                      // [T][J]
  const bf16 *w_h, *w_t;               // staged weight blobs
  const float *b_h, *b_t;              // bias blobs
  float *out_h, *out_c;                // [n_pad][3]
  int* slabs;                          // [T] slabs evaluated per tile
  int n_tiles, n_slabs, softplus;
  float ert_eps;
  float *t_out_h, *t_out_c;            // [n_pad] transmittances (epilogue mode)
};

template <bool EVAL_H, bool EVAL_T, bool BG_IN_KERNEL>
__global__ void __launch_bounds__(NTHR_W, 1) render_rays_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H = reinterpret_cast<bf16*>(smem + SMW_H);
  bf16* P = reinterpret_cast<bf16*>(smem + SMW_P);
  float* t_head = reinterpret_cast<float*>(smem + SM_STATE);
  float* t_com = t_head + RT;
  float* acc_h = reinterpret_cast<float*>(smem + SM_ACC);
  float* acc_c = acc_h + RT * 3;
  float* sig_h = reinterpret_cast<float*>(smem + SM_RES);
  float* sig_t = sig_h + M;
  float* rgb_h = sig_t + M;
  float* rgb_t = rgb_h + M * 3;
  float* red = reinterpret_cast<float*>(smem + SM_RED);
  float* b_h = reinterpret_cast<float*>(smem + SM_BIAS_H);
  float* b_t = reinterpret_cast<float*>(smem + SM_BIAS_T);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, t = tid & 127, row0 = wg * WG_ROWS;
  const int tile = blockIdx.x;
  const int J = p.n_slabs;
  const int n_pad = p.n_tiles * RT;

  if (tid < RT) {
    t_head[tid] = 1.f;
    t_com[tid] = 1.f;
    for (int c = 0; c < 3; ++c) {
      acc_h[tid * 3 + c] = 0.f;
      acc_c[tid * 3 + c] = 0.f;
    }
  }
  if constexpr (EVAL_H) stage_biases(b_h, p.b_h, B_END);
  if constexpr (EVAL_T) stage_biases(b_t, p.b_t, TORSO_BEND);
  Ring ring;
  ring.init(smem);
  ring_init(smem);
  int n_run = 0;

#pragma unroll 1
  for (int j = 0; j < J; ++j) {
    const bool is_last = j == J - 1;
    __syncthreads();
    float m = tid < RT ? fmaxf(t_head[tid], t_com[tid]) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0 && tid < NCONS) red[warp] = m;
    __syncthreads();
    float mx = red[0];
#pragma unroll
    for (int w = 1; w < NCONS / 32; ++w) mx = fmaxf(mx, red[w]);
    // red is written again only after the next slab's first barrier
    const bool alive = (mx > p.ert_eps && p.occ[tile * J + j] != 0) || (BG_IN_KERNEL && is_last);
    if (!alive) continue;
    ++n_run;

    if (tid >= NCONS) {  // the producer warp: this slab's chunks' weights
      if (tid == NCONS) {
#pragma unroll 1
        for (int c = 0; c < 2 * SS; ++c) {
          if constexpr (EVAL_H) ring.produce(p.w_h, NS_HEAD, 1);
          if constexpr (EVAL_T) ring.produce(p.w_t, NS_TORSO, 1);
        }
      }
      __syncwarp();
      continue;
    }

#pragma unroll 1
    for (int c = 0; c < 2 * SS; ++c) {
      const int s = c >> 1;
      const int r0 = (c & 1) * M;
      const int ray0 = tile * RT + r0;
      const int sg = j * SS + s;
      const float zs = p.z[sg];

      // head field
      if constexpr (EVAL_H) {
        wg_encode(P, p.o_h, p.d_h, zs, p.freq, p.phase, ray0, row0, t);
        wg_sync(wg);
        wg_trunk_and_heads<PEW>(H, P, p.w_h, b_h, p.vr_h, ray0, p.softplus, sig_h, rgb_h,
                                ring, wg, warp, lane);
      }

      // torso field: deform, then the trunk on p' = deform + sig_pad + pe
      if constexpr (EVAL_T) {
        wg_encode(P, p.o_t, p.d_t, zs, p.freq, p.phase, ray0, row0, t);
        wg_sync(wg);
        wg_deform(H, P, b_t, ring, wg, warp & 3, lane);
        wg_trunk_and_heads<DEF>(H, P, p.w_t, b_t, p.vr_t, ray0, p.softplus, sig_t, rgb_t,
                                ring, wg, warp, lane);
      }
      wg_sync(wg);

      // composite sample s of the warpgroup's 64 rays
      if (t < WG_ROWS) {
        const int row = row0 + t;
        const int r = r0 + row;
        const int gr = tile * RT + r;
        const float lastf = (BG_IN_KERNEL && is_last && s == SS - 1) ? 1.f : 0.f;
        const float sh = EVAL_H ? sig_h[row] : 0.f, st = EVAL_T ? sig_t[row] : 0.f;
        const float dh = p.dists_h[sg * n_pad + gr], dt = p.dists_t[sg * n_pad + gr];
        const float sh_head = sh + 1e-6f * lastf;
        const float st_com = st * (1.f - lastf) + 1e-6f * lastf;
        const float th = t_head[r], tc = t_com[r];
        const float alpha_h = 1.f - expf(-(sh_head + 1e-6f) * dh);
        const float ssum = sh + st_com;
        const float denom = ssum == 0.f ? 1e-4f : ssum;
        const float alpha_c = 1.f - expf(-(ssum + 1e-6f) * dt);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ch =
              (EVAL_H ? rgb_h[row * 3 + k] : 0.f) * (1.f - lastf) + p.bc[gr * 3 + k] * lastf;
          const float ct = EVAL_T ? rgb_t[row * 3 + k] : 0.f;
          acc_h[r * 3 + k] = acc_h[r * 3 + k] + (alpha_h * th) * ch;
          const float c_mix = (sh * ch + st_com * ct) / denom;
          acc_c[r * 3 + k] = acc_c[r * 3 + k] + (alpha_c * tc) * c_mix;
        }
        t_head[r] = th * (1.f - alpha_h + 1e-10f);
        t_com[r] = tc * (1.f - alpha_c + 1e-10f);
      }
      // the next chunk's head pass rewrites the warpgroup's sig/rgb rows
      // only after several of its barriers
    }
  }
  __syncthreads();
  if (tid < RT) {
    const int gr = tile * RT + tid;
    for (int k = 0; k < 3; ++k) {
      p.out_h[gr * 3 + k] = acc_h[tid * 3 + k];
      p.out_c[gr * 3 + k] = acc_c[tid * 3 + k];
    }
    if constexpr (!BG_IN_KERNEL) {
      p.t_out_h[gr] = t_head[tid];
      p.t_out_c[gr] = t_com[tid];
    }
  }
  if (tid == 0) p.slabs[tile] = n_run;
}

template <bool EVAL_H, bool EVAL_T, bool BG_IN_KERNEL>
int launch(const Params& p, void* stream) {
  const auto kernel = render_rays_kernel<EVAL_H, EVAL_T, BG_IN_KERNEL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.n_tiles, NTHR_W, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its blobs against: head staged weight and
// bias blob lengths, torso staged weight and bias blob lengths (ops/_build.py
// ring_blob), dynamic shared memory.
int render_rays_layout(int* sizes) {
  sizes[0] = Staged<PEW>::END;
  sizes[1] = B_END;
  sizes[2] = Staged<DEF>::END;
  sizes[3] = TORSO_BEND;
  sizes[4] = SMEM_BYTES;
  return 0;
}

// Launches the instantiation <eval_h, eval_t, bg_in_kernel> on `stream`;
// returns the cudaError_t of the launch (cudaErrorInvalidValue when neither
// field is evaluated). t_h and t_c [n_pad] take the
// transmittances without bg_in_kernel and are not read with it.
int render_rays_launch(const float* o_h, const float* d_h, const float* o_t, const float* d_t,
                       const float* z, const float* dists_h, const float* dists_t,
                       const void* vr_h, const void* vr_t, const float* bc, const float* freq,
                       const float* phase, const int* occ, const void* w_h, const float* b_h,
                       const void* w_t, const float* b_t, float* out_h, float* out_c,
                       int* slabs, float* t_h, float* t_c, int n_tiles, int n_slabs,
                       float ert_eps, int softplus, int eval_h, int eval_t, int bg_in_kernel,
                       void* stream) {
  Params p;
  p.o_h = o_h;
  p.d_h = d_h;
  p.o_t = o_t;
  p.d_t = d_t;
  p.z = z;
  p.dists_h = dists_h;
  p.dists_t = dists_t;
  p.vr_h = static_cast<const bf16*>(vr_h);
  p.vr_t = static_cast<const bf16*>(vr_t);
  p.bc = bc;
  p.freq = freq;
  p.phase = phase;
  p.occ = occ;
  p.w_h = static_cast<const bf16*>(w_h);
  p.w_t = static_cast<const bf16*>(w_t);
  p.b_h = b_h;
  p.b_t = b_t;
  p.out_h = out_h;
  p.out_c = out_c;
  p.slabs = slabs;
  p.n_tiles = n_tiles;
  p.n_slabs = n_slabs;
  p.softplus = softplus;
  p.ert_eps = ert_eps;
  p.t_out_h = t_h;
  p.t_out_c = t_c;
  if (bg_in_kernel) {
    if (eval_h && eval_t) return launch<true, true, true>(p, stream);
    if (eval_h) return launch<true, false, true>(p, stream);
    if (eval_t) return launch<false, true, true>(p, stream);
  } else if (eval_h && eval_t) {
    return launch<true, true, false>(p, stream);
  } else if (eval_h) {
    return launch<true, false, false>(p, stream);
  } else if (eval_t) {
    return launch<false, true, false>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
