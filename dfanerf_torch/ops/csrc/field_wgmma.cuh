// The wgmma device core of every field kernel of the port: dense, pair,
// per-ray-depth, density-only, far-plane and node-grid (render_rays.cu,
// pair_field.cu, render_head.cu, pair_perz.cu, sigma_head.cu, pair_hier.cu,
// far_eval.cu, node_grid.cu):
// one packed, frame-folded field (ops/pack.py, layout in field_common.cuh)
// evaluated over a chunk of 128 rows by two consumer warpgroups, with the
// weights fed by a producer warp through a ring of shared-memory stages.
//
// What bounded the port's first core (mma.sync m16n8k16, eight warps each
// owning 32 output columns of all 128 rows), and what this one does about
// each:
// 1. Weights streamed from L2 by every warp, one k-step ahead, with one
//    8-warp block per SM: half the dense kernel's time was waiting on them
//    (perf/probe_render_rays.py). Here one thread copies each weight k-slab
//    once per chunk into the ring with cp.async.bulk, DEPTH slabs ahead,
//    completing on the stage's "full" mbarrier; the ring runs on across
//    layer and chunk boundaries (a field's weight sequence is the same for
//    every chunk), so the next layer's first slabs land during the current
//    epilogue.
// 2. Every warp re-read the whole A operand (all 128 rows) at every layer.
//    Here each warpgroup owns 64 of the chunk's rows and all N columns of a
//    layer (m64nNk16, N = 256 in the trunk, 128 in the deform net: 128 or
//    64 fp32 accumulators a thread), so each activation is read once per
//    layer, through ldmatrix into registers (wgmma's A-from-registers
//    form), out of padded row-major buffers. A warp's A fragment and its
//    accumulator cover the same 16 rows, so a layer reads and writes only
//    its own warp's rows and runs in place: one activation buffer H instead
//    of the first core's two, which leaves room for a 5-stage ring and
//    the field's biases.
// 3. The epilogue (bias, relu, rounding, store) runs once the warpgroup's
//    chain has drained, and both warpgroups reach it together: they share
//    every ring stage. It is kept short: the field's biases are staged once
//    per block into shared memory and loaded as float2 in batches of EG
//    column groups ahead of the batch's stores (the view bias or PE it adds
//    likewise), and relu is fused into the bf16 conversion. The drain and
//    the epilogue's arithmetic still take about half the kernel's time;
//    overlapping them with another accumulator's products either had ptxas
//    serialise the wgmmas or lengthened every step by more than it hid
//    (measured in PERF.md, section 6).
// 4. Block-wide barriers between layers. A warpgroup produces every column
//    of its own rows, so a layer depends only on its own warpgroup's
//    previous layer: named barriers of 128 threads (wg_sync) separate the
//    layers, and the two warpgroups drift apart by up to the ring's depth.
//    Both consume every stage; a stage is refilled only when all eight
//    consumer warps have released it ("empty" mbarrier, 8 arrivals).
//
// Producer: one extra warp (288 threads), lane 0 issuing the copies. At 288
// threads a block may have 224 registers a thread (9 warps x 32 x 224 =
// 64,512 of 65,536) without setmaxnreg, against the 232 that a producer
// warpgroup with setmaxnreg would leave the consumers; and an elected
// consumer thread as producer would stall its warpgroup's wgmma issue on the
// other warpgroup's releases.
//
// The ring's stage is SLAB bf16 values: a [256 out][32 in] or [128][64]
// k-slab of one layer's [out][in] matrix, laid out in wgmma's no-swizzle
// K-major canonical form (8 x 8 core matrices of 128 contiguous bytes; along
// K the next core matrix 128 B on, along N the next 8 rows KS/8 x 128 B on).
// ops/_build.py ring_blob stages each field's blob into that order once on
// the host: the field's slabs in the order the chunk consumes them, then the
// sigma rows 0:8 of w_sf and the rgb rows 0:8 of w_out as [8][256], read by
// narrow8 (mma.sync, straight from L2: 16 KB a chunk).
//
// Numerics: bf16 operands, fp32 sums (in wgmma's own order inside a k16
// step), activations rounded to bf16 where the TPU kernels round them, sigma
// and the colour sigmoid fp32.

#pragma once

#include "field_common.cuh"

namespace {

constexpr int NWG = 2;                     // consumer warpgroups
constexpr int NCONS = NWG * 128;           // consumer threads
constexpr int NTHR_W = NCONS + 32;         // and the producer warp
constexpr int WG_ROWS = M / NWG;           // a warpgroup's rows of a chunk
constexpr int SLAB = 8192;                 // bf16 values of one ring stage
constexpr int SLAB_BYTES = SLAB * 2;
constexpr int DEPTH = 5;                   // ring stages

constexpr int slabs(int k, int n) { return k * n / SLAB; }
// Ring slabs a chunk consumes, per field: the head's trunk (input layer,
// blocks 0-3, skip, blocks 4-6, view feature); the torso's deform net (d_w1,
// d_wk 0-2, d_wskip, d_wk 3, d_wout), then its trunk. A density-only chunk
// of the head (wg_sigma_walk) consumes the first NS_HEAD_TRUNK of the head's
// slabs: the view feature's come last and are never copied.
constexpr int NS_HEAD = 68;
constexpr int NS_HEAD_TRUNK = 60;
constexpr int NS_DEFORM = 12;
constexpr int NS_TORSO = 84;
static_assert(NS_HEAD == slabs(PEW, HID) + 7 * slabs(HID, HID) + slabs(PEW, HID) +
                             slabs(HID, HID), "head ring");
static_assert(NS_HEAD_TRUNK == NS_HEAD - slabs(HID, HID), "head trunk ring");
static_assert(NS_DEFORM == slabs(PEW, DEF) + 4 * slabs(DEF, DEF) + slabs(PEW, DEF) +
                               slabs(DEF, DEF), "deform ring");
static_assert(NS_TORSO == NS_DEFORM + slabs(DEF, HID) + 7 * slabs(HID, HID) + slabs(DEF, HID) +
                              slabs(HID, HID), "torso ring");

// Staged blob of a field (trunk input width KIN): NS slabs, then the sigma
// rows (SIGW) and the rgb rows (OUTW), [8][256] each.
template <int KIN>
struct Staged {
  static constexpr int NS = KIN == PEW ? NS_HEAD : NS_TORSO;
  static constexpr int SIGW = NS * SLAB;
  static constexpr int OUTW = SIGW + 8 * HID;
  static constexpr int END = OUTW + 8 * HID;
};

// Shared memory (bytes): the ring, the activation buffer H ([128 x 256]
// bf16, updated in place layer by layer) and P (PE / deformed input), the
// full[DEPTH] and empty[DEPTH] mbarriers; the kernel's own after them (its
// field biases first).
constexpr int SMW_RING = 0;
constexpr int SMW_H = SMW_RING + DEPTH * SLAB_BYTES;
constexpr int SMW_P = SMW_H + M * LDH * 2;
constexpr int SMW_BAR = SMW_P + M * LDP * 2;
constexpr int SMW_FIELD_END = SMW_BAR + 2 * DEPTH * 8;

// Copies a field's bias blob (n floats) into shared memory; the block's
// first barrier (ring_init's) publishes it.
__device__ __forceinline__ void stage_biases(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NTHR_W) dst[i] = src[i];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// cp.async.bulk of `bytes` from global src to shared dst, completing on bar,
// which expects them.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The ring as one thread sees it: the next stage it fills (producer) or
// reads (consumers), and that stage's phase parity. Producer and consumers
// walk the same sequence of stages.
struct Ring {
  uint32_t base, bar;  // shared addresses of stage 0 and of full[0]
  int stage;
  uint32_t phase;

  __device__ __forceinline__ void init(unsigned char* smem) {
    base = smem_addr(smem + SMW_RING);
    bar = smem_addr(smem + SMW_BAR);
    stage = 0;
    phase = 0;
  }
  __device__ __forceinline__ uint32_t full(int s) const { return bar + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bar + 8 * (DEPTH + s); }
  __device__ __forceinline__ void next() {
    if (++stage == DEPTH) {
      stage = 0;
      phase ^= 1;
    }
  }
  // consumer: wait until the current stage has landed; its shared address
  __device__ __forceinline__ uint32_t wait() const {
    mbar_wait(full(stage), phase);
    return base + stage * SLAB_BYTES;
  }
  // consumer warp: done with stage s (its products have completed)
  __device__ __forceinline__ void release(int s, int lane) const {
    if (lane == 0) mbar_arrive(empty(s));
  }
  // producer (one thread): n_chunks times the ns slabs of the staged blob w,
  // each into the next stage once every consumer warp has released it
  __device__ __forceinline__ void produce(const bf16* w, int ns, int n_chunks) {
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
#pragma unroll 1
      for (int i = 0; i < ns; ++i) {
        mbar_wait(empty(stage), phase ^ 1);
        bulk_load(base + stage * SLAB_BYTES, w + i * SLAB, SLAB_BYTES, full(stage));
        next();
      }
    }
  }
};

// Thread 0 initialises the ring's barriers; ends with a block-wide barrier.
__device__ __forceinline__ void ring_init(unsigned char* smem) {
  if (threadIdx.x == 0) {
    const Ring r = {smem_addr(smem + SMW_RING), smem_addr(smem + SMW_BAR), 0, 0};
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(r.full(s), 1);              // the producer's expect_tx arrival, then the bytes
      mbar_init(r.empty(s), NCONS / 32);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Named barrier of warpgroup wg's 128 threads (id 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16x2 of (lo, hi) rounded to nearest even, with relu fused into the
// conversion (relu(round(x)) = round(relu(x)); a zero may change sign).
__device__ __forceinline__ uint32_t bf16x2_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Matrix descriptor of a B tile in the no-swizzle K-major canonical layout:
// start address >> 4, leading byte offset (next core matrix along K) 128 B,
// stride byte offset (next 8 rows along N) sbo.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x N, wgmma's fragment layout) += A (64 x 16, registers) . B (16 x N
// from the descriptor); scale_d = 0 would overwrite d instead.
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// acc (the warpgroup's 64 rows x N columns) += A[rows, 0:K] . W^T with the
// K x N weight from the ring as K / KS slabs of depth KS = SLAB / N. A is
// the calling warp's 16 rows in shared memory (row stride lda), loaded
// through ldmatrix (the same fragment as mma.sync m16n8k16's A). One wgmma
// stays in flight while the next A fragment loads; a slab is released once
// the products reading it have completed.
template <int K, int N>
__device__ __forceinline__ void wg_gemm(float (&acc)[N / 2], const bf16* A, int lda, Ring& r,
                                        int lane) {
  constexpr int KS = SLAB / N, NSL = K / KS, KSTEP = KS / 16;
  constexpr uint32_t SBO = KS / 8 * 128;
  static_assert(K % KS == 0 && KS % 16 == 0, "layer depth");
  const bf16* arow = A + (lane & 15) * lda + (lane >> 4) * 8;
  int held = 0;
#pragma unroll
  for (int sl = 0; sl < NSL; ++sl) {
    const uint32_t stage = r.wait();
#pragma unroll
    for (int kk = 0; kk < KSTEP; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + sl * KS + kk * 16);
      wgmma_fence();
      wgmma_rs(acc, a, desc_b(stage + kk * 256, SBO), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (kk == 0 && sl > 0) r.release(held, lane);
    }
    held = r.stage;
    r.next();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  r.release(held, lane);
}

// One dense layer over warpgroup rows row0 .. row0 + 63 of the chunk, all N
// output columns; wi is the warp's index in its warpgroup. Each warp reads
// and writes only its own 16 rows, so `out` may be `A` (in place). MODE
// picks the epilogue:
//   RELU:       out = bf16(relu(A W^T + b))
//   SKIP:       out = bf16(relu(A W^T + b) + P Wp^T + bp)      (trunk block 3,
//               deform block 2; P has KP columns, Wp the ring's next slabs)
//   VIEW:       out = bf16(relu((A W^T + b) + vr[ray]))        (view feature)
//   DEFORM_OUT: out = bf16(((A W^T + b) + bp) + pe)  written in place over
//               the PE buffer `out` (pe = 0 beyond column 64; bp = sig_pad)
// With CLAMP, VIEW reads row `row`'s view bias at ray min(ray0 + row,
// n_rows - 1): the far-plane kernels' ragged last chunk, whose rows at or
// past n_rows read no ray beyond the last and are never stored.
template <int K, int N, int MODE, int KP = 0, bool CLAMP = false>
__device__ __forceinline__ void wg_layer(const bf16* A, int lda, const float* bias, bf16* out,
                                         int ldo, const bf16* P, const float* bp, const bf16* vr,
                                         int ray0, Ring& r, int row0, int wi, int lane,
                                         int n_rows = 0) {
  constexpr int EG = 8;  // column groups (of 8) whose operands load ahead of their stores
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int g = lane >> 2, q = lane & 3, rw = row0 + wi * 16;
  wg_gemm<K, N>(acc, A + rw * lda, lda, r, lane);
  if constexpr (MODE == SKIP) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + q * 2);
      acc[4 * j] = fmaxf(acc[4 * j] + bv.x, 0.f);
      acc[4 * j + 1] = fmaxf(acc[4 * j + 1] + bv.y, 0.f);
      acc[4 * j + 2] = fmaxf(acc[4 * j + 2] + bv.x, 0.f);
      acc[4 * j + 3] = fmaxf(acc[4 * j + 3] + bv.y, 0.f);
    }
    wg_gemm<KP, N>(acc, P + rw * LDP, LDP, r, lane);
  }
#pragma unroll
  for (int j0 = 0; j0 < N / 8; j0 += EG) {
    float2 b1[EG], b2[EG], ad[EG][2];
#pragma unroll
    for (int jj = 0; jj < EG; ++jj) {
      const int col = 8 * (j0 + jj) + q * 2;
      b1[jj] = *reinterpret_cast<const float2*>((MODE == SKIP ? bp : bias) + col);
      if (MODE == DEFORM_OUT) b2[jj] = *reinterpret_cast<const float2*>(bp + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + g + h * 8;
        ad[jj][h] = make_float2(0.f, 0.f);
        if (MODE == VIEW) {
          const int ray = CLAMP ? min(ray0 + row, n_rows - 1) : ray0 + row;
          ad[jj][h] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vr + ray * HID + col));
        }
        if (MODE == DEFORM_OUT && col < PEW)
          ad[jj][h] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(out + row * ldo + col));
      }
    }
#pragma unroll
    for (int jj = 0; jj < EG; ++jj) {
      const int j = j0 + jj, col = 8 * j + q * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + g + h * 8;
        const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
        uint32_t* dst = reinterpret_cast<uint32_t*>(out + row * ldo + col);
        uint32_t v;
        if (MODE == RELU) {
          v = bf16x2_relu(x0 + b1[jj].x, x1 + b1[jj].y);
        } else if (MODE == SKIP) {
          v = bf16x2(x0 + b1[jj].x, x1 + b1[jj].y);
        } else if (MODE == VIEW) {
          v = bf16x2_relu((x0 + b1[jj].x) + ad[jj][h].x, (x1 + b1[jj].y) + ad[jj][h].y);
        } else {  // DEFORM_OUT (pe = 0 beyond column 64)
          v = bf16x2(((x0 + b1[jj].x) + b2[jj].x) + ad[jj][h].x,
                     ((x1 + b1[jj].y) + b2[jj].y) + ad[jj][h].y);
        }
        *dst = v;
      }
    }
  }
}

// sin((o + d z) * freq + phase) for warpgroup rows row0 .. row0 + 63 of the
// chunk (rays ray0 + row) in the 64 PE slots (slot c reads coordinate c % 3;
// slots 60:64 are zero), rounded to bf16; t is the thread's index in its
// warpgroup. With CLAMP, row `row` encodes ray min(ray0 + row, n_rows - 1),
// as wg_layer's CLAMP reads its view bias.
template <bool CLAMP = false>
__device__ __forceinline__ void wg_encode(bf16* P, const float* o, const float* d, float zs,
                                          const float* freq, const float* phase, int ray0,
                                          int row0, int t, int n_rows = 0) {
  for (int idx = t; idx < WG_ROWS * PEW; idx += 128) {
    const int row = row0 + (idx >> 6), c = idx & (PEW - 1);
    float v = 0.f;
    if (c < 60) {
      const int ray = CLAMP ? min(ray0 + row, n_rows - 1) : ray0 + row;
      const int k = ray * 3 + c % 3;
      const float pts = o[k] + d[k] * zs;
      const float arg = pts * freq[c] + phase[c];
      v = sinf(arg);
    }
    P[row * LDP + c] = __float2bfloat16_rn(v);
  }
}

// As wg_encode, with a depth per row (the hierarchical fine pass): row
// `row` of the chunk takes z[row], where z points at ray ray0's depth. The
// expression and its rounding are wg_encode's.
__device__ __forceinline__ void wg_encode_perz(bf16* P, const float* o, const float* d,
                                               const float* z, const float* freq,
                                               const float* phase, int ray0, int row0, int t) {
  for (int idx = t; idx < WG_ROWS * PEW; idx += 128) {
    const int row = row0 + (idx >> 6), c = idx & (PEW - 1);
    float v = 0.f;
    if (c < 60) {
      const int k = (ray0 + row) * 3 + c % 3;
      const float pts = o[k] + d[k] * z[row];
      const float arg = pts * freq[c] + phase[c];
      v = sinf(arg);
    }
    P[row * LDP + c] = __float2bfloat16_rn(v);
  }
}

// The torso's deformation net over the warpgroup's rows: PE in P -> p' =
// deform + sig_pad + pe, written over P (bf16). Uses H as scratch; ends with
// the warpgroup's barrier.
__device__ __forceinline__ void wg_deform(bf16* H, bf16* P, const float* b, Ring& r, int wg, int wi,
                                          int lane) {
  const int row0 = wg * WG_ROWS;
  const bf16* nul = nullptr;
  wg_layer<PEW, DEF, RELU>(P, LDP, b + DB_1, H, LDH, nul, nullptr, nul, 0, r, row0, wi, lane);
  wg_sync(wg);
  wg_layer<DEF, DEF, RELU>(H, LDH, b + DB_K, H, LDH, nul, nullptr, nul, 0, r, row0, wi, lane);
  wg_sync(wg);
  wg_layer<DEF, DEF, RELU>(H, LDH, b + DB_K + DEF, H, LDH, nul, nullptr, nul, 0, r, row0, wi,
                           lane);
  wg_sync(wg);
  wg_layer<DEF, DEF, SKIP, PEW>(H, LDH, b + DB_K + 2 * DEF, H, LDH, P, b + DB_SKIP, nul, 0, r,
                                row0, wi, lane);
  wg_sync(wg);
  wg_layer<DEF, DEF, RELU>(H, LDH, b + DB_K + 3 * DEF, H, LDH, nul, nullptr, nul, 0, r, row0, wi,
                           lane);
  wg_sync(wg);
  wg_layer<DEF, DEF, DEFORM_OUT>(H, LDH, b + DB_OUT, P, LDP, nul, b + SIG_PAD, nul, 0, r, row0,
                                 wi, lane);
  wg_sync(wg);
}

// The trunk over the warpgroup's rows: input (P) -> input layer -> 7
// blocks, in place in H, which ends holding its output h.
template <int KIN>
__device__ __forceinline__ void wg_trunk(bf16* H, bf16* P, const float* b, Ring& r, int wg, int wi,
                                         int lane) {
  const int row0 = wg * WG_ROWS;
  const bf16* nul = nullptr;
  wg_layer<KIN, HID, RELU>(P, LDP, b + B_IN, H, LDH, nul, nullptr, nul, 0, r, row0, wi, lane);
  wg_sync(wg);
#pragma unroll 1
  for (int i = 0; i < 7; ++i) {
    if (i == 3) {
      wg_layer<HID, HID, SKIP, KIN>(H, LDH, b + B_BLK + i * HID, H, LDH, P, b + B_SKIP, nul, 0, r,
                                    row0, wi, lane);
    } else {
      wg_layer<HID, HID, RELU>(H, LDH, b + B_BLK + i * HID, H, LDH, nul, nullptr, nul, 0, r, row0,
                               wi, lane);
    }
    wg_sync(wg);
  }
}

// sigma [M] and rgb [M][3] of one field over the warpgroup's rows, from its
// input in P: the trunk, the sigma column, the view feature (in place over
// h) and the rgb columns. w is the staged blob (for the narrow rows), warp
// the consumer warp's index in the block (0..7).
template <int KIN>
__device__ __forceinline__ void wg_trunk_and_heads(bf16* H, bf16* P, const bf16* w, const float* b,
                                                   const bf16* vr, int ray0, int softplus,
                                                   float* sig, float* rgb, Ring& r, int wg,
                                                   int warp, int lane) {
  typedef Staged<KIN> S;
  const int wi = warp & 3, g = lane >> 2, q = lane & 3;
  wg_trunk<KIN>(H, P, b, r, wg, wi, lane);
  float d[4];
  narrow8(d, H, w + S::SIGW, warp, lane);
  if (q == 0) {
    sig[warp * 16 + g] = density_act(d[0] + b[B_SF], softplus);
    sig[warp * 16 + g + 8] = density_act(d[2] + b[B_SF], softplus);
  }
  wg_layer<HID, HID, VIEW>(H, LDH, b + B_SF + 128, H, LDH, nullptr, nullptr, vr, ray0, r,
                           wg * WG_ROWS, wi, lane);
  wg_sync(wg);
  narrow8(d, H, w + S::OUTW, warp, lane);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = q * 2 + e;
    if (c < 3) {
      rgb[(warp * 16 + g) * 3 + c] = 1.f / (1.f + expf(-(d[e] + b[B_OUT + c])));
      rgb[(warp * 16 + g + 8) * 3 + c] = 1.f / (1.f + expf(-(d[2 + e] + b[B_OUT + c])));
    }
  }
}

// The head's density on one (tile, slab) at the slab's 8 shared depths
// z[0:8], for the density-only kernels (sigma_head.cu, pair_hier.cu): 16
// chunks of 128 rows (one sample, half the tile's 256 rays). Each warpgroup
// encodes its 64 rows of a chunk, runs the trunk on them and the sigma column
// (narrow8 over the staged blob w's sigma rows), and no view or colour head:
// the ring carries NS_HEAD_TRUNK slabs a chunk, so the producer runs
// ring.produce(w, NS_HEAD_TRUNK, 2 * SS). The lane holding a row's density
// hands it to store(s, ray, sigma), with ray the index into o and d; b is the
// head's bias blob in shared memory. A row's value depends only on the row,
// so every kernel that walks a (tile, slab) here computes it bit for bit.
template <typename Store>
__device__ __forceinline__ void wg_sigma_walk(bf16* H, bf16* P, const float* o, const float* d,
                                              const float* z, const float* freq,
                                              const float* phase, const bf16* w, const float* b,
                                              int softplus, int tile, Ring& r, Store store) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3, t = tid & 127, row0 = wg * WG_ROWS;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int c = 0; c < 2 * SS; ++c) {
    const int s = c >> 1;
    const int ray0 = tile * RT + (c & 1) * M;
    wg_encode(P, o, d, z[s], freq, phase, ray0, row0, t);
    wg_sync(wg);
    wg_trunk<PEW>(H, P, b, r, wg, wi, lane);
    float x[4];
    narrow8(x, H, w + Staged<PEW>::SIGW, warp, lane);
    if (q == 0) {
      store(s, ray0 + warp * 16 + g, density_act(x[0] + b[B_SF], softplus));
      store(s, ray0 + warp * 16 + g + 8, density_act(x[2] + b[B_SF], softplus));
    }
    // the next chunk's encode rewrites P only after the trunk's last
    // barrier, and its input layer rewrites the warp's rows of H (read by
    // narrow8 above) only after the encode's barrier
  }
}

}  // namespace
