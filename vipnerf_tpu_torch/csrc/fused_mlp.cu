// K1: the fused ViP-NeRF MLP forward for Hopper (sm_90a).
//
// Replaces experiments/fused_mlp.py:_make_fwd_kernel (the Pallas TPU kernel
// launched by _fwd_pallas). For a tile of points it runs the whole flagship
// MLP: trunk 64->256 and 4 x 256->256, skip layer [xe, h] 320->256, 2 more
// layers, feature 256->256 and sigma 256->1 heads, then the view branch
// [feature, PE(dir)] 288->128 -> 4 once for the primary view and once per
// secondary view (n_sec <= 3).
//
// What bounds it: tensor-core operations. ~1.19 MFLOP per point against
// ~200 bytes of inputs and outputs, far above the card's ~295 FLOP/byte
// ridge. Every activation stays in shared memory from the first layer to the
// last; only the 8 raw outputs per point are written. What remains to move is
// the weights (1.19 MB in bf16), read from L2 once per tile of points.
//
// bf16 instance: a persistent, warp-specialised CTA per SM (384 threads).
// - Two consumer warpgroups each own 64 points of a 128-point tile for the
//   whole chain. Each layer is a sequence of wgmma.mma_async m64nNk16 (N 256,
//   128 or 8) with A (activations) and B (weights) both read from shared
//   memory through descriptors, f32 accumulators in registers. Rows are
//   independent, so a warpgroup only waits for its own 128 threads (named
//   barrier), never for the other warpgroup.
// - A: activations are K-major 64-column slabs with the 128-byte swizzle
//   (64 rows x 128 B, 8 KB). The epilogue of a layer writes its bf16 output
//   over its input in that layout, so there is one buffer, no ping-pong. The
//   concatenations are slab sequences: the skip layer reads the xe slab and
//   then the four h slabs, the view layer the four feature slabs and then a
//   32-column PE(dir) slab with the 64-byte swizzle.
// - B: the packer (kernels/fused_mlp.py) writes every layer as K-slabs that
//   are already the swizzled image the B descriptor reads (N rows x 64 K,
//   32 KB for N = 256), so a producer thread copies each with one 1-D
//   cp.async.bulk into a 2-stage ring, completing on a "full" mbarrier; the
//   8 consumer warps arrive on the stage's "empty" mbarrier when their wgmma
//   has read it. The weight stream is the same for every tile (layers 0-11,
//   then layers 10-11 again per secondary view) and the producer replays it.
// - Numerics of _make_fwd_kernel and models/mlp.py with bf16 matmuls: the f32
//   sum is rounded to bf16, the bf16 bias is added as bf16(float(h)+float(b)),
//   then ReLU.
// - Each CTA reads every weight from L2 once per 128 points. Sharing one copy
//   between the 2 CTAs of a cluster (multicast) was slower on the H100: with
//   the 64 KB ring that the shared memory leaves, the round trip between the
//   two CTAs before a stage can be refilled cost more than the halved L2
//   traffic saved (PERF.md, section 6).
//
// Traps, each handled below:
// - Stores by threads into shared memory are not seen by the async proxy
//   (wgmma, bulk copies) without fence.proxy.async.shared::cta: the next
//   layer would read stale activations, and only sometimes.
// - The transpose bits of wgmma are 0 because both operands are K-major: the
//   packer stores W as (out, in), K contiguous, the layout A has too.
// - mbarrier phase parity is tracked per stage by a running chunk counter
//   (stage = it % 2, parity = it / 2 % 2) that carries across tiles.
// - Register arrays are indexed only with unrolled constants; a spill would
//   show in the ptxas line chip_smoke.py prints.
// - A layer's output overwrites its input: a warpgroup barrier sits between
//   its last wgmma and its epilogue.
//
// f32 instance: 64 points per CTA, plain FFMA (no TF32), activations in
// shared memory, each layer's W^T staged in 16 KB K-slabs by cp.async, double
// buffered, so every weight comes from L2 once per CTA. A thread owns an 8x8
// register tile (8 rows x 2 float4 column groups), reading one float4 of
// activations (a broadcast) and two of weights per 4 k-steps and row block.
//
// bf16_f32h instance (the shipped precision mode: bf16 trunk, f32 heads, as
// models/mlp.py computes with bf16_matmuls and f32_heads): two launches, both
// on the bf16 tensor cores.
// - The bf16 kernel's trunk (layers 0-7, TRUNK = true) writes h as the image
//   it holds in shared memory: per 64 rows, its four 128-byte-swizzled 8 KB
//   K-slabs (32 KB, block 2 * tile + warpgroup of a scratch buffer).
// - The heads kernel (fused_mlp_heads_kernel) is shaped like the bf16 kernel:
//   persistent, one producer thread streaming weight chunks into a 4 x 32 KB
//   ring, two consumer warpgroups of 64 points each. A warpgroup fetches its
//   h block with one bulk copy straight into wgmma A slabs.
// - Numerics: f32-accurate products from bf16 ones. Every f32 head weight is
//   packed as three bf16 parts, W = W1 + W2 + W3 exactly (round to nearest
//   even, the remainders exact in f32). h is bf16-valued, so the feature and
//   sigma layers are h W1 + h W2 + h W3: three wgmma chains into one f32
//   accumulator, every product exact. The view layer and its output layer
//   have an f32 operand on both sides (the feature, PE(dir), the view hidden
//   layer), split the same way into a1 + a2 + a3, and take the six products
//   a_i b_j with i + j <= 2 (parts counted from 0); the three dropped ones are
//   below 2^-24 of the product. Six bf16 products cost what 3xTF32's three
//   TF32 ones do (989 against 495 TFLOP/s), move 6 bytes per weight against
//   TF32 hi/lo's 8, and reuse the bf16 layouts of the trunk. Bias in f32
//   after the sum, then ReLU, as models/mlp.py. No operand is rounded once
//   and used alone.
// - The view layer's feature columns do not depend on the view: g = feature
//   W10[:, :256]^T is computed once per point, and each view adds its PE(dir)
//   columns and bias to a copy of g. Only the f32 summation order differs
//   from the concatenated product.
// - Registers, not shared memory, carry the f32 operands of the view and
//   output layers: an m64nN accumulator's fragment is, register pair for
//   register pair, the A fragment of a wgmma k16 step, so each k16 chunk is
//   split into its three bf16 parts in registers and fed to wgmma with A from
//   registers. The feature is computed in two halves of 128 columns (64
//   registers), each folded into g (64 registers) before the next, so the
//   peak is ~128 accumulator registers.
// - Budgets (one CTA per SM): shared memory 2 x (h 32 KB + PE(dir) parts
//   12 KB + f32 output tile 2 KB) + the 128 KB ring = 226,392 bytes with
//   slack, under 232,448. Weights streamed from L2 per 128-point tile:
//   618 KB (W8's parts 384, W10's feature columns' 192, sigma's 12 and the
//   per-view chunk's 30, replayed per view), ~7.8 GB per launch of 1.57M
//   points against the bf16 kernel's ~14.6 GB.
// - Bound on an H100 (989 TFLOP/s bf16): the trunk's MACs x 2, plus the
//   feature and sigma layers' x 2 x 3 and the view and output layers' x 2 x 6
//   (the feature columns of the view layer once per point, the PE(dir)
//   columns and the output layer once per view); 2.89 ms per 1.57M points at
//   n_sec 0. The h round trip (1 KB per point) is not part of the function.
//
// The shipped mode's backward recomputes the trunk in trunk_recompute_kernel,
// the bf16 kernel's trunk with every layer's h stored (below the bf16
// kernel); csrc/fused_mlp_bwd.cu takes the trunk's gradient from them.
//
// K1's inputs (xe, ve, ve2) come from k1_encode_kernel, below the f32
// kernel: one bytes-bound pass that writes the padded, cast positional
// encodings that kernels/fused_mlp.py's torch chain wrote in ~10 kernels.
//
// All mask the ragged last tile: rows past n load as zeros and are never
// stored. C entry points return cudaGetLastError() after the launch.
//
// Scene axis (the counterpart of vmap over the Pallas kernel in batched
// multi-scene training): one launch runs `scenes` MLPs of the same shape,
// each on its own n_per_scene consecutive rows, with its own packed weights
// (scene s's at w + s * W_ELEMS elements, or s * F32H_BYTES bytes for bf16_f32h;
// its biases at bias + s * B_ELEMS; h block 2 * tile + warpgroup, tiles
// counted over all scenes). A tile never straddles two scenes: tile
// t is tile t % tps of scene t / tps, tps the tiles per scene, so each
// scene's last tile is ragged on its own. Each
// kernel is a template on SCENES: the host launches the <false> instance
// for one scene, whose scene index is the constant 0, so it compiles to the
// kernel without the axis (on an H100 the one-scene bf16 kernel ran ~14 %
// slower with the scene arithmetic in it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int PTS_IN = 64;
constexpr int VIEW_IN = 32;
constexpr int WIDTH = 256;
constexpr int NOUT = 8;
constexpr int MAX_SEC = 3;
constexpr int NLAYERS = 12;

// (out, in) of each packed layer: trunk 0..7, feature 8, sigma 9, view 10,
// view output 11 -- the table LAYER_SHAPES in kernels/fused_mlp.py.
__host__ __device__ constexpr int layer_n(int l) {
  return l <= 8 ? 256 : (l == 10 ? 128 : 8);
}
__host__ __device__ constexpr int layer_k(int l) {
  return l == 0 ? 64 : (l == 5 ? 320 : (l == 10 ? 288 : (l == 11 ? 128 : 256)));
}
__host__ __device__ constexpr int w_off(int l) {
  int o = 0;
  for (int i = 0; i < l; ++i) o += layer_n(i) * layer_k(i);
  return o;
}
__host__ __device__ constexpr int b_off(int l) {
  int o = 0;
  for (int i = 0; i < l; ++i) o += layer_n(i);
  return o;
}
constexpr int W_ELEMS = w_off(NLAYERS);  // packed weights of one scene
constexpr int B_ELEMS = b_off(NLAYERS);  // biases of one scene
static_assert(W_ELEMS == 596992, "weight table");
static_assert(B_ELEMS == 2448, "bias table");
constexpr int FEATURE = 8;                            // the first head layer
constexpr int TRUNK_ELEMS = w_off(FEATURE);           // layers 0-7
constexpr int HEAD_ELEMS = W_ELEMS - TRUNK_ELEMS;     // layers 8-11

// One scene's bf16_f32h pack: the trunk's bf16 slabs, then the heads' stream
// of bulk copies in the order the heads kernel consumes them, each a bf16
// image of the three parts of f32 weights (kernels/fused_mlp.py heads_image):
constexpr int HCHUNK = 32768;                     // a ring stage of the heads kernel
constexpr int HALF = 128;                         // feature columns per half
constexpr int SIGMA_BYTES = 3 * NOUT * WIDTH * 2;  // W9's three parts, 4 K-slabs each
// per half: W8's part p, K-columns [128 sp, 128 sp + 128) of the half's rows
// (chunk 2p + sp), then W10's part p, the half's feature columns (chunk 6 + p)
constexpr int HALF_CHUNKS = 9;
constexpr int PEW_SLAB = 128 * VIEW_IN * 2;        // W10's PE(dir) columns, one part, 64-byte swizzle
constexpr int W11_PART = NOUT * 128 * 2;           // W11, one part, 2 K-slabs
constexpr int VIEW_BYTES = 3 * PEW_SLAB + 3 * W11_PART;  // the per-view chunk
constexpr int HEADS_BYTES = SIGMA_BYTES + 2 * HALF_CHUNKS * HCHUNK + VIEW_BYTES;
constexpr int F32H_BYTES = 2 * TRUNK_ELEMS + HEADS_BYTES;
static_assert(TRUNK_ELEMS == 491520 && HEADS_BYTES == 3 * 2 * HEAD_ELEMS && F32H_BYTES == 1615872 &&
                  F32H_BYTES % 16 == 0 && VIEW_BYTES <= HCHUNK,
              "bf16_f32h pack");

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int lds_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_s32(uint32_t addr, int v) {
  asm volatile("st.shared.s32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// A wait that never ends (a broken pipeline) traps after 2^24 polls, so a
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// 1-D bulk copy global -> shared, completing `bytes` on the mbarrier
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 1-D bulk copy shared -> global in the thread's bulk group; the group's
// reads of shared memory end at bulk_wait_read, its writes at bulk_wait
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// a box of a 3-D tensor map (coordinates innermost first) shared -> global,
// in the thread's bulk group (commit it with bulk_commit)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(map), "r"(src),
               "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// thread stores into shared memory -> visible to wgmma and bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void acc_fence(float (&d)[R], int count) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < count) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand with the SW-byte
// swizzle (SW = 128 or 64): rows of SW bytes, 8-row groups SW * 8 bytes apart
// (the stride byte offset); the leading byte offset is unused in this mode.
template <int SW>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  static_assert(SW == 128 || SW == 64, "swizzle");
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(8 * SW / 16) << 32) | (static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62);
}

#define ACC8(i)                                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x N] (+)= A[64 x 16] B[16 x N]; the accumulator fragment of thread t
// of the warpgroup: d[4j + 2h + e] is row 16 (t / 32) + (t % 32) / 4 + 8h,
// column 8j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64),
        ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(acc));
}

// the same for N = 128 in d[0..63]
template <int R>
__device__ __forceinline__ void wgmma_n128(float (&d)[R], uint64_t da, uint64_t db, int acc) {
  static_assert(R >= 64, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

// A from registers: a[i] is fragment register i of the k16 step, a bf16
// pair (lower column in the low half): rows r and r + 8 (r = 16 warp +
// lane / 4) in registers (0, 1) and (2, 3), columns 2 (lane % 4) + {0, 1} in
// registers 0 and 1, 8 more in 2 and 3 -- the order of an accumulator's
// d[8c .. 8c + 7] for columns [16c, 16c + 16).
template <int R>
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[R], const uint32_t (&a)[4], uint64_t db, int acc) {
  static_assert(R >= 64, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n8_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef ACC8

// ------------------------------------------------------------------ bf16

constexpr int CONSUMERS = 2;                      // consumer warpgroups per CTA
constexpr int THREADS16 = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr int ROWS_WG = 64;                       // points per consumer warpgroup
constexpr int TILE16 = ROWS_WG * CONSUMERS;       // points per tile
constexpr int SLAB_K = 64;                        // K of a 128-byte-swizzled slab
constexpr int A_SLAB = ROWS_WG * SLAB_K * 2;      // 8 KB
constexpr int PE_SLAB = ROWS_WG * VIEW_IN * 2;    // 4 KB, 64-byte swizzle
// a consumer warpgroup's shared memory
constexpr int WG_ACT = 0;                    // 4 slabs: h, then the feature
constexpr int WG_HID = WG_ACT + 4 * A_SLAB;  // 2 slabs: the view layer's output
constexpr int WG_XE = WG_HID + 2 * A_SLAB;   // 1 slab
constexpr int WG_PE = WG_XE + A_SLAB;        // 1 + MAX_SEC slabs
constexpr int WG_BYTES = WG_PE + (1 + MAX_SEC) * PE_SLAB;
// the CTA's
constexpr int STAGES = 2;
constexpr int STAGE_BYTES = WIDTH * SLAB_K * 2;  // one K-slab of a 256-wide layer
constexpr int RING = CONSUMERS * WG_BYTES;
constexpr int OUT_TILE = RING + STAGES * STAGE_BYTES;  // [64][8] bf16 per warpgroup
constexpr int BARS = OUT_TILE + CONSUMERS * ROWS_WG * NOUT * 2;
constexpr int SCENE_SLOT = BARS + 2 * STAGES * 8;  // the tile's scene, an int per consumer warpgroup
constexpr int SMEM16 = SCENE_SLOT + 4 * CONSUMERS + 1024;  // + slack to align the base to 1 KB
static_assert(WG_BYTES % 1024 == 0 && RING % 1024 == 0, "swizzled slabs need 1 KB alignment");
static_assert(SMEM16 <= 232448, "shared memory");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// byte offset of element (r, c) in a stack of 128-byte-swizzled 64-column slabs
__device__ __forceinline__ int swz128(int r, int c) {
  return (c >> 6) * A_SLAB + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// The weight ring as a consumer sees it: `it` counts the chunks consumed.
template <int NSTAGES>
struct RingN {
  uint32_t stages, full, empty, it;
  __device__ __forceinline__ uint32_t acquire() {
    const uint32_t s = it % NSTAGES;
    mbar_wait(full + 8 * s, (it / NSTAGES) & 1);
    return stages + s * STAGE_BYTES;
  }
  __device__ __forceinline__ void release(int lane) {
    if (lane == 0) mbar_arrive(empty + 8 * (it % NSTAGES));
    ++it;
  }
};
using Ring = RingN<STAGES>;

// wgmma over one K-slab: SW / 32 steps of k16 (32 bytes of each row)
template <int N, int SW, int R>
__device__ __forceinline__ void mma_slab(float (&d)[R], uint32_t a, uint32_t b, int accumulate) {
#pragma unroll
  for (int t = 0; t < SW / 32; ++t) {
    const uint64_t da = desc<SW>(a + 32 * t), db = desc<SW>(b + 32 * t);
    const int acc = accumulate | (t > 0);
    if constexpr (N == 256) wgmma_n256(d, da, db, acc);
    else if constexpr (N == 128) wgmma_n128(d, da, db, acc);
    else wgmma_n8(d, da, db, acc);
  }
}

// One chunk of the weight stream (NSUB consecutive K-slabs of one layer):
// wait for it, run it against the A slabs from `a` on, release it.
template <int N, int SW, int NSUB, int R, typename RingT>
__device__ __forceinline__ void mma_chunk(float (&d)[R], RingT& ring, uint32_t a, int accumulate, int lane) {
  const uint32_t b = ring.acquire();
  acc_fence(d, N / 2);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < NSUB; ++s) mma_slab<N, SW>(d, a + s * A_SLAB, b + s * N * SW, accumulate | (s > 0));
  wgmma_commit();
  wgmma_wait0();
  acc_fence(d, N / 2);
  ring.release(lane);
}

// a 256-wide trunk layer from the four h slabs, after the xe slab if `skip`
template <typename RingT>
__device__ __forceinline__ void mma_trunk(float (&d)[128], RingT& ring, uint32_t xe, uint32_t act, bool skip,
                                          int lane) {
  if (skip) mma_chunk<256, 128, 1>(d, ring, xe, 0, lane);
  for (int s = 0; s < 4; ++s) mma_chunk<256, 128, 1>(d, ring, act + s * A_SLAB, (s > 0) | skip, lane);
}

// bf16(bf16(acc) + b), ReLU, into the swizzled slabs at dst, a pair of
// columns at a time: one cvt.rn.bf16x2.f32, then fma.rn(.relu).bf16x2 with
// 1.0, which rounds bf16(acc) + b once, as bf16(float(h) + float(b)) does.
template <int N, bool RELU>
__device__ __forceinline__ void epilogue_to_slabs(const float (&d)[128], const float* __restrict__ bias,
                                                  unsigned char* dst, int warp, int lane) {
  const int r = warp * 16 + (lane >> 2);
  const __nv_bfloat162 one = __floats2bfloat162_rn(1.f, 1.f);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 bf = __ldg(reinterpret_cast<const float2*>(bias + c));
    const __nv_bfloat162 b = __floats2bfloat162_rn(bf.x, bf.y);  // exact: the bias is bf16-valued
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + swz128(r + 8 * h, c)) =
          RELU ? __hfma2_relu(h2, one, b) : __hfma2(h2, one, b);
    }
  }
}

// columns [lo, hi) of an 8-wide head into columns dst.. of the output tile
__device__ __forceinline__ void epilogue_to_out(const float (&d)[4], const float* __restrict__ bias,
                                                __nv_bfloat16* tile, int lo, int hi, int dst, int warp,
                                                int lane) {
  const int r = warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * (lane & 3) + e;
      if (c >= lo && c < hi)
        tile[(r + 8 * h) * NOUT + dst + c - lo] = __float2bfloat16_rn(bf16_round(d[2 * h + e]) + __ldg(bias + c));
    }
}

// TRUNK: layers 0-7 only, `out` receives h as 32 KB slab images, one per 64
// rows (2 per tile), and each scene's pack is a bf16_f32h pack (F32H_BYTES);
// ve and ve2 are not read.
template <bool SCENES, bool TRUNK>
__global__ void __launch_bounds__(THREADS16, 1)
    fused_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ xe, const __nv_bfloat16* __restrict__ ve,
                          const __nv_bfloat16* __restrict__ ve2, const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int scenes, int nps,
                          int n_sec) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + BARS, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tps = (nps + TILE16 - 1) / TILE16;  // tiles per scene
  const int ntiles = SCENES ? scenes * tps : tps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread replays the weight stream into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);  // the tile's scene's weights
      uint32_t it = 0;
      auto push = [&](int off, int bytes) {
        const uint32_t s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, bytes);
        bulk_g2s(base + RING + s * STAGE_BYTES, wb + off, bytes, full + 8 * s);
        ++it;
      };
      // a layer is its K-slabs in order: one chunk each, or one chunk in all
      // for the 8-wide heads (4 and 2 KB)
      auto push_layer = [&](int l) {
        const int nn = layer_n(l), k = layer_k(l), off = 2 * w_off(l);
        if (nn == NOUT) {
          push(off, 2 * nn * k);
          return;
        }
        for (int k0 = 0; k0 < k; k0 += SLAB_K) push(off + 2 * nn * k0, 2 * nn * min(SLAB_K, k - k0));
      };
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        if (SCENES)
          wb = reinterpret_cast<const unsigned char*>(w) + (size_t)(tile / tps) * (TRUNK ? F32H_BYTES : 2 * W_ELEMS);
        for (int l = 0; l < (TRUNK ? FEATURE : NLAYERS); ++l) push_layer(l);
        for (int j = 0; j < (TRUNK ? 0 : n_sec); ++j) {
          push_layer(10);
          push_layer(11);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32, bar_id = 1 + wg;
    unsigned char* mine = smem + wg * WG_BYTES;
    const uint32_t act = base + wg * WG_BYTES + WG_ACT, hid = act - WG_ACT + WG_HID;
    const uint32_t xs = act - WG_ACT + WG_XE, pe = act - WG_ACT + WG_PE;
    __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(smem + OUT_TILE) + wg * ROWS_WG * NOUT;
    Ring ring{base + RING, full, empty, 0};
    const int ve2_ld = VIEW_IN * (n_sec > 0 ? n_sec : 1);
    const int vpieces = 4 * (1 + n_sec);  // 16-byte pieces of PE per row
    const uint4 zero = make_uint4(0, 0, 0, 0);
    float d[128];
    float d8[4];
    // The tile's scene sits in shared memory and is read where it is needed,
    // so that no register holds it, or the scene's biases and rows, across
    // the tile: with those live the SCENES instance spilled (ptxas: 116
    // bytes). A tile's first bar_sync orders the write after the previous
    // tile's last read.
    const uint32_t scene_slot = base + SCENE_SLOT + 4 * wg;
    auto tile_scene = [&]() { return SCENES ? lds_s32(scene_slot) : 0; };
    auto sbias = [&]() { return bias + tile_scene() * B_ELEMS; };

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      bar_sync(bar_id, 128);  // the previous tile's output rows are stored
      const int scene = SCENES ? tile / tps : 0;
      if (SCENES && tid == 0) sts_s32(scene_slot, scene);
      const int lrow0 = (tile - scene * tps) * TILE16 + wg * ROWS_WG;  // within the scene
      const int row0 = scene * nps + lrow0;
      // the tile's inputs, swizzled; rows past the scene's end are zeros
      for (int i = tid; i < ROWS_WG * 8; i += 128) {
        const int r = i >> 3, c = i & 7;
        const uint4 v = lrow0 + r < nps ? __ldg(reinterpret_cast<const uint4*>(xe + (size_t)(row0 + r) * PTS_IN) + c)
                                        : zero;
        *reinterpret_cast<uint4*>(mine + WG_XE + r * 128 + ((c ^ (r & 7)) << 4)) = v;
      }
      if constexpr (!TRUNK) {
        for (int i = tid; i < ROWS_WG * vpieces; i += 128) {
          const int r = i / vpieces, q = i % vpieces, v = q >> 2, c = q & 3;
          uint4 val = zero;
          if (lrow0 + r < nps)
            val = v == 0 ? __ldg(reinterpret_cast<const uint4*>(ve + (size_t)(row0 + r) * VIEW_IN) + c)
                         : __ldg(reinterpret_cast<const uint4*>(ve2 + (size_t)(row0 + r) * ve2_ld) + q - 4);
          *reinterpret_cast<uint4*>(mine + WG_PE + v * PE_SLAB + r * 64 + ((c ^ ((r >> 1) & 3)) << 4)) = val;
        }
        if (tid < ROWS_WG) reinterpret_cast<uint4*>(otile)[tid] = zero;
      }
      fence_proxy_async();
      bar_sync(bar_id, 128);

      // trunk: each layer's output overwrites its input
      mma_chunk<256, 128, 1>(d, ring, xs, 0, lane);
      epilogue_to_slabs<256, true>(d, sbias() + b_off(0), mine + WG_ACT, warp, lane);
      fence_proxy_async();
      bar_sync(bar_id, 128);
      for (int l = 1; l <= 7; ++l) {
        mma_trunk(d, ring, xs, act, l == 5, lane);
        bar_sync(bar_id, 128);  // no wgmma of this warpgroup still reads h
        epilogue_to_slabs<256, true>(d, sbias() + b_off(l), mine + WG_ACT, warp, lane);
        fence_proxy_async();
        bar_sync(bar_id, 128);
      }
      if constexpr (TRUNK) {
        // h as its four swizzled slabs, 32 KB at block 2 * tile + wg (rows
        // past the scene's end too); the next tile's first bar_sync orders
        // these reads before h is overwritten
        uint4* hblock = reinterpret_cast<uint4*>(out + (size_t)(2 * tile + wg) * (ROWS_WG * WIDTH));
        for (int i = tid; i < 4 * A_SLAB / 16; i += 128)
          hblock[i] = reinterpret_cast<const uint4*>(mine + WG_ACT)[i];
        continue;
      }
      // heads from h: the feature (over h) and sigma (output column 0)
      mma_trunk(d, ring, xs, act, false, lane);
      mma_chunk<8, 128, 4>(d8, ring, act, 0, lane);
      bar_sync(bar_id, 128);
      epilogue_to_slabs<256, false>(d, sbias() + b_off(8), mine + WG_ACT, warp, lane);
      epilogue_to_out(d8, sbias() + b_off(9), otile, 0, 1, 0, warp, lane);
      fence_proxy_async();
      bar_sync(bar_id, 128);
      // view branch [feature, PE(dir)]: the primary view gives rgb + vis
      // (columns 1..4), secondary view v its vis (column 4 + v)
      for (int v = 0; v <= n_sec; ++v) {
        for (int s = 0; s < 4; ++s) mma_chunk<128, 128, 1>(d, ring, act + s * A_SLAB, s > 0, lane);
        mma_chunk<128, 64, 1>(d, ring, pe + v * PE_SLAB, 1, lane);
        bar_sync(bar_id, 128);  // no wgmma of this warpgroup still reads the hidden slabs
        epilogue_to_slabs<128, true>(d, sbias() + b_off(10), mine + WG_HID, warp, lane);
        fence_proxy_async();
        bar_sync(bar_id, 128);
        mma_chunk<8, 128, 2>(d8, ring, hid, 0, lane);
        if (v == 0)
          epilogue_to_out(d8, sbias() + b_off(11), otile, 0, 4, 1, warp, lane);
        else
          epilogue_to_out(d8, sbias() + b_off(11), otile, 3, 4, 4 + v, warp, lane);
      }
      bar_sync(bar_id, 128);
      const int oscene = tile_scene(), orow0 = (tile - oscene * tps) * TILE16 + wg * ROWS_WG;
      if (tid < ROWS_WG && orow0 + tid < nps)
        reinterpret_cast<uint4*>(out)[oscene * nps + orow0 + tid] = reinterpret_cast<const uint4*>(otile)[tid];
    }
  }
}

// ----------------------------------------------- trunk recompute (backward)

// The shipped mode's backward recomputes the trunk (layers 0-7) and keeps
// each layer's output for the trunk's gradient kernels (csrc/fused_mlp_bwd.cu,
// trunk_bwd_*): the bf16 kernel's TRUNK path, layer for layer (the same
// weight stream, products and epilogues), so its h is K1's forward h bit for
// bit, with a store after every layer. Outputs, block 2 * tile + warpgroup
// of 64 rows (rows past the scene's end too): xe's swizzled slab (8 KB a
// block) into xe_img; h1..h7, the outputs of layers 0-6, as their 32 KB slab
// images into image l - 1 of himg (2 x tiles blocks each); h8 row-major (N, 256)
// for the heads' backward, its scene's rows only. Named apart from K1's
// kernels (fused_mlp_*), so that a trace classes it with the backward.
//
// The stores are the producer warpgroup's: per consumer warpgroup one
// thread waits for each layer's h (an mbarrier the consumer arrives on after
// its epilogue), bulk-copies it out (h8 through a 3-D tensor map, scene x
// row x column, whose 128-byte swizzle turns the slabs back into rows and
// whose bounds keep each scene's ragged end), and arrives on a second
// mbarrier once the copy has read it, which the consumer waits for before
// its next epilogue overwrites h. The consumers hold no store address.
//
// Its shared memory: per consumer warpgroup h's four slabs and xe's, then
// a deeper ring than the forward's (the stores share the copy engine).
constexpr int RSTAGES = 4;
constexpr int RW_XE = 4 * A_SLAB;
constexpr int RW_BYTES = RW_XE + A_SLAB;
constexpr int RRING = CONSUMERS * RW_BYTES;
constexpr int RBARS = RRING + RSTAGES * STAGE_BYTES;  // full, empty, then per warpgroup h ready, h read
constexpr int RSCENE = RBARS + (2 * RSTAGES + 2 * CONSUMERS) * 8;
constexpr int SMEMR = RSCENE + 4 * CONSUMERS + 1024;
static_assert(RW_BYTES % 1024 == 0 && SMEMR <= 232448, "shared memory");

template <bool SCENES>
__global__ void __launch_bounds__(THREADS16, 1)
    trunk_recompute_kernel(const __nv_bfloat16* __restrict__ xe, const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias, unsigned char* __restrict__ xe_img,
                           unsigned char* __restrict__ himg, const __grid_constant__ CUtensorMap h8, int scenes,
                           int nps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + RBARS, empty = full + 8 * RSTAGES, hready = empty + 8 * RSTAGES;
  const uint32_t hread = hready + 8 * CONSUMERS;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tps = (nps + TILE16 - 1) / TILE16;
  const int ntiles = SCENES ? scenes * tps : tps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);
    }
    for (int c = 0; c < 2 * CONSUMERS; ++c) mbar_init(hready + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {  // the weight stream, layers 0-7 per tile
      const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        if (SCENES) wb = reinterpret_cast<const unsigned char*>(w) + (size_t)(tile / tps) * F32H_BYTES;
        for (int l = 0; l < FEATURE; ++l)
          for (int k0 = 0; k0 < layer_k(l); k0 += SLAB_K) {
            const uint32_t s = it % RSTAGES;
            mbar_wait(empty + 8 * s, ((it / RSTAGES) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, STAGE_BYTES);
            bulk_g2s(base + RRING + s * STAGE_BYTES, wb + 2 * w_off(l) + 2 * WIDTH * k0, STAGE_BYTES, full + 8 * s);
            ++it;
          }
      }
    } else if (tid == 32 || tid == 64) {  // warpgroup c's stores, layer by layer
      const int c = tid / 32 - 1;
      const uint32_t act = base + c * RW_BYTES;
      uint32_t k = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        for (int l = 0; l < FEATURE; ++l, ++k) {
          mbar_wait(hready + 8 * c, k & 1);
          if (l < FEATURE - 1) {
            bulk_s2g(himg + ((size_t)l * 2 * ntiles + 2 * tile + c) * (4 * A_SLAB), act, 4 * A_SLAB);
          } else {
            const int scene = SCENES ? tile / tps : 0;
            const int lrow0 = (tile - scene * tps) * TILE16 + c * ROWS_WG;
            for (int s = 0; s < 4; ++s) tma_store_3d(&h8, act + s * A_SLAB, s * SLAB_K, lrow0, scene);
            bulk_commit();
          }
          bulk_wait_read();
          mbar_arrive(hread + 8 * c);
        }
      }
      bulk_wait();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32, bar_id = 1 + wg;
    unsigned char* mine = smem + wg * RW_BYTES;
    const uint32_t act = base + wg * RW_BYTES, xs = act + RW_XE;
    const uint32_t ready = hready + 8 * wg, read = hread + 8 * wg;
    RingN<RSTAGES> ring{base + RRING, full, empty, 0};
    const uint4 zero = make_uint4(0, 0, 0, 0);
    float d[128];
    const uint32_t scene_slot = base + RSCENE + 4 * wg;
    auto sbias = [&]() { return bias + (SCENES ? lds_s32(scene_slot) : 0) * B_ELEMS; };
    uint32_t k = 0;  // layers handed to the stores
    // bf16(acc) + b, ReLU, into h once the store of the h before it has
    // read it; then h to the store
    auto epilogue = [&](int l) {
      if (tid == 0 && k > 0) mbar_wait(read, (k - 1) & 1);
      bar_sync(bar_id, 128);  // no wgmma and no copy still reads h
      epilogue_to_slabs<256, true>(d, sbias() + b_off(l), mine, warp, lane);
      fence_proxy_async();
      bar_sync(bar_id, 128);
      if (tid == 0) mbar_arrive(ready);
      ++k;
    };

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      bar_sync(bar_id, 128);
      const int scene = SCENES ? tile / tps : 0;
      if (SCENES && tid == 0) sts_s32(scene_slot, scene);
      const int lrow0 = (tile - scene * tps) * TILE16 + wg * ROWS_WG;
      const int row0 = scene * nps + lrow0;
      unsigned char* ximg = xe_img + ((size_t)2 * tile + wg) * A_SLAB;
      for (int i = tid; i < ROWS_WG * 8; i += 128) {
        const int r = i >> 3, c = i & 7, off = r * 128 + ((c ^ (r & 7)) << 4);
        const uint4 v =
            lrow0 + r < nps ? __ldg(reinterpret_cast<const uint4*>(xe + (size_t)(row0 + r) * PTS_IN) + c) : zero;
        *reinterpret_cast<uint4*>(mine + RW_XE + off) = v;
        *reinterpret_cast<uint4*>(ximg + off) = v;
      }
      fence_proxy_async();
      bar_sync(bar_id, 128);

      mma_chunk<256, 128, 1>(d, ring, xs, 0, lane);
      epilogue(0);
      for (int l = 1; l <= 7; ++l) {
        mma_trunk(d, ring, xs, act, l == 5, lane);
        epilogue(l);
      }
    }
  }
}

// ------------------------------------------------------- bf16_f32h heads

constexpr int HSTAGES = 4;
static_assert(HCHUNK == STAGE_BYTES, "the heads' ring stages are the bf16 kernel's");
// a consumer warpgroup's shared memory
constexpr int HW_H = 0;                      // h: 4 slabs, 128-byte swizzle
constexpr int HW_PE = HW_H + 4 * A_SLAB;     // PE(dir) of one view: 3 part slabs, 64-byte swizzle
constexpr int HW_OUT = HW_PE + 3 * PE_SLAB;  // the raw output rows, [64][8] f32
constexpr int HW_BYTES = HW_OUT + ROWS_WG * NOUT * 4;
// the CTA's
constexpr int HRING = CONSUMERS * HW_BYTES;
constexpr int HBARS = HRING + HSTAGES * HCHUNK;  // full, empty, then one "h arrived" per warpgroup
constexpr int HSCENE = HBARS + (2 * HSTAGES + CONSUMERS) * 8;
constexpr int SMEMH = HSCENE + 4 * CONSUMERS + 1024;
static_assert(HW_BYTES % 1024 == 0 && HRING % 1024 == 0, "swizzled slabs need 1 KB alignment");
static_assert(SMEMH <= 232448, "shared memory");

// x = part 0 + part 1 + part 2 exactly, each part the bf16 (round to nearest
// even) of what the parts before it leave; x - part 0 and its remainder are
// exact in f32. A pair of floats gives a bf16 pair per part.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x, y);
  const float2 af = __bfloat1622float2(a);
  const float rx = __fsub_rn(x, af.x), ry = __fsub_rn(y, af.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(rx, ry);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 c = __floats2bfloat162_rn(__fsub_rn(rx, bf.x), __fsub_rn(ry, bf.y));
  p0 = *reinterpret_cast<const uint32_t*>(&a);
  p1 = *reinterpret_cast<const uint32_t*>(&b);
  p2 = *reinterpret_cast<const uint32_t*>(&c);
}

// f(std::integral_constant<int, C>{}) for C = 0 .. N - 1 in order: a loop
// whose index stays a constant expression (a template argument) in f
template <int... C, typename F>
__device__ __forceinline__ void static_for(F&& f, std::integer_sequence<int, C...>) {
  (f(std::integral_constant<int, C>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for(f, std::make_integer_sequence<int, N>{});
}

// the three parts' A fragments of the k16 step over columns [16C, 16C + 16)
// of an f32 accumulator (see wgmma_n128_rs)
template <int C, int R>
__device__ __forceinline__ void split_frag(const float (&f)[R], uint32_t (&a)[3][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) split_pair(f[8 * C + 2 * k], f[8 * C + 2 * k + 1], a[0][k], a[1][k], a[2][k]);
}

// keeps the compiler from reusing A fragment registers before the wgmma
// that reads them has completed
__device__ __forceinline__ void frag_fence(uint32_t (&a)[3][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}

// g (+)= the half's feature f times W10's part p (two K-slabs at b, its
// columns of the half): f's parts i <= 2 - p, A from registers, one k16 step
// at a time
template <int C>
__device__ __forceinline__ void mma_g_step(float (&g)[64], const float (&f)[64], uint32_t b, int p, int first) {
  uint32_t a[3][4];
  split_frag<C>(f, a);
  const uint64_t db = desc<128>(b + (C >> 2) * (HALF * SLAB_K * 2) + (C & 3) * 32);
  acc_fence(g, 64);
  wgmma_fence();
  wgmma_n128_rs(g, a[0], db, !first);
  if (p < 2) wgmma_n128_rs(g, a[1], db, 1);
  if (p < 1) wgmma_n128_rs(g, a[2], db, 1);
  wgmma_commit();
  wgmma_wait0();
  acc_fence(g, 64);
  frag_fence(a);
}

// d8 (+)= hv W11^T from registers: the six part products of k16 step C,
// W11's part j at w11 + j * W11_PART (two K-slabs)
template <int C>
__device__ __forceinline__ void mma_out_step(float (&d8)[4], const float (&hv)[64], uint32_t w11) {
  uint32_t a[3][4];
  split_frag<C>(hv, a);
  acc_fence(d8, 4);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; i + j < 3; ++j)
      wgmma_n8_rs(d8, a[i], desc<128>(w11 + j * W11_PART + (C >> 2) * (NOUT * 128) + (C & 3) * 32),
                  C > 0 || i > 0 || j > 0);
  wgmma_commit();
  wgmma_wait0();
  acc_fence(d8, 4);
  frag_fence(a);
}

// columns [lo, hi) of an 8-wide head plus bias into f32 output columns dst..
__device__ __forceinline__ void epilogue_to_out32(const float (&d)[4], const float* __restrict__ bias, float* tile,
                                                  int lo, int hi, int dst, int warp, int lane) {
  const int r = warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * (lane & 3) + e;
      if (c >= lo && c < hi) tile[(r + 8 * h) * NOUT + dst + c - lo] = d[2 * h + e] + __ldg(bias + c);
    }
}

// The heads of the bf16_f32h instance (layers 8-11) on h from the trunk:
// `hblocks` holds its 32 KB slab images, block 2 * tile + warpgroup; `w` each
// scene's bf16_f32h pack (its heads' stream after the trunk's slabs); ve, ve2
// and out f32.
template <bool SCENES>
__global__ void __launch_bounds__(THREADS16, 1)
    fused_mlp_heads_kernel(const unsigned char* __restrict__ hblocks, const float* __restrict__ ve,
                           const float* __restrict__ ve2, const unsigned char* __restrict__ w,
                           const float* __restrict__ bias, float* __restrict__ out, int scenes, int nps,
                           int n_sec) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + HBARS, empty = full + 8 * HSTAGES, hfull = empty + 8 * HSTAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tps = (nps + TILE16 - 1) / TILE16;  // tiles per scene
  const int ntiles = SCENES ? scenes * tps : tps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int c = 0; c < CONSUMERS; ++c) mbar_init(hfull + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread replays the heads' stream into the ring (the
    // sigma chunk and the two halves' 18 chunks lie in order, then the view
    // chunk, copied once per view)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const unsigned char* wb = w + 2 * TRUNK_ELEMS;  // the tile's scene's heads
      uint32_t it = 0;
      auto push = [&](int off, int bytes) {
        const uint32_t s = it % HSTAGES;
        mbar_wait(empty + 8 * s, ((it / HSTAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, bytes);
        bulk_g2s(base + HRING + s * HCHUNK, wb + off, bytes, full + 8 * s);
        ++it;
      };
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        if (SCENES) wb = w + (size_t)(tile / tps) * F32H_BYTES + 2 * TRUNK_ELEMS;
        push(0, SIGMA_BYTES);
        for (int c = 0; c < 2 * HALF_CHUNKS; ++c) push(SIGMA_BYTES + c * HCHUNK, HCHUNK);
        for (int v = 0; v <= n_sec; ++v) push(SIGMA_BYTES + 2 * HALF_CHUNKS * HCHUNK, VIEW_BYTES);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32, bar_id = 1 + wg;
    const int q2 = 2 * (lane & 3);  // this thread's first accumulator column of each 8
    unsigned char* mine = smem + wg * HW_BYTES;
    const uint32_t hs = base + wg * HW_BYTES + HW_H, pe = hs - HW_H + HW_PE;
    float* otile = reinterpret_cast<float*>(mine + HW_OUT);
    const uint32_t hbar = hfull + 8 * wg;
    RingN<HSTAGES> ring{base + HRING, full, empty, 0};
    const int ve2_ld = VIEW_IN * (n_sec > 0 ? n_sec : 1);
    // the tile's scene, in shared memory and read where it is needed, as in
    // the bf16 kernel
    const uint32_t scene_slot = base + HSCENE + 4 * wg;
    auto sbias = [&]() { return bias + (SCENES ? lds_s32(scene_slot) : 0) * B_ELEMS; };
    uint32_t hphase = 0;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, hphase ^= 1) {
      bar_sync(bar_id, 128);  // the previous tile's h, PE(dir) and output rows are read
      const int scene = SCENES ? tile / tps : 0;
      if (SCENES && tid == 0) sts_s32(scene_slot, scene);
      if (tid == 0) {
        mbar_expect_tx(hbar, 4 * A_SLAB);
        bulk_g2s(hs, hblocks + (size_t)(2 * tile + wg) * (4 * A_SLAB), 4 * A_SLAB, hbar);
      }
      for (int i = tid; i < ROWS_WG * NOUT; i += 128) otile[i] = 0.f;
      bar_sync(bar_id, 128);  // the scene and the zeroed rows
      mbar_wait(hbar, hphase);

      // sigma (output column 0): h W9^T, W9's three parts
      float d8[4];
      {
        const uint32_t b = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_slab<8, 128>(d8, hs + s * A_SLAB, b + p * (NOUT * WIDTH * 2) + s * (NOUT * 128), (p | s) > 0);
        wgmma_commit();
        wgmma_wait0();
        acc_fence(d8, 4);
        ring.release(lane);
      }
      epilogue_to_out32(d8, sbias() + b_off(9), otile, 0, 1, 0, warp, lane);

      // g = feature W10[:, :256]^T, one half of the feature at a time
      float g[64];
#pragma unroll 1
      for (int hf = 0; hf < 2; ++hf) {
        float f[64];
#pragma unroll 1
        for (int c = 0; c < 6; ++c) {  // W8's part c / 2 on h's K-slabs 2 (c % 2) and 2 (c % 2) + 1
          const uint32_t b = ring.acquire();
          acc_fence(f, 64);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 2; ++s)
            mma_slab<128, 128>(f, hs + (2 * (c & 1) + s) * A_SLAB, b + s * (HALF * SLAB_K * 2), (c | s) > 0);
          wgmma_commit();
          wgmma_wait0();
          acc_fence(f, 64);
          ring.release(lane);
        }
        const float* b8 = sbias() + b_off(8) + hf * HALF;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b8 + 8 * j + q2));
          f[4 * j] += bb.x;
          f[4 * j + 1] += bb.y;
          f[4 * j + 2] += bb.x;
          f[4 * j + 3] += bb.y;
        }
#pragma unroll 1
        for (int p = 0; p < 3; ++p) {  // W10's part p of the half's feature columns
          const uint32_t b = ring.acquire();
          const int first = hf == 0 && p == 0;
          static_for<8>([&](auto c) { mma_g_step<decltype(c)::value>(g, f, b, p, decltype(c)::value == 0 && first); });
          ring.release(lane);
        }
      }

      // the view branch: the primary view gives rgb + vis (output columns
      // 1..4), secondary view v its vis (column 4 + v)
      const int lrow0 = (tile - scene * tps) * TILE16 + wg * ROWS_WG;  // within the scene
      const int row0 = scene * nps + lrow0;
      for (int v = 0; v <= n_sec; ++v) {
        // PE(dir) of view v as three bf16 part slabs; rows past the scene's end are zeros
        for (int i = tid; i < ROWS_WG * (VIEW_IN / 4); i += 128) {
          const int r = i >> 3, c4 = i & 7;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (lrow0 + r < nps)
            x = v == 0 ? __ldg(reinterpret_cast<const float4*>(ve + (size_t)(row0 + r) * VIEW_IN) + c4)
                       : __ldg(reinterpret_cast<const float4*>(ve2 + (size_t)(row0 + r) * ve2_ld + (v - 1) * VIEW_IN) +
                               c4);
          uint32_t lo[3], hi[3];
          split_pair(x.x, x.y, lo[0], lo[1], lo[2]);
          split_pair(x.z, x.w, hi[0], hi[1], hi[2]);
          const int off = HW_PE + r * 64 + (((c4 >> 1) ^ ((r >> 1) & 3)) << 4) + (c4 & 1) * 8;
#pragma unroll
          for (int k = 0; k < 3; ++k) *reinterpret_cast<uint2*>(mine + off + k * PE_SLAB) = make_uint2(lo[k], hi[k]);
        }
        fence_proxy_async();
        bar_sync(bar_id, 128);
        float hv[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) hv[i] = g[i];
        const uint32_t b = ring.acquire();
        acc_fence(hv, 64);
        wgmma_fence();
        // + PE(dir) W10[:, 256:]^T: the part products i + j <= 2, both from shared memory
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; i + j < 3; ++j) mma_slab<128, 64>(hv, pe + i * PE_SLAB, b + j * PEW_SLAB, 1);
        wgmma_commit();
        wgmma_wait0();
        acc_fence(hv, 64);
        const float* b10 = sbias() + b_off(10);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b10 + 8 * j + q2));
          hv[4 * j] = fmaxf(hv[4 * j] + bb.x, 0.f);
          hv[4 * j + 1] = fmaxf(hv[4 * j + 1] + bb.y, 0.f);
          hv[4 * j + 2] = fmaxf(hv[4 * j + 2] + bb.x, 0.f);
          hv[4 * j + 3] = fmaxf(hv[4 * j + 3] + bb.y, 0.f);
        }
        const uint32_t w11 = b + 3 * PEW_SLAB;
        static_for<8>([&](auto c) { mma_out_step<decltype(c)::value>(d8, hv, w11); });
        ring.release(lane);
        if (v == 0)
          epilogue_to_out32(d8, sbias() + b_off(11), otile, 0, 4, 1, warp, lane);
        else
          epilogue_to_out32(d8, sbias() + b_off(11), otile, 3, 4, 4 + v, warp, lane);
        bar_sync(bar_id, 128);  // no wgmma of this warpgroup still reads the PE(dir) slabs
      }
      // the raw rows, 32 bytes each; the next tile's first bar_sync orders
      // these reads before the rows are zeroed
      const int r = tid >> 1;
      if (lrow0 + r < nps)
        reinterpret_cast<float4*>(out + (size_t)(row0 + r) * NOUT)[tid & 1] =
            reinterpret_cast<const float4*>(otile + r * NOUT)[tid & 1];
    }
  }
}

// ------------------------------------------------------------------- f32

constexpr int BM32 = 64;
constexpr int THREADS32 = 256;
// row strides in floats: +4 puts consecutive rows 4 banks apart, so the
// 8-wide heads' reads of 8 rows at one k are conflict-free
constexpr int XE32_LD = PTS_IN + 4;
constexpr int H32_LD = WIDTH + 4;
constexpr int VE32_LD = VIEW_IN * (1 + MAX_SEC) + 4;
constexpr int WSLAB = 4096;  // floats of one weight slab (16 KB)
constexpr int SMEM32 = (BM32 * (XE32_LD + 2 * H32_LD + VE32_LD + NOUT) + 2 * WSLAB) * 4;
static_assert(SMEM32 <= 232448, "shared memory");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// Where a layer's output goes: a shared activation buffer (N >= 128), or
// columns [lo, hi) of an 8-wide head into output columns dst.. (N = 8).
struct Sink32 {
  float* p;
  int ld, lo, hi, dst;
};

// out = epilogue(A @ W + b), W^T (K, N) row-major in global memory, staged in
// K-slabs of KS rows (the whole layer for an 8-wide head). A is two column
// segments in shared memory (k1 columns, then the rest), so the skip and view
// concatenations are never copied.
template <int N, int K, bool RELU>
__device__ __forceinline__ void layer32(const float* a1, int lda1, int k1, const float* a2, int lda2,
                                        const float* __restrict__ wt, const float* __restrict__ bias, float* wbuf,
                                        Sink32 sink) {
  constexpr int KS = N == NOUT ? K : WSLAB / N;
  constexpr int NS = K / KS;
  static_assert(KS * N <= WSLAB && K % KS == 0 && KS % 4 == 0, "weight slabs");
  constexpr int RT = N == NOUT ? 1 : 8;                          // rows per thread
  constexpr int CT = N == 256 ? 8 : (N == 128 ? 4 : 2);          // columns per thread
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = N == NOUT ? tid >> 2 : (tid >> 5) * RT;
  auto load = [&](int s) {
    const float* src = wt + s * KS * N;
    float* dst = wbuf + (s & 1) * WSLAB;
    for (int i = tid; i < KS * N / 4; i += THREADS32) cp_async16(dst + 4 * i, src + 4 * i);
    cp_async_commit();
  };
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  load(0);
  for (int s = 0; s < NS; ++s) {
    if (s + 1 < NS) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wv = wbuf + (s & 1) * WSLAB;
    const int k0 = s * KS;
    const float* a = k0 < k1 ? a1 + k0 : a2 + (k0 - k1);
    const int lda = k0 < k1 ? lda1 : lda2;
    if constexpr (N == NOUT) {
      const int c0 = (tid & 3) * 2;
#pragma unroll 4
      for (int kk = 0; kk < KS; kk += 4) {
        const float4 av = *reinterpret_cast<const float4*>(a + r0 * lda + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 b = *reinterpret_cast<const float2*>(wv + (kk + q) * N + c0);
          acc[0][0] = fmaf(lane_of(av, q), b.x, acc[0][0]);
          acc[0][1] = fmaf(lane_of(av, q), b.y, acc[0][1]);
        }
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < KS; kk += 4) {
        float4 av[RT], bv[4][CT / 4];
#pragma unroll
        for (int i = 0; i < RT; ++i) av[i] = *reinterpret_cast<const float4*>(a + (r0 + i) * lda + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int g = 0; g < CT / 4; ++g)
            bv[q][g] = *reinterpret_cast<const float4*>(wv + (kk + q) * N + g * 128 + lane * 4);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float x = lane_of(av[i], q);
#pragma unroll
            for (int g = 0; g < CT / 4; ++g) {
              acc[i][4 * g + 0] = fmaf(x, bv[q][g].x, acc[i][4 * g + 0]);
              acc[i][4 * g + 1] = fmaf(x, bv[q][g].y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(x, bv[q][g].z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(x, bv[q][g].w, acc[i][4 * g + 3]);
            }
          }
      }
    }
    __syncthreads();
  }

  if constexpr (N == NOUT) {
    const int c0 = (tid & 3) * 2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + e;
      if (c >= sink.lo && c < sink.hi) sink.p[r0 * NOUT + sink.dst + c - sink.lo] = acc[0][e] + bias[c];
    }
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int g = 0; g < CT / 4; ++g) {
        const int c = g * 128 + lane * 4;
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + c));
        float4 v = make_float4(acc[i][4 * g] + b.x, acc[i][4 * g + 1] + b.y, acc[i][4 * g + 2] + b.z,
                               acc[i][4 * g + 3] + b.w);
        if (RELU) v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
        *reinterpret_cast<float4*>(sink.p + (r0 + i) * sink.ld + c) = v;
      }
  }
}

template <bool SCENES>
__global__ void __launch_bounds__(THREADS32, 1)
    fused_mlp_f32_kernel(const float* __restrict__ xe, const float* __restrict__ ve,
                         const float* __restrict__ ve2, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ out, int n, int n_sec) {
  // blockIdx.x is block t % tps of scene t / tps: move every pointer to the
  // scene's rows and weights, then n counts the scene's rows
  const int tps = (n + BM32 - 1) / BM32;
  const int scene = SCENES ? blockIdx.x / tps : 0;
  if (SCENES) {
    xe += (size_t)scene * n * PTS_IN;
    ve += (size_t)scene * n * VIEW_IN;
    ve2 += (size_t)scene * n * VIEW_IN * (n_sec > 0 ? n_sec : 1);
    out += (size_t)scene * n * NOUT;
    w += (size_t)scene * W_ELEMS;
    bias += (size_t)scene * B_ELEMS;
  }
  extern __shared__ __align__(16) float smem32[];
  float* sx = smem32;                // [BM][XE32_LD]
  float* h0 = sx + BM32 * XE32_LD;   // [BM][H32_LD]
  float* h1 = h0 + BM32 * H32_LD;    // [BM][H32_LD]
  float* sv = h1 + BM32 * H32_LD;    // [BM][VE32_LD]
  float* so = sv + BM32 * VE32_LD;   // [BM][NOUT]
  float* wbuf = so + BM32 * NOUT;    // [2][WSLAB]

  const int row0 = (blockIdx.x - scene * tps) * BM32;
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ve2_ld = VIEW_IN * (n_sec > 0 ? n_sec : 1);

  for (int i = tid; i < BM32 * (PTS_IN / 4); i += THREADS32) {
    const int r = i / (PTS_IN / 4), c = i % (PTS_IN / 4);
    const float4 v =
        row0 + r < n ? __ldg(reinterpret_cast<const float4*>(xe + (size_t)(row0 + r) * PTS_IN) + c) : zero;
    *reinterpret_cast<float4*>(sx + r * XE32_LD + c * 4) = v;
  }
  const int vpieces = (VIEW_IN / 4) * (1 + n_sec);
  for (int i = tid; i < BM32 * vpieces; i += THREADS32) {
    const int r = i / vpieces, c = i % vpieces;
    float4 v = zero;
    if (row0 + r < n) {
      v = c < VIEW_IN / 4
              ? __ldg(reinterpret_cast<const float4*>(ve + (size_t)(row0 + r) * VIEW_IN) + c)
              : __ldg(reinterpret_cast<const float4*>(ve2 + (size_t)(row0 + r) * ve2_ld) + c - VIEW_IN / 4);
    }
    *reinterpret_cast<float4*>(sv + r * VE32_LD + c * 4) = v;
  }
  for (int i = tid; i < BM32 * NOUT; i += THREADS32) so[i] = 0.f;
  __syncthreads();

  const Sink32 to_h0{h0, H32_LD, 0, 0, 0}, to_h1{h1, H32_LD, 0, 0, 0};
#define W32(l) (w + w_off(l))
#define B32(l) (bias + b_off(l))
  // trunk: activations ping-pong between h0 and h1
  layer32<256, 64, true>(sx, XE32_LD, 64, sx, XE32_LD, W32(0), B32(0), wbuf, to_h0);
  __syncthreads();
  layer32<256, 256, true>(h0, H32_LD, 256, h0, H32_LD, W32(1), B32(1), wbuf, to_h1);
  __syncthreads();
  layer32<256, 256, true>(h1, H32_LD, 256, h1, H32_LD, W32(2), B32(2), wbuf, to_h0);
  __syncthreads();
  layer32<256, 256, true>(h0, H32_LD, 256, h0, H32_LD, W32(3), B32(3), wbuf, to_h1);
  __syncthreads();
  layer32<256, 256, true>(h1, H32_LD, 256, h1, H32_LD, W32(4), B32(4), wbuf, to_h0);
  __syncthreads();
  // skip layer: [xe, h] with no copy
  layer32<256, 320, true>(sx, XE32_LD, 64, h0, H32_LD, W32(5), B32(5), wbuf, to_h1);
  __syncthreads();
  layer32<256, 256, true>(h1, H32_LD, 256, h1, H32_LD, W32(6), B32(6), wbuf, to_h0);
  __syncthreads();
  layer32<256, 256, true>(h0, H32_LD, 256, h0, H32_LD, W32(7), B32(7), wbuf, to_h1);
  __syncthreads();
  // heads: feature -> h0, sigma -> output column 0
  layer32<256, 256, false>(h1, H32_LD, 256, h1, H32_LD, W32(8), B32(8), wbuf, to_h0);
  layer32<8, 256, false>(h1, H32_LD, 256, h1, H32_LD, W32(9), B32(9), wbuf, Sink32{so, NOUT, 0, 1, 0});
  __syncthreads();
  // view branch, primary view: rgb + vis -> output columns 1..4; secondary
  // view j: vis -> output column 5 + j
  for (int j = 0; j <= n_sec; ++j) {
    layer32<128, 288, true>(h0, H32_LD, 256, sv + VIEW_IN * j, VE32_LD, W32(10), B32(10), wbuf, to_h1);
    __syncthreads();
    const Sink32 heads = j == 0 ? Sink32{so, NOUT, 0, 4, 1} : Sink32{so, NOUT, 3, 4, 4 + j};
    layer32<8, 128, false>(h1, H32_LD, 128, h1, H32_LD, W32(11), B32(11), wbuf, heads);
    __syncthreads();
  }
#undef W32
#undef B32

  for (int i = tid; i < BM32 * 2; i += THREADS32) {
    const int r = i >> 1, c = i & 1;
    if (row0 + r < n)
      reinterpret_cast<float4*>(out + (size_t)(row0 + r) * NOUT)[c] = reinterpret_cast<const float4*>(so + r * NOUT)[c];
  }
}

// ------------------------------------------------------------- K1's inputs
//
// k1_encode_kernel writes what every K1 launch reads, in one pass over the
// points: xe (N, 64) in the trunk's type, ve (N, 32) and ve2 (N, 32 n_sec) in
// the heads', each row the positional encoding of kernels/fused_mlp.py
// `encode_reference` ([x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...], each
// block over the 3 coordinates; degree 10 for the point, 4 for a direction)
// and its zero padding. It replaces no TPU kernel: XLA fuses the encoding into
// K1's operands; in PyTorch it was ~10 kernels per input (multiply, sin, cos,
// stack, cat, pad, cast).
//
// What bounds it: bytes. A point reads 12 B, and 12 more per secondary view
// (its ray's direction, read through the sample stride row / samples, is
// shared by the ray's points), and writes 256-768 B. Its 42-66 sincosf fit
// under that time.
// - A CTA of ENC_ROWS threads encodes ENC_ROWS rows, one a thread, in
//   registers, and writes each output (xe, ve, each view of ve2) through
//   shared memory: a thread stores its row as 16-byte chunks (rows padded by
//   16 B, so the 8 threads of a store phase hit distinct banks), then the CTA
//   copies the block out as 16-byte vectors of contiguous rows, whole
//   128-byte lines per 8 threads.
// - Numerics of the torch chain, bit for bit: x * 2^k is exact in f32;
//   sincosf is CUDA's precise one (this library has no fast math); the
//   fast_encoding recurrence s, c <- (2s)c, (c-s)(c+s) in __fmul_rn,
//   __fadd_rn and __fsub_rn, so nothing contracts into an FMA; bf16 by
//   __float2bfloat16_rn.
constexpr int ENC_ROWS = 128;

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// the 16-byte chunk c of a row of float values, in type T
template <typename T>
__device__ __forceinline__ uint4 enc_chunk(const float* v, int c) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(v[4 * c]), __float_as_uint(v[4 * c + 1]), __float_as_uint(v[4 * c + 2]),
                      __float_as_uint(v[4 * c + 3]));
  } else {
    return make_uint4(bf16_pair(v[8 * c], v[8 * c + 1]), bf16_pair(v[8 * c + 2], v[8 * c + 3]),
                      bf16_pair(v[8 * c + 4], v[8 * c + 5]), bf16_pair(v[8 * c + 6], v[8 * c + 7]));
  }
}

// v[0, W): x, then per frequency k sin(2^k x), cos(2^k x), each over the 3
// coordinates, then zeros
template <int DEG, int W, bool FAST>
__device__ __forceinline__ void enc_pe(const float (&x)[3], float (&v)[W]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) v[d] = x[d];
  if constexpr (FAST) {
    float s[3], c[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) sincosf(x[d], &s[d], &c[d]);
#pragma unroll
    for (int k = 0; k < DEG; ++k) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        v[3 + 6 * k + d] = s[d];
        v[6 + 6 * k + d] = c[d];
        const float s2 = __fmul_rn(__fmul_rn(2.0f, s[d]), c[d]);
        c[d] = __fmul_rn(__fsub_rn(c[d], s[d]), __fadd_rn(c[d], s[d]));
        s[d] = s2;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < DEG; ++k) {
#pragma unroll
      for (int d = 0; d < 3; ++d) sincosf(__fmul_rn(x[d], (float)(1 << k)), &v[3 + 6 * k + d], &v[6 + 6 * k + d]);
    }
  }
#pragma unroll
  for (int i = 3 * (1 + 2 * DEG); i < W; ++i) v[i] = 0.0f;
}

// this thread's row of the encoding of x, W values of T in 16-byte chunks,
// into its row of the stage (SC chunks a row)
template <typename T, int DEG, int W, bool FAST, int SC>
__device__ __forceinline__ void enc_stage(uint4* stage, const float (&x)[3]) {
  float v[W];
  enc_pe<DEG, W, FAST>(x, v);
#pragma unroll
  for (int c = 0; c < W * (int)sizeof(T) / 16; ++c) stage[threadIdx.x * SC + c] = enc_chunk<T>(v, c);
}

// the stage's first `rows` rows (CHUNKS chunks each) to rows row0.. of out
// (`stride` chunks a row), from chunk `col` of each
template <int CHUNKS, int SC>
__device__ __forceinline__ void enc_write(const uint4* stage, uint4* out, long long row0, int rows, int stride,
                                          int col) {
  for (int q = threadIdx.x; q < rows * CHUNKS; q += ENC_ROWS) {
    const int r = q / CHUNKS, c = q % CHUNKS;
    out[(row0 + r) * stride + col + c] = stage[r * SC + c];
  }
}

template <typename TT, typename HT, bool FAST>
__global__ void __launch_bounds__(ENC_ROWS, 4)
    k1_encode_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, const float* __restrict__ dirs2,
                     TT* __restrict__ xe, HT* __restrict__ ve, HT* __restrict__ ve2, int n, int samples, int n_sec) {
  constexpr int XC = PTS_IN * (int)sizeof(TT) / 16, VC = VIEW_IN * (int)sizeof(HT) / 16;
  constexpr int SC = (XC > VC ? XC : VC) + 1;
  __shared__ uint4 stage[ENC_ROWS * SC];
  const long long row0 = (long long)blockIdx.x * ENC_ROWS, p = row0 + threadIdx.x;
  const int rows = n - row0 < ENC_ROWS ? (int)(n - row0) : ENC_ROWS;
  const bool live = p < n;
  const int pi = live ? (int)p : 0, ray = pi / samples;  // 32-bit division: rows are ints
  float x[3], d[3], d2[MAX_SEC][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = live ? pts[3LL * pi + i] : 0.0f;
    d[i] = live ? dirs[3LL * ray + i] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < MAX_SEC; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) d2[j][i] = live && j < n_sec ? dirs2[3 * ((long long)pi * n_sec + j) + i] : 0.0f;
  }

  if (live) enc_stage<TT, 10, PTS_IN, FAST, SC>(stage, x);
  __syncthreads();
  enc_write<XC, SC>(stage, reinterpret_cast<uint4*>(xe), row0, rows, XC, 0);
  __syncthreads();
  if (live) enc_stage<HT, 4, VIEW_IN, FAST, SC>(stage, d);
  __syncthreads();
  enc_write<VC, SC>(stage, reinterpret_cast<uint4*>(ve), row0, rows, VC, 0);
#pragma unroll
  for (int j = 0; j < MAX_SEC; ++j) {
    if (j >= n_sec) break;
    __syncthreads();
    if (live) enc_stage<HT, 4, VIEW_IN, FAST, SC>(stage, d2[j]);
    __syncthreads();
    enc_write<VC, SC>(stage, reinterpret_cast<uint4*>(ve2), row0, rows, n_sec * VC, j * VC);
  }
}

template <typename TT, typename HT>
int launch_encode(const void* pts, const void* dirs, const void* dirs2, void* xe, void* ve, void* ve2, int n,
                  int samples, int n_sec, bool fast, void* stream) {
  auto kernel = fast ? k1_encode_kernel<TT, HT, true> : k1_encode_kernel<TT, HT, false>;
  kernel<<<(int)(((long long)n + ENC_ROWS - 1) / ENC_ROWS), ENC_ROWS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)dirs, (const float*)dirs2, (TT*)xe, (HT*)ve, (HT*)ve2, n, samples, n_sec);
  return (int)cudaGetLastError();
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

}  // namespace

// dynamic shared memory per CTA of each kernel: 0 the f32 one, 1 the bf16 one
// (its trunk too), 2 the bf16_f32h heads; ptxas reports static only
extern "C" int vipnerf_fused_mlp_smem_bytes(int kernel) {
  return kernel == 2 ? SMEMH : (kernel == 1 ? SMEM16 : SMEM32);
}

// rows are indexed with int: all scenes' rows together must fit
static bool rows_fit(int scenes, int n_per_scene) {
  return scenes >= 1 && (long long)scenes * n_per_scene <= 0x7fffffffLL;
}

template <bool TRUNK>
static int launch16(const void* xe, const void* ve, const void* ve2, const void* w, const void* bias, void* out,
                    int scenes, int n_per_scene, int n_sec, void* stream) {
  auto kernel = scenes > 1 ? fused_mlp_bf16_kernel<true, TRUNK> : fused_mlp_bf16_kernel<false, TRUNK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM16);
  if (e != cudaSuccess) return (int)e;
  if (n_per_scene <= 0) return 0;
  const int tiles = scenes * ((n_per_scene + TILE16 - 1) / TILE16), sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  kernel<<<tiles < sms ? tiles : sms, THREADS16, SMEM16, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)xe, (const __nv_bfloat16*)ve, (const __nv_bfloat16*)ve2, (const __nv_bfloat16*)w,
      (const float*)bias, (__nv_bfloat16*)out, scenes, n_per_scene, n_sec);
  return (int)cudaGetLastError();
}

static int launch32(const void* xe, const void* ve, const void* ve2, const void* w, const void* bias, void* out,
                    int scenes, int n_per_scene, int n_sec, void* stream) {
  auto kernel = scenes > 1 ? fused_mlp_f32_kernel<true> : fused_mlp_f32_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM32);
  if (e != cudaSuccess) return (int)e;
  if (n_per_scene <= 0) return 0;
  kernel<<<scenes * ((n_per_scene + BM32 - 1) / BM32), THREADS32, SMEM32, (cudaStream_t)stream>>>(
      (const float*)xe, (const float*)ve, (const float*)ve2, (const float*)w, (const float*)bias, (float*)out,
      n_per_scene, n_sec);
  return (int)cudaGetLastError();
}

static int launch_heads(const void* h, const void* ve, const void* ve2, const void* w, const void* bias, void* out,
                        int scenes, int n_per_scene, int n_sec, void* stream) {
  auto kernel = scenes > 1 ? fused_mlp_heads_kernel<true> : fused_mlp_heads_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEMH);
  if (e != cudaSuccess) return (int)e;
  if (n_per_scene <= 0) return 0;
  const int tiles = scenes * ((n_per_scene + TILE16 - 1) / TILE16), sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  kernel<<<tiles < sms ? tiles : sms, THREADS16, SMEMH, (cudaStream_t)stream>>>(
      (const unsigned char*)h, (const float*)ve, (const float*)ve2, (const unsigned char*)w, (const float*)bias,
      (float*)out, scenes, n_per_scene, n_sec);
  return (int)cudaGetLastError();
}

// xe, ve, ve2 and out hold `scenes` blocks of n_per_scene rows each; w and
// bias hold `scenes` packs of weights and biases, in the same order.
extern "C" int vipnerf_fused_mlp_bf16(const void* xe, const void* ve, const void* ve2, const void* w,
                                      const void* bias, void* out, int scenes, int n_per_scene, int n_sec,
                                      void* stream) {
  if (n_sec < 0 || n_sec > MAX_SEC || !rows_fit(scenes, n_per_scene)) return (int)cudaErrorInvalidValue;
  return launch16<false>(xe, ve, ve2, w, bias, out, scenes, n_per_scene, n_sec, stream);
}

extern "C" int vipnerf_fused_mlp_f32(const void* xe, const void* ve, const void* ve2, const void* w,
                                     const void* bias, void* out, int scenes, int n_per_scene, int n_sec,
                                     void* stream) {
  if (n_sec < 0 || n_sec > MAX_SEC || !rows_fit(scenes, n_per_scene)) return (int)cudaErrorInvalidValue;
  return launch32(xe, ve, ve2, w, bias, out, scenes, n_per_scene, n_sec, stream);
}

// xe bf16; ve, ve2 and out f32; w the bf16_f32h packs (bytes); h scratch for
// the trunk's output, 32 KB per 64 rows: scenes * 2 * ceil(n_per_scene / 128)
// blocks. Two launches on the stream: the trunk, then the heads.
extern "C" int vipnerf_fused_mlp_bf16_f32h(const void* xe, const void* ve, const void* ve2, const void* w,
                                           const void* bias, void* h, void* out, int scenes, int n_per_scene,
                                           int n_sec, void* stream) {
  if (n_sec < 0 || n_sec > MAX_SEC || !rows_fit(scenes, n_per_scene)) return (int)cudaErrorInvalidValue;
  const int e = launch16<true>(xe, nullptr, nullptr, w, bias, h, scenes, n_per_scene, 0, stream);
  if (e != 0) return e;
  return launch_heads(h, ve, ve2, w, bias, out, scenes, n_per_scene, n_sec, stream);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, through the runtime (no link to libcuda)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The shipped mode's trunk recomputed for its backward (trunk_recompute_kernel):
// xe (N, 64) bf16 and w, bias the bf16_f32h packs; outputs xe_img (8 KB per
// 64 rows), himg (h1..h7, each scenes * 2 * ceil(n_per_scene / 128) blocks of
// 32 KB) and h8 (N, 256) bf16. One launch on the stream.
extern "C" int vipnerf_trunk_recompute(const void* xe, const void* w, const void* bias, void* xe_img, void* himg,
                                       void* h8, int scenes, int n_per_scene, void* stream) {
  if (!rows_fit(scenes, n_per_scene)) return (int)cudaErrorInvalidValue;
  auto kernel = scenes > 1 ? trunk_recompute_kernel<true> : trunk_recompute_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEMR);
  if (e != cudaSuccess) return (int)e;
  if (n_per_scene <= 0) return 0;
  const int tiles = scenes * ((n_per_scene + TILE16 - 1) / TILE16), sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // h8 as (scenes, rows, columns): a box is one slab, 64 rows x 64 columns
  const cuuint64_t dims[3] = {WIDTH, (cuuint64_t)n_per_scene, (cuuint64_t)scenes};
  const cuuint64_t strides[2] = {WIDTH * 2, (cuuint64_t)n_per_scene * WIDTH * 2};
  const cuuint32_t box[3] = {SLAB_K, ROWS_WG, 1}, one[3] = {1, 1, 1};
  CUtensorMap map;
  const EncodeTiled encode = encode_tiled();
  if (!encode || encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, h8, dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  kernel<<<tiles < sms ? tiles : sms, THREADS16, SMEMR, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)xe, (const __nv_bfloat16*)w, (const float*)bias, (unsigned char*)xe_img,
      (unsigned char*)himg, map, scenes, n_per_scene);
  return (int)cudaGetLastError();
}

// K1's inputs from n points (pts (n, 3) f32), their view directions (dirs
// (n / samples, 3) f32: row r of the points reads direction r / samples) and,
// for n_sec > 0, their secondary view directions (dirs2 (n, n_sec, 3) f32):
// xe (n, 64) in the trunk's type, ve (n, 32) and ve2 (n, 32 n_sec) in the
// heads' (f32 where trunk_f32 / heads_f32 is set, else bf16; a bf16 trunk with
// f32 heads is bf16_f32h, an f32 trunk takes f32 heads). fast: the config's
// fast_encoding recurrence. One launch on the stream.
extern "C" int vipnerf_k1_encode(const void* pts, const void* dirs, const void* dirs2, void* xe, void* ve,
                                 void* ve2, int n, int samples, int n_sec, int trunk_f32, int heads_f32, int fast,
                                 void* stream) {
  if (n < 0 || samples < 1 || n_sec < 0 || n_sec > MAX_SEC || (n_sec > 0 && (!dirs2 || !ve2)) ||
      (trunk_f32 && !heads_f32))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (trunk_f32) return launch_encode<float, float>(pts, dirs, dirs2, xe, ve, ve2, n, samples, n_sec, fast, stream);
  if (heads_f32)
    return launch_encode<__nv_bfloat16, float>(pts, dirs, dirs2, xe, ve, ve2, n, samples, n_sec, fast, stream);
  return launch_encode<__nv_bfloat16, __nv_bfloat16>(pts, dirs, dirs2, xe, ve, ve2, n, samples, n_sec, fast,
                                                      stream);
}
