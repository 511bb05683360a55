// K1's backward in the shipped mode (bf16 trunk, f32 heads) for Hopper
// (sm_90a): the gradient of the f32 heads, layers 8-11.
//
// Counterpart of the bwd of experiments/fused_mlp.py's jax.custom_vjp
// (_make_fused_raw: bwd differentiates _raw_xla, which XLA computes with no
// Pallas kernel of its own), restricted to the heads, which the JAX package
// runs in f32 (vipnerf_tpu/models/mlp.py apply_mlp with f32_heads: h upcast,
// then _dense in f32). The trunk's backward stays autograd in
// kernels/fused_mlp.py; these two kernels give it d h.
//
// The function, per scene, on N points with V = 1 + n_sec views:
//   feature = h W8^T + b8; per view hv_v = relu([feature, pe_v] W10^T + b10)
//   d hv_v = (d o_v W11) [hv_v > 0]; D = sum_v d hv_v
//   d feature = D W10[:, :256]; d h = bf16(d feature W8 + d sigma W9)
//   dW8 = d feature^T h, dW9 = d sigma^T h, dW10 = [D^T feature, sum_v d hv_v^T pe_v],
//   dW11 = sum_v d o_v^T hv_v, the biases' column sums, d pe_v = d hv_v W10[:, 256:]
//
// Arithmetic: every f32 product of the big layers runs on the bf16 tensor
// cores (wgmma, f32 accumulation) as products of split operands, as the
// forward heads kernel does (csrc/fused_mlp.cu): an f32 value is three bf16
// parts that sum to it exactly. A bf16 operand (h) times an f32 one takes
// the three products h p_j; two f32 operands take the six a_i b_j with
// i + j <= 2. The tensor cores round each wgmma's sum toward zero (PERF.md
// section 6), so no accumulator runs a long chain at the scale of its sum:
// - per-point kernel: each k16 step's part products go into a fresh
//   accumulator, smallest first, and its sum joins the running f32 total
//   with an ordinary (round-to-nearest) add: CHAIN = 1 k16 step per chain;
// - weight kernel: an accumulator chain runs PROMOTE = 2 k16 steps (a
//   block of 32 points), its part products ordered by size over the whole
//   block (every i + j = 2 product of both steps, then i + j = 1, then the
//   two (0, 0) products), so that no small product is added to a sum of
//   full size; then a Fast2Sum moves it into an f32 total and leaves the
//   rounding error in the accumulator, where the next chain adds to it.
//   Each CTA writes its share (KSPLIT points) as f64 (total + accumulator);
//   a second launch sums each output's shares in f64 in a fixed order, so
//   the result does not depend on the CTAs' timing (no float atomics).
// The chain length and the interval are sized by the numpy emulation in
// tests/test_torch_heads_backward.py, which shows longer chains and no
// promotion missing the tolerances.
//
// What bounds them: the per-point kernel, tensor-core operations (~1.06M
// bf16 products per point at n_sec 2) against its weight stream from L2
// (1.2 MB of split weights per 128 points); the weight kernel, the bytes of
// its inputs (~6.6 KB per point of intermediates, h, PE(dir) and g, each
// read once from device memory) (PERF.md section 6).
//
// Per-point kernel (heads_bwd_points_kernel), shaped like the forward's
// fused_mlp_heads_kernel: a persistent CTA per SM, one producer thread
// streaming the scene's weight image (`heads_bwd_stream` in
// kernels/fused_mlp.py: 50 chunks of 24 KB, each the three bf16 parts of a
// (rows x 32 K) block, 64-byte-swizzled K-major, one bulk copy each) into a
// 4-stage mbarrier ring, and two consumer warpgroups of 64 points each.
// - feature = h W8^T + b8: A is h, loaded into 128-byte-swizzled K-major
//   slabs, B the W8 chunk (wgmma with both operands in shared memory), a
//   half of 128 columns at a time; after each half, G += feature_half
//   W10f^T with A from registers: an accumulator's fragment is, pair for
//   pair, the next product's A fragment, split into its parts in registers.
// - G then waits in shared memory (thread-private slots) while each view's
//   hv_v (A: PE(dir) from device memory, split in registers), d hv_v (CUDA
//   cores), D (registers) and d PE(dir) (A: d hv_v in registers) run.
// - d feature = D W10f from registers (D never leaves them), parked in
//   thread-private slots; d h = d feature W8 + d sigma W9 from the slots.
//   Feature, hv_v, d hv_v, D and d feature are written once, for the weight
//   kernel; nothing is read back from device memory.
// Registers: at most three 64-float accumulator sets (the total being
// built, the fresh accumulator, and G or D) plus one step's split
// fragments; D accumulates in thread-private slots while the views run.
//
// Weight kernel (heads_bwd_weights_kernel): dW = X^T Y over the point axis.
// The reduction axis is the rows as they arrive, so both wgmma operands are
// MN-major (the transpose bits set): a producer thread copies point-major
// row blocks of X and Y (32 points of a tile's columns, one tensor-map box
// each, cp.async.bulk.tensor, so that two copies per block move strided
// rows) into a 3-stage ring; the consumer warpgroups split each f32 element
// into its three parts once per CTA and write them in the orientation they
// were loaded in, as 128-byte-swizzled (64-byte for 32 columns) MN-major
// slabs, double buffered, and run the block's chain (both operands from
// shared memory, m64n128 or m64n32) while the next block is split. No
// __syncthreads in the loop: the ring's mbarriers, and one named barrier of
// the two consumer warpgroups per block. A second launch sums the shares.
// Jobs, each a grid of (output tile, split of KSPLIT points):
//   dW8 = d feature^T h  (64 x 256 tiles: d feature split once, h copied),
//         b8 beside;
//   dW10[:, :256] = D^T feature (128 x 128 tiles: feature split once), b10;
//   dW10[:, 256:] = sum_v d hv_v^T PE(dir)_v (128 x 32, a split per view);
//   the small ones, dW9 = d sigma^T h, dW11 = sum_v d o_v^T hv_v, b9 and
//   b11, in f64 on the CUDA cores (every product exact), d o from g.
// Column sums are f64. L2 bytes per launch by design: k1.bwd_stream_bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int WIDTH = 256;
constexpr int HID = 128;
constexpr int VIEW_IN = 32;
constexpr int NOUT = 8;
constexpr int MAX_SEC = 3;

// one scene's f32 small weights: b8, b10, W9, W11 (4 rows)
constexpr int S_B8 = 0, S_B10 = WIDTH, S_W9 = WIDTH + HID, S_W11 = 2 * WIDTH + HID;
constexpr int SMALL_ELEMS = S_W11 + 4 * HID;

// One scene's weight stream (kernels/fused_mlp.py heads_bwd_stream): chunks
// of the three bf16 parts (part p at p * PART) of a (rows x 32 K) block of a
// matrix, 64-byte-swizzled K-major (row n at 64 n bytes).
constexpr int CHUNK = 24576;
constexpr int PART = CHUNK / 3;
constexpr int C_W8 = 0;      // W8 rows [128 hf, +128), K [32 c, +32): chunk 12 hf + c (c < 8)
constexpr int C_W10F = 8;    // W10's feature columns [128 hf + 32 c, +32), 128 rows: chunk 12 hf + 8 + c (c < 4)
constexpr int C_W10P = 24;   // W10's PE(dir) columns (128 x 32)
constexpr int C_W10PT = 25;  // their transpose (32 x 128): K-block s (32 rows x 32 K) at s * 2048
constexpr int C_W10FT = 26;  // W10f^T rows [128 hf, +128), K [32 c, +32): 26 + 4 hf + c (c < 4)
constexpr int C_W8T = 34;    // W8^T rows [128 hh, +128), K [32 c, +32): 34 + 8 hh + c (c < 8)
constexpr int STREAM_CHUNKS = 50;
constexpr long long STREAM_BYTES = (long long)STREAM_CHUNKS * CHUNK;
static_assert(SMALL_ELEMS == 1152 && STREAM_BYTES == 1228800, "heads_bwd_stream");

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// a box of a tensor map (2-D or 3-D, coordinates innermost first) global ->
// shared, completing its bytes on the mbarrier
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
          "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// 1-D bulk copy global -> shared, completing `bytes` on the mbarrier
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// thread stores into shared memory -> visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void acc_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand with the SW-byte
// swizzle (SW = 128 or 64): rows of SW bytes, 8-row groups SW * 8 bytes
// apart (the stride byte offset); the leading byte offset is unused.
template <int SW>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  static_assert(SW == 128 || SW == 64, "swizzle");
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(8 * SW / 16) << 32) | (static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62);
}

// Descriptor of an MN-major operand (the transpose bit set) with the SW-byte
// swizzle: each K row holds SW bytes of consecutive MN elements (an atom of
// SW / 2 bf16), 8 K rows per swizzle atom; `lbo` bytes from one MN atom to
// the next (the leading byte offset), `sbo` bytes from 8 K rows to the next
// 8 (the stride byte offset). kernels/fused_mlp.py bwd_mn_layout computes the
// same offsets and the CPU tests pin them.
template <int SW>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(SW == 128 || SW == 64, "swizzle");
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62);
}

#define ACC8(i)                                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS64                                                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory; TA, TB
// the transpose bits (1: the operand is MN-major). The accumulator fragment
// of thread t of the warpgroup: d[4j + 2h + e] is row 16 (t / 32) + (t % 32)
// / 4 + 8h, column 8j + 2 (t % 4) + e.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
               : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
               : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// the same for N = 32 in d[0..15]
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
               "%11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
               : ACC8(0), ACC8(8)
               : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// A from registers: a[i] is fragment register i of the k16 step, a bf16
// pair (lower column in the low half): (row r, columns 2 (lane % 4) + {0,
// 1}), (row r + 8, the same), (row r, 8 more), (row r + 8, 8 more), r = 16
// warp + lane / 4 -- the order of an accumulator's d[8c .. 8c + 7] for
// columns [16c, 16c + 16). B K-major from shared memory.
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
               "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
               : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
               "%11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
               : ACC8(0), ACC8(8)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef REGS64
#undef ACC8

// x = part 0 + part 1 + part 2 exactly, each part the bf16 (round to nearest
// even) of what the parts before it leave; a pair of floats gives a bf16 pair
// per part (x in the low half)
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

// the parts' A fragments of a k16 step from its four float pairs
__device__ __forceinline__ void split_frag(const float2 (&v)[4], uint32_t (&a)[3][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) split_pair(v[k].x, v[k].y, a[0][k], a[1][k], a[2][k]);
}

// ... of the k16 step over columns [16C, 16C + 16) of an accumulator
template <int C, int R>
__device__ __forceinline__ void split_acc(const float (&f)[R], uint32_t (&a)[3][4]) {
  const float2 v[4] = {make_float2(f[8 * C], f[8 * C + 1]), make_float2(f[8 * C + 2], f[8 * C + 3]),
                       make_float2(f[8 * C + 4], f[8 * C + 5]), make_float2(f[8 * C + 6], f[8 * C + 7])};
  split_frag(v, a);
}

// keeps the compiler from reusing A fragment registers before the wgmma
// that reads them has completed
__device__ __forceinline__ void frag_fence(uint32_t (&a)[3][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}

// f(std::integral_constant<int, C>{}) for C = 0 .. N - 1 in order: a loop
// whose index stays a constant expression in f
template <int... C, typename F>
__device__ __forceinline__ void static_for(F&& f, std::integer_sequence<int, C...>) {
  (f(std::integral_constant<int, C>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for(f, std::make_integer_sequence<int, N>{});
}

// The part pairs (A's part, B's part) of two split operands with i + j <= 2,
// smallest first (q = 0..5: (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0));
// class(q) = i + j
__host__ __device__ constexpr int pair6_a(int q) { return q == 0 ? 2 : (q == 1 || q == 3 ? 1 : 0); }
__host__ __device__ constexpr int pair6_b(int q) { return q == 2 ? 2 : (q == 1 || q == 4 ? 1 : 0); }

template <int N>
__device__ __forceinline__ void add_into(float (&tot)[N], const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) tot[i] = __fadd_rn(tot[i], x[i]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// -------------------------------------------------------- per-point kernel

constexpr int CONSUMERS = 2;                    // consumer warpgroups per CTA
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr int ROWS_WG = 64;                     // points per consumer warpgroup
constexpr int TILE = ROWS_WG * CONSUMERS;       // points per tile
constexpr int CHAIN = 1;                        // k16 steps per fresh accumulator
constexpr int A_SLAB = ROWS_WG * 64 * 2;        // 64 rows x 64 K of h, 128-byte swizzle
constexpr int REGION = 65536;                   // a consumer warpgroup's: h, then its parked rows
constexpr int PSTAGES = 4;
constexpr int P_RING = CONSUMERS * REGION;
constexpr int P_BARS = P_RING + PSTAGES * CHUNK;
constexpr int SMEM_P = P_BARS + 2 * PSTAGES * 8 + 1024;  // + slack to align the base to 1 KB
static_assert(SMEM_P <= 232448 && 4 * A_SLAB <= REGION && 128 * 128 * 4 == REGION && CHAIN == 1, "budget");

// The weight ring as a consumer sees it: `it` counts the chunks consumed.
struct Ring {
  uint32_t stages, full, empty, it;
  __device__ __forceinline__ uint32_t acquire() {
    const uint32_t s = it % PSTAGES;
    mbar_wait(full + 8 * s, (it / PSTAGES) & 1);
    return stages + s * CHUNK;
  }
  __device__ __forceinline__ void release(int lane) {
    if (lane == 0) mbar_arrive(empty + 8 * (it % PSTAGES));
    ++it;
  }
};

// tot += the part products of one k16 step into a fresh accumulator, A
// from registers (the three parts a), B the chunk's three parts at b (+
// part * PART), smallest first
__device__ __forceinline__ void step_rs6(float (&tot)[64], float (&t)[64], uint32_t (&a)[3][4], uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 6; ++q) wgmma_n128_rs(t, a[pair6_a(q)], desc_k<64>(b + pair6_b(q) * PART), q > 0);
  wgmma_commit();
  wgmma_wait0();
  acc_fence(t);
  frag_fence(a);
  add_into(tot, t);
}

// the four float pairs of a k16 step's A fragment over columns [k, k + 16)
// of rows r and r + 8 of an f32 matrix (row length ld; zeros for rows past
// the scene's end)
__device__ __forceinline__ void load_frag(float2 (&x)[4], const float* src, size_t ld, int r, int k, bool lo,
                                          bool hi) {
  const float2 z = make_float2(0.f, 0.f);
  const float* row_lo = src + (size_t)r * ld + k;
  const float* row_hi = row_lo + 8 * ld;
  x[0] = lo ? __ldg(reinterpret_cast<const float2*>(row_lo)) : z;
  x[1] = hi ? __ldg(reinterpret_cast<const float2*>(row_hi)) : z;
  x[2] = lo ? __ldg(reinterpret_cast<const float2*>(row_lo + 8)) : z;
  x[3] = hi ? __ldg(reinterpret_cast<const float2*>(row_hi + 8)) : z;
}

// stores an n128 accumulator's columns [c0, c0 + 128) of rows r and r + 8
// (or the n32 one's [c0, c0 + 32))
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], float* out, size_t ld, int c0, int r, bool lo,
                                           bool hi, int lane) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int c = c0 + 8 * j + 2 * (lane & 3);
    if (lo) *reinterpret_cast<float2*>(out + (size_t)r * ld + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    if (hi) *reinterpret_cast<float2*>(out + (size_t)(r + 8) * ld + c) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <bool SCENES>
__global__ void __launch_bounds__(THREADS, 1)
    heads_bwd_points_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ ve,
                            const float* __restrict__ ve2, const float* __restrict__ g,
                            const unsigned char* __restrict__ stream, const float* __restrict__ small,
                            __nv_bfloat16* __restrict__ d_h, float* __restrict__ feature_out,
                            float* __restrict__ dfeat_out, float* __restrict__ D_out, float* __restrict__ hv_out,
                            float* __restrict__ dhv_out, float* __restrict__ d_ve, float* __restrict__ d_ve2,
                            int scenes, int nps, int n_sec, int dve) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + P_BARS, empty = full + 8 * PSTAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tps = (nps + TILE - 1) / TILE;  // tiles per scene
  const int ntiles = SCENES ? scenes * tps : tps;
  const int views = 1 + n_sec;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread replays the scene's stream into the ring, in the
    // order the consumers take it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const unsigned char* sb = stream;
      uint32_t it = 0;
      auto push = [&](int chunk) {
        const uint32_t s = it % PSTAGES;
        mbar_wait(empty + 8 * s, ((it / PSTAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, CHUNK);
        bulk_g2s(base + P_RING + s * CHUNK, sb + (size_t)chunk * CHUNK, CHUNK, full + 8 * s);
        ++it;
      };
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        if (SCENES) sb = stream + (size_t)(tile / tps) * STREAM_BYTES;
        for (int hf = 0; hf < 2; ++hf) {
          for (int c = 0; c < 8; ++c) push(C_W8 + 12 * hf + c);
          for (int c = 0; c < 4; ++c) push(C_W10F + 12 * hf + c);
        }
        for (int v = 0; v < views; ++v) {
          push(C_W10P);
          if (dve) push(C_W10PT);
        }
        for (int c = 0; c < 8; ++c) push(C_W10FT + c);
        for (int c = 0; c < 16; ++c) push(C_W8T + c);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = tid / 32, lane = tid % 32, bar_id = 1 + wg, tq = lane & 3;
  const int r = 16 * warp + (lane >> 2);  // this thread's rows r, r + 8 of the warpgroup's 64
  const uint32_t hs = base + wg * REGION;
  float* park = reinterpret_cast<float*>(smem + wg * REGION) + tid;  // slot i at park[128 i]
  Ring ring{base + P_RING, full, empty, 0};
  const int ve2_ld = VIEW_IN * (n_sec > 0 ? n_sec : 1);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int scene = SCENES ? tile / tps : 0;
    const int lrow0 = (tile - scene * tps) * TILE + wg * ROWS_WG;  // within the scene
    const int row = scene * nps + lrow0 + r;                       // global row of r
    const bool lo = lrow0 + r < nps, hi = lrow0 + r + 8 < nps;
    const float* sw = small + (SCENES ? (size_t)scene * SMALL_ELEMS : 0);

    // h's 64 rows as four 128-byte-swizzled K-slabs; rows past the scene's
    // end are zeros. The barrier orders this after the previous tile's
    // reads of the parked slots.
    bar_sync(bar_id, 128);
    for (int i = tid; i < ROWS_WG * 32; i += 128) {
      const int rr = i >> 5, c = i & 31;  // row, 16-byte piece of the 512-byte row
      uint4 v = make_uint4(0, 0, 0, 0);
      if (lrow0 + rr < nps)
        v = __ldg(reinterpret_cast<const uint4*>(h + (size_t)(scene * nps + lrow0 + rr) * WIDTH) + c);
      *reinterpret_cast<uint4*>(smem + wg * REGION + (c >> 3) * A_SLAB + rr * 128 + (((c & 7) ^ (rr & 7)) << 4)) = v;
    }
    fence_proxy_async();
    bar_sync(bar_id, 128);

    // feature = h W8^T + b8 a half of 128 columns at a time, then G +=
    // feature_half W10[:, half]^T with the half in registers
    float G[64];
    zero(G);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float f[64], t[64];
      zero(f);
#pragma unroll 1
      for (int c = 0; c < 8; ++c) {
        const uint32_t b = ring.acquire();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int k = 32 * c + 16 * s;
          const uint64_t da = desc_k<128>(hs + (k >> 6) * A_SLAB + (k & 63) * 2);
          wgmma_fence();
#pragma unroll
          for (int p = 2; p >= 0; --p) wgmma_n128_ss<0, 0>(t, da, desc_k<64>(b + p * PART + 32 * s), p < 2);
          wgmma_commit();
          wgmma_wait0();
          acc_fence(t);
          add_into(f, t);
        }
        ring.release(lane);
      }
      const float* b8 = sw + S_B8 + 128 * hf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b8 + 8 * j + 2 * tq));
        f[4 * j] = __fadd_rn(f[4 * j], bb.x);
        f[4 * j + 1] = __fadd_rn(f[4 * j + 1], bb.y);
        f[4 * j + 2] = __fadd_rn(f[4 * j + 2], bb.x);
        f[4 * j + 3] = __fadd_rn(f[4 * j + 3], bb.y);
      }
      store_rows(f, feature_out, WIDTH, 128 * hf, row, lo, hi, lane);
      static_for<4>([&](auto cc) {
        constexpr int c = decltype(cc)::value;
        const uint32_t b = ring.acquire();
        static_for<2>([&](auto ss) {
          constexpr int s = decltype(ss)::value;
          uint32_t a[3][4];
          split_acc<2 * c + s>(f, a);
          step_rs6(G, t, a, b + 32 * s);
        });
        ring.release(lane);
      });
    }
    // G waits in this thread's slots 0-63 (h's slabs are read: the barrier)
    bar_sync(bar_id, 128);
#pragma unroll
    for (int i = 0; i < 64; ++i) park[128 * i] = G[i];

    // D = sum_v d hv_v accumulates in the slots 64-127 while the views run
#pragma unroll
    for (int i = 0; i < 64; ++i) park[128 * (64 + i)] = 0.f;
    const float* w11 = sw + S_W11;
#pragma unroll 1
    for (int v = 0; v < views; ++v) {
      const float* pe = v == 0 ? ve : ve2 + (v - 1) * VIEW_IN;
      const size_t pe_ld = v == 0 ? VIEW_IN : ve2_ld;
      // hv = G + pe_v W10[:, 256:]^T, each k16 step into a fresh accumulator
      float hv[64], t[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) hv[i] = park[128 * i];
      float2 x[2][4];
      load_frag(x[0], pe, pe_ld, row, 2 * tq, lo, hi);
      load_frag(x[1], pe, pe_ld, row, 16 + 2 * tq, lo, hi);
      {
        const uint32_t b = ring.acquire();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t a[3][4];
          split_frag(x[s], a);
          step_rs6(hv, t, a, b + 32 * s);
        }
        ring.release(lane);
      }
      // d o_v of rows r and r + 8: g[1:5] for the primary view, only column
      // 3 (g[4 + v]) for a secondary one
      float dlo[4] = {0.f, 0.f, 0.f, 0.f}, dhi[4] = {0.f, 0.f, 0.f, 0.f};
      if (v == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dlo[k] = lo ? g[(size_t)row * NOUT + 1 + k] : 0.f;
          dhi[k] = hi ? g[(size_t)(row + 8) * NOUT + 1 + k] : 0.f;
        }
      } else {
        dlo[3] = lo ? g[(size_t)row * NOUT + 4 + v] : 0.f;
        dhi[3] = hi ? g[(size_t)(row + 8) * NOUT + 4 + v] : 0.f;
      }
      // hv = relu(. + b10); d hv = (d o W11) where hv > 0; D += d hv. From
      // here on the register array hv holds d hv.
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(sw + S_B10 + c));
        float act[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c + (e & 1);
          const float* dd = e < 2 ? dlo : dhi;
          const float pre = __fadd_rn(hv[4 * j + e], (e & 1) ? bb.y : bb.x);
          float dh = __fmul_rn(dd[0], w11[col]);
          dh = __fmaf_rn(dd[1], w11[HID + col], dh);
          dh = __fmaf_rn(dd[2], w11[2 * HID + col], dh);
          dh = __fmaf_rn(dd[3], w11[3 * HID + col], dh);
          act[e] = fmaxf(pre, 0.f);
          hv[4 * j + e] = pre > 0.f ? dh : 0.f;
          float* dslot = park + 128 * (64 + 4 * j + e);
          *dslot = __fadd_rn(*dslot, hv[4 * j + e]);
        }
        float* hv_row = hv_out + ((size_t)row * views + v) * HID + c;
        if (lo) *reinterpret_cast<float2*>(hv_row) = make_float2(act[0], act[1]);
        if (hi) *reinterpret_cast<float2*>(hv_row + 8 * views * HID) = make_float2(act[2], act[3]);
      }
      store_rows(hv, dhv_out + v * HID, (size_t)views * HID, 0, row, lo, hi, lane);
      // d pe_v = d hv_v W10[:, 256:] from registers: W10p^T's 4 K-blocks
      if (dve) {
        float dp[16], tp[16];
        zero(dp);
        const uint32_t b = ring.acquire();
        static_for<8>([&](auto cc) {
          constexpr int C = decltype(cc)::value;
          uint32_t a[3][4];
          split_acc<C>(hv, a);
          const uint32_t bc = b + (C >> 1) * 2048 + (C & 1) * 32;
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 6; ++q) wgmma_n32_rs(tp, a[pair6_a(q)], desc_k<64>(bc + pair6_b(q) * PART), q > 0);
          wgmma_commit();
          wgmma_wait0();
          acc_fence(tp);
          frag_fence(a);
          add_into(dp, tp);
        });
        ring.release(lane);
        if (v == 0) {
          if (d_ve) store_rows(dp, d_ve, VIEW_IN, 0, row, lo, hi, lane);
        } else if (d_ve2) {
          store_rows(dp, d_ve2, (size_t)VIEW_IN * n_sec, VIEW_IN * (v - 1), row, lo, hi, lane);
        }
      }
    }
    float D[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) D[i] = park[128 * (64 + i)];
    store_rows(D, D_out, HID, 0, row, lo, hi, lane);

    // d feature = D W10[:, :256] from registers, a half of 128 columns at a
    // time, parked in slots 64 hf .. 64 hf + 63 (G's are read)
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float df[64], t[64];
      zero(df);
      static_for<4>([&](auto cc) {
        constexpr int c = decltype(cc)::value;
        const uint32_t b = ring.acquire();
        static_for<2>([&](auto ss) {
          constexpr int s = decltype(ss)::value;
          uint32_t a[3][4];
          split_acc<2 * c + s>(D, a);
          step_rs6(df, t, a, b + 32 * s);
        });
        ring.release(lane);
      });
      store_rows(df, dfeat_out, WIDTH, 128 * hf, row, lo, hi, lane);
#pragma unroll
      for (int i = 0; i < 64; ++i) park[128 * (64 * hf + i)] = df[i];
    }

    // d h = d feature W8 + d sigma W9, to bf16, a half of 128 columns at a
    // time, d feature from the slots (k16 step C: slots 8C .. 8C + 7)
    const float dsig_lo = lo ? g[(size_t)row * NOUT] : 0.f, dsig_hi = hi ? g[(size_t)(row + 8) * NOUT] : 0.f;
#pragma unroll 1
    for (int hh = 0; hh < 2; ++hh) {
      float dh[64], t[64];
      zero(dh);
#pragma unroll 1
      for (int c = 0; c < 8; ++c) {
        const uint32_t b = ring.acquire();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float* sl = park + 128 * 8 * (2 * c + s);
          const float2 x[4] = {make_float2(sl[0], sl[128]), make_float2(sl[256], sl[384]),
                               make_float2(sl[512], sl[640]), make_float2(sl[768], sl[896])};
          uint32_t a[3][4];
          split_frag(x, a);
          step_rs6(dh, t, a, b + 32 * s);
        }
        ring.release(lane);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 128 * hh + 8 * j + 2 * tq;
        const float2 w9 = __ldg(reinterpret_cast<const float2*>(sw + S_W9 + c));
        const __nv_bfloat162 vlo = __floats2bfloat162_rn(__fadd_rn(dh[4 * j], __fmul_rn(dsig_lo, w9.x)),
                                                         __fadd_rn(dh[4 * j + 1], __fmul_rn(dsig_lo, w9.y)));
        const __nv_bfloat162 vhi = __floats2bfloat162_rn(__fadd_rn(dh[4 * j + 2], __fmul_rn(dsig_hi, w9.x)),
                                                         __fadd_rn(dh[4 * j + 3], __fmul_rn(dsig_hi, w9.y)));
        if (lo) *reinterpret_cast<__nv_bfloat162*>(d_h + (size_t)row * WIDTH + c) = vlo;
        if (hi) *reinterpret_cast<__nv_bfloat162*>(d_h + (size_t)(row + 8) * WIDTH + c) = vhi;
      }
    }
  }
}

// ------------------------------------------------------ weight-gradient kernel

constexpr int PROMOTE = 2;           // k16 steps per accumulator chain before its Fast2Sum
constexpr int WKB = 16 * PROMOTE;    // points per block: one chain
constexpr int KSPLIT = 8192;         // points of the reduction per CTA (per view for dW10's PE(dir) columns)
constexpr int KSPLIT_SMALL = 2048;   // ... for the small jobs
constexpr int WSTAGES = 3;
constexpr int WSTAGE = 32768;        // a block's rows of X (at 0) and Y (at Y_OFF), as bulk-copied
constexpr int Y_OFF = 16384;
constexpr int WSLAB = 49152;         // a block's split parts, MN-major: X's (at 0), then Y's (at SLAB_Y)
constexpr int SLAB_Y = 24576;
constexpr int W_STAGES_AT = 2 * WSLAB;
constexpr int W_SUMS_AT = W_STAGES_AT + WSTAGES * WSTAGE;  // column sums, 4 doubles per thread
constexpr int W_BARS_AT = W_SUMS_AT + 256 * 4 * 8;
constexpr int SMEM_W = W_BARS_AT + 2 * WSTAGES * 8 + 1024;
constexpr int SMALL_SUMS = 29;       // doubles per thread of a small job: dW9 8, dW11 16, b9 1, b11 4
static_assert(SMEM_W <= 232448 && 256 * SMALL_SUMS * 8 <= 2 * WSLAB && PROMOTE == 2, "budget");

// the jobs, in grid order (the small jobs first: they take their SM longest)
enum { J_SMALL = 0, J_W10F = 1, J_W8 = 2, J_W10P = 3, NJOBS = 4 };
// tile shapes (X columns MT x Y columns NT) and whether Y is bf16
__host__ __device__ constexpr int job_mt(int j) { return j == J_W8 ? 64 : 128; }
__host__ __device__ constexpr int job_nt(int j) { return j == J_W8 ? 256 : (j == J_W10F ? 128 : 32); }
__host__ __device__ constexpr int job_tiles(int j) { return j == J_W8 ? 4 : (j == J_W10F ? 2 : 1); }
// doubles of a CTA's share: the tile's entries, then X's column sums (the small jobs: dW11, dW9, b11, b9)
__host__ __device__ constexpr int job_pw(int j) {
  return j == J_SMALL ? 4 * HID + WIDTH + 4 + 1 : job_mt(j) * job_nt(j) + (j == J_W10P ? 0 : job_mt(j));
}

struct WJob {
  int tiles, splits;     // per scene: output tiles, CTAs per tile
  int cta0;              // the job's first CTA
  long long part0, ent0;  // its first share (doubles) and first share entry over all scenes' tiles
};
struct WArgs {
  const __nv_bfloat16* h;
  const float *g, *ve, *ve2, *feature, *dfeat, *D, *hv, *dhv;
  float *w8, *w9, *w10f, *w10p, *w11, *b8, *b9, *b10, *b11;
  double* partials;
  int scenes, nps, n_sec, nsplit;
  WJob job[NJOBS];
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The tensor maps of the big jobs' operands, over the rows of every scene
// (a box: WKB rows of a job's columns; rows past the tensor read as zeros):
// d feature and h (dW8's X and Y), D and the feature (dW10f's), d hv (3-D:
// columns, views, points) and PE(dir) from ve or ve2 (3-D: columns,
// secondary views, points) (dW10p's).
struct WMaps {
  CUtensorMap dfeat, h, D, feature, dhv, ve, ve2;
};

// The grids: per job, scenes x tiles x splits CTAs (a CTA per share), and
// the second launch's thread per entry of a tile's share.
WArgs make_wargs(int scenes, int nps, int n_sec) {
  WArgs a{};
  a.scenes = scenes, a.nps = nps, a.n_sec = n_sec;
  a.nsplit = nps > 0 ? cdiv(nps, KSPLIT) : 1;
  int cta = 0;
  long long part = 0, ent = 0;
  for (int j = 0; j < NJOBS; ++j) {
    WJob& jb = a.job[j];
    jb.tiles = job_tiles(j);
    jb.splits = j == J_SMALL ? (nps > 0 ? cdiv(nps, KSPLIT_SMALL) : 1) : (j == J_W10P ? (1 + n_sec) : 1) * a.nsplit;
    jb.cta0 = cta, jb.part0 = part, jb.ent0 = ent;
    cta += scenes * jb.tiles * jb.splits;
    part += (long long)scenes * jb.tiles * jb.splits * job_pw(j);
    ent += (long long)scenes * jb.tiles * job_pw(j);
  }
  return a;
}

int weight_ctas(const WArgs& a) {
  const WJob& j = a.job[NJOBS - 1];
  return j.cta0 + a.scenes * j.tiles * j.splits;
}

long long share_entries(const WArgs& a) {
  const WJob& j = a.job[NJOBS - 1];
  return j.ent0 + (long long)a.scenes * j.tiles * job_pw(NJOBS - 1);
}

// Fast2Sum: tot + acc = new tot + new acc, exactly where |tot| >= |acc|
// (the total is larger than a block's sum but for the first blocks of a
// share) or where the sum is exact; else off by less than half an ulp of
// the block's sum
template <int N>
__device__ __forceinline__ void promote(float (&tot)[N], float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float s = __fadd_rn(tot[i], acc[i]);
    acc[i] = __fsub_rn(acc[i], __fsub_rn(s, tot[i]));
    tot[i] = s;
  }
}

// byte offset of element (k, c) in an MN-major slab of one part: atoms of
// SW / 2 columns, WKB rows of SW bytes each, atoms WKB * SW bytes apart
template <int SW>
__device__ __forceinline__ int mn_off(int k, int c) {
  if constexpr (SW == 128)
    return (c >> 6) * (WKB * 128) + k * 128 + ((((c & 63) >> 3) ^ (k & 7)) << 4) + (c & 7) * 2;
  else
    return k * 64 + ((((c & 31) >> 3) ^ ((k >> 1) & 3)) << 4) + (c & 7) * 2;
}

// One CTA's share of a big job: the tile's X^T Y over KSPLIT points (of one
// view for J_W10P), consumer side (256 threads).
template <int JOB, bool SCENES>
__device__ __forceinline__ void big_share(const WArgs& a, const WJob& job, int local, unsigned char* smem,
                                          uint32_t base, int tid) {
  constexpr int MT = job_mt(JOB), NT = job_nt(JOB), NW = NT == 256 ? 128 : NT, ACC = NW / 2;
  constexpr bool YB = JOB == J_W8;
  constexpr int YSW = NT == 32 ? 64 : 128;
  constexpr int APART = MT * WKB * 2, BPART = NT * WKB * 2;
  const uint32_t full = base + W_BARS_AT, empty = full + 8 * WSTAGES;
  const int split = local % job.splits, tall = local / job.splits;
  const int tile = tall % job.tiles, views = 1 + a.n_sec;
  const int ks = JOB == J_W10P ? split % a.nsplit : split;
  const int kb = ks * KSPLIT, ke = min(a.nps, kb + KSPLIT), nblk = ke > kb ? cdiv(ke - kb, WKB) : 0;
  const bool sums = JOB == J_W8 || (JOB == J_W10F && tile == 0);
  const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;

  float acc[ACC], tot[ACC];
  zero(acc);
  zero(tot);
  // X's column sums over this thread's rows: columns 4 (tid % (MT / 4)) ..
  double cs[4] = {0.0, 0.0, 0.0, 0.0};
  for (int blk = 0; blk < nblk; ++blk) {
    const int s = blk % WSTAGES, rows = min(WKB, ke - (kb + blk * WKB));
    mbar_wait(full + 8 * s, (blk / WSTAGES) & 1);
    const unsigned char* st = smem + W_STAGES_AT + s * WSTAGE;
    unsigned char* slab = smem + (blk & 1) * WSLAB;
    // X: MT columns, split once, written in the orientation they came in
#pragma unroll
    for (int i = 0; i < MT / 32; ++i) {
      const int u = tid + 256 * i, c4 = u % (MT / 4), k = u / (MT / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < rows) x = *reinterpret_cast<const float4*>(st + (k * MT + 4 * c4) * 4);
      uint32_t lo[3], hi[3];
      split_pair(x.x, x.y, lo[0], lo[1], lo[2]);
      split_pair(x.z, x.w, hi[0], hi[1], hi[2]);
      const int off = mn_off<128>(k, 4 * c4);
#pragma unroll
      for (int p = 0; p < 3; ++p) *reinterpret_cast<uint2*>(slab + p * APART + off) = make_uint2(lo[p], hi[p]);
      if (sums) {
        cs[0] += (double)x.x;
        cs[1] += (double)x.y;
        cs[2] += (double)x.z;
        cs[3] += (double)x.w;
      }
    }
    // Y: NT columns, split once (bf16 h: copied)
    if constexpr (YB) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = tid + 256 * i, c8 = u & 31, k = u >> 5;
        uint4 y = make_uint4(0, 0, 0, 0);
        if (k < rows) y = *reinterpret_cast<const uint4*>(st + Y_OFF + (k * NT + 8 * c8) * 2);
        *reinterpret_cast<uint4*>(slab + SLAB_Y + mn_off<128>(k, 8 * c8)) = y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NT / 32; ++i) {
        const int u = tid + 256 * i, c4 = u % (NT / 4), k = u / (NT / 4);
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < rows) y = *reinterpret_cast<const float4*>(st + Y_OFF + (k * NT + 4 * c4) * 4);
        uint32_t lo[3], hi[3];
        split_pair(y.x, y.y, lo[0], lo[1], lo[2]);
        split_pair(y.z, y.w, hi[0], hi[1], hi[2]);
        const int off = mn_off<YSW>(k, 4 * c4);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint2*>(slab + SLAB_Y + p * BPART + off) = make_uint2(lo[p], hi[p]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the stage is read
    fence_proxy_async();
    if (blk > 0) {  // the previous block's chain, into the total
      wgmma_wait0();
      acc_fence(acc);
      promote(tot, acc);
    }
    bar_sync(1, 256);  // both warpgroups' parts written, both previous chains done
    // the chain: A = the warpgroup's 64 X columns, B its NW Y columns; the
    // part products of both k16 steps by size (i + j = 2, 1, then 0)
    const uint32_t sa = base + (blk & 1) * WSLAB + (MT == 128 ? w * WKB * 128 : 0);
    const uint32_t sb = base + (blk & 1) * WSLAB + SLAB_Y + (NT == 256 ? 2 * w * WKB * 128 : 0);
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int cls = 2; cls >= 0; --cls)
#pragma unroll
      for (int st16 = 0; st16 < PROMOTE; ++st16)
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const int i = pair6_a(q), j = pair6_b(q);
          if (i + j != cls || (YB && j > 0)) continue;
          const uint64_t da = desc_mn<128>(sa + i * APART + st16 * 2048, WKB * 128, 1024);
          if constexpr (NT == 32) {
            wgmma_n32_ss<1, 1>(acc, da, desc_mn<64>(sb + j * BPART + st16 * 1024, WKB * 64, 512), 1);
          } else {
            wgmma_n128_ss<1, 1>(acc, da, desc_mn<128>(sb + j * BPART + st16 * 2048, WKB * 128, 1024), 1);
          }
        }
    wgmma_commit();
  }
  if (nblk > 0) {
    wgmma_wait0();
    acc_fence(acc);
    promote(tot, acc);
  }

  // this CTA's share, in f64 (the total + what the accumulator holds)
  double* part = a.partials + job.part0 + ((size_t)tall * job.splits + split) * job_pw(JOB);
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int jj = 0; jj < ACC / 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = (MT == 128 ? 64 * w : 0) + 16 * warp + gq + 8 * (e >> 1);
      const int n = (NT == 256 ? 128 * w : 0) + 8 * jj + 2 * tq + (e & 1);
      part[m * NT + n] = (double)tot[4 * jj + e] + (double)acc[4 * jj + e];
    }
  if (sums) {
    // the threads of a column quad (tid % (MT / 4)) in a fixed order
    double* sm = reinterpret_cast<double*>(smem + W_SUMS_AT);
#pragma unroll
    for (int c = 0; c < 4; ++c) sm[4 * tid + c] = cs[c];
    bar_sync(1, 256);
    if (tid < MT / 4) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        double v = 0.0;
        for (int gi = 0; gi < 256 / (MT / 4); ++gi) v += sm[4 * (tid + gi * (MT / 4)) + c];
        part[MT * NT + 4 * tid + c] = v;
      }
    }
  }
}

// The small jobs' share of KSPLIT_SMALL points, in f64 on the CUDA cores:
// warp wq takes points kb + wq, kb + wq + 8, ...; lane l the columns 8l ..
// 8l + 7 of h (dW9) and 4l .. 4l + 3 of hv_v (dW11, each of d o's 4 rows).
template <bool SCENES>
__device__ __forceinline__ void small_share(const WArgs& a, const WJob& job, int local, unsigned char* smem, int tid) {
  const int split = local % job.splits, tall = local / job.splits;
  const int scene = SCENES ? tall / job.tiles : 0, views = 1 + a.n_sec;
  const int kb = split * KSPLIT_SMALL, ke = min(a.nps, kb + KSPLIT_SMALL);
  const int wq = tid / 32, lane = tid % 32;
  double s[SMALL_SUMS];
#pragma unroll
  for (int i = 0; i < SMALL_SUMS; ++i) s[i] = 0.0;  // dW9 [0, 8), dW11 [8, 24) (row j: 8 + 4j), b9 24, b11 25..28
  const size_t r0 = (size_t)scene * a.nps;
  constexpr int U = 2;  // points per warp in flight: every load of U points first
  for (int p0 = kb + wq; p0 < ke; p0 += 8 * U) {
    float4 g0[U], g1[U], x[U][1 + MAX_SEC];
    uint4 hr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t row = r0 + min(p0 + 8 * u, ke - 1);
      g0[u] = __ldg(reinterpret_cast<const float4*>(a.g + row * NOUT));
      g1[u] = __ldg(reinterpret_cast<const float4*>(a.g + row * NOUT) + 1);
      hr[u] = __ldg(reinterpret_cast<const uint4*>(a.h + row * WIDTH) + lane);
#pragma unroll
      for (int v = 0; v <= MAX_SEC; ++v)
        if (v < views) x[u][v] = __ldg(reinterpret_cast<const float4*>(a.hv + (row * views + v) * HID) + lane);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p0 + 8 * u >= ke) break;
      const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&hr[u]);
      const double dsig = g0[u].x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 hf = __bfloat1622float2(hp[e]);
        s[2 * e] = fma(dsig, (double)hf.x, s[2 * e]);
        s[2 * e + 1] = fma(dsig, (double)hf.y, s[2 * e + 1]);
      }
      s[24] += dsig;
#pragma unroll
      for (int v = 0; v <= MAX_SEC; ++v) {
        if (v >= views) break;
        const double xe[4] = {x[u][v].x, x[u][v].y, x[u][v].z, x[u][v].w};
        if (v == 0) {
          const double d[4] = {g0[u].y, g0[u].z, g0[u].w, g1[u].x};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[8 + 4 * jj + e] = fma(d[jj], xe[e], s[8 + 4 * jj + e]);
            s[25 + jj] += d[jj];
          }
        } else {
          const double d3 = v == 1 ? g1[u].y : (v == 2 ? g1[u].z : g1[u].w);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[20 + e] = fma(d3, xe[e], s[20 + e]);
          s[28] += d3;
        }
      }
    }
  }
  // over the 8 warps in a fixed order
  double* sm = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int i = 0; i < SMALL_SUMS; ++i) sm[tid * SMALL_SUMS + i] = s[i];
  bar_sync(1, 256);
  if (tid < 32) {
    double* part = a.partials + job.part0 + ((size_t)tall * job.splits + split) * job_pw(J_SMALL);
    for (int i = 0; i < SMALL_SUMS; ++i) {
      double v = 0.0;
      for (int k = 0; k < 8; ++k) v += sm[(32 * k + tid) * SMALL_SUMS + i];
      if (i < 8) part[4 * HID + 8 * tid + i] = v;                                  // dW9
      else if (i < 24) part[((i - 8) >> 2) * HID + 4 * tid + ((i - 8) & 3)] = v;  // dW11
      else if (tid == 0) part[4 * HID + WIDTH + (i == 24 ? 4 : i - 25)] = v;        // b9, b11
    }
  }
}

// The second launch: a thread per entry of a tile's shares, their sum in a
// fixed order (four running sums over the shares, share sp in sum sp % 4
// and the last ones in the first, added as a tree), written where the
// module's gradient holds it.
__global__ void __launch_bounds__(256) heads_bwd_reduce_kernel(const WArgs a) {
  const long long gi = (long long)blockIdx.x * 256 + threadIdx.x;
  int jb = 0;
  WJob job = a.job[0];
#pragma unroll
  for (int i = 1; i < NJOBS; ++i)
    if (gi >= a.job[i].ent0) jb = i, job = a.job[i];
  const int pw = job_pw(jb);
  const long long local = gi - job.ent0;
  if (local >= (long long)a.scenes * job.tiles * pw) return;
  const int tall = (int)(local / pw), i = (int)(local % pw);
  const int scene = tall / job.tiles, tile = tall % job.tiles;
  const double* first = a.partials + job.part0 + (size_t)tall * job.splits * pw + i;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  int sp = 0;
  for (; sp + 4 <= job.splits; sp += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += __ldg(first + (size_t)(sp + u) * pw);
  for (; sp < job.splits; ++sp) acc[0] += __ldg(first + (size_t)sp * pw);
  const float v = (float)((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (jb == J_W8) {
    if (i < 64 * WIDTH)
      a.w8[(size_t)scene * WIDTH * WIDTH + (64 * tile + i / WIDTH) * WIDTH + i % WIDTH] = v;
    else
      a.b8[(size_t)scene * WIDTH + 64 * tile + i - 64 * WIDTH] = v;
  } else if (jb == J_W10F) {
    if (i < HID * 128)
      a.w10f[(size_t)scene * HID * WIDTH + (i / 128) * WIDTH + 128 * tile + i % 128] = v;
    else if (tile == 0)
      a.b10[(size_t)scene * HID + i - HID * 128] = v;
  } else if (jb == J_W10P) {
    a.w10p[(size_t)scene * HID * VIEW_IN + i] = v;
  } else {
    if (i < 4 * HID) a.w11[(size_t)scene * 4 * HID + i] = v;
    else if (i < 4 * HID + WIDTH) a.w9[(size_t)scene * WIDTH + i - 4 * HID] = v;
    else if (i < 4 * HID + WIDTH + 4) a.b11[(size_t)scene * 4 + i - 4 * HID - WIDTH] = v;
    else a.b9[scene] = v;
  }
}

// the producer thread of a big job's share: each block's WKB rows of X and
// Y, a tensor-map box each, into stage blk % WSTAGES
template <int JOB>
__device__ __forceinline__ void produce(const WArgs& a, const WMaps& maps, const WJob& job, int local,
                                        uint32_t base) {
  constexpr int XBYTES = WKB * job_mt(JOB) * 4, YBYTES = WKB * job_nt(JOB) * (JOB == J_W8 ? 2 : 4);
  const uint32_t full = base + W_BARS_AT, empty = full + 8 * WSTAGES;
  const int split = local % job.splits, tall = local / job.splits;
  const int tile = tall % job.tiles, scene = tall / job.tiles;
  const int v = JOB == J_W10P ? split / a.nsplit : 0, ks = JOB == J_W10P ? split % a.nsplit : split;
  const int kb = ks * KSPLIT, ke = min(a.nps, kb + KSPLIT), nblk = ke > kb ? cdiv(ke - kb, WKB) : 0;
  const int row0 = scene * a.nps + kb;
  for (int blk = 0; blk < nblk; ++blk) {
    const int s = blk % WSTAGES, row = row0 + blk * WKB;
    const uint32_t st = base + W_STAGES_AT + s * WSTAGE, bar = full + 8 * s;
    mbar_wait(empty + 8 * s, ((blk / WSTAGES) & 1) ^ 1);
    mbar_expect_tx(bar, XBYTES + YBYTES);
    if constexpr (JOB == J_W8) {
      tma_2d(st, &maps.dfeat, 64 * tile, row, bar);
      tma_2d(st + Y_OFF, &maps.h, 0, row, bar);
    } else if constexpr (JOB == J_W10F) {
      tma_2d(st, &maps.D, 0, row, bar);
      tma_2d(st + Y_OFF, &maps.feature, 128 * tile, row, bar);
    } else {
      tma_3d(st, &maps.dhv, 0, v, row, bar);
      if (v == 0)
        tma_2d(st + Y_OFF, &maps.ve, 0, row, bar);
      else
        tma_3d(st + Y_OFF, &maps.ve2, 0, v - 1, row, bar);
    }
  }
}

template <bool SCENES>
__global__ void __launch_bounds__(THREADS, 1)
    heads_bwd_weights_kernel(const WArgs a, const __grid_constant__ WMaps maps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  if (threadIdx.x == 0) {
    const uint32_t full = base + W_BARS_AT, empty = full + 8 * WSTAGES;
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this CTA's job: the last whose first CTA is at or before it (each read
  // with a constant index, so the table stays in parameter space)
  int jb = 0;
  WJob job = a.job[0];
#pragma unroll
  for (int i = 1; i < NJOBS; ++i)
    if ((int)blockIdx.x >= a.job[i].cta0) jb = i, job = a.job[i];
  const int local = blockIdx.x - job.cta0;
  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      if (jb == J_W10F) produce<J_W10F>(a, maps, job, local, base);
      else if (jb == J_W8) produce<J_W8>(a, maps, job, local, base);
      else if (jb == J_W10P) produce<J_W10P>(a, maps, job, local, base);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x;
  if (jb == J_SMALL) small_share<SCENES>(a, job, local, smem, tid);
  else if (jb == J_W10F) big_share<J_W10F, SCENES>(a, job, local, smem, base, tid);
  else if (jb == J_W8) big_share<J_W8, SCENES>(a, job, local, smem, base, tid);
  else big_share<J_W10P, SCENES>(a, job, local, smem, base, tid);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, through the runtime (no link to libcuda)
EncodeTiled encode_tiled() {
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

// A row-major tensor's map: `rank` dims innermost first (elements), the
// byte strides of dims 1.. and a box of WKB rows of `box0` columns (one
// step of each middle dim); no swizzle, zeros past the tensor.
bool encode(CUtensorMap* map, const void* ptr, bool bf16, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
            cuuint32_t box0) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t box[3] = {box0, rank == 3 ? 1u : (cuuint32_t)WKB, (cuuint32_t)WKB}, one[3] = {1, 1, 1};
  return fn && fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                  const_cast<void*>(ptr), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool shape_ok(int scenes, int nps, int n_sec) {
  return n_sec >= 0 && n_sec <= MAX_SEC && scenes >= 1 && nps >= 0 &&
         (long long)scenes * nps * (1 + n_sec) <= 0x7fffffffLL;
}

}  // namespace

// which = 0: the per-point kernel's dynamic shared memory per CTA; 1: the
// weight kernel's
extern "C" int vipnerf_heads_bwd_smem_bytes(int which) { return which == 0 ? SMEM_P : SMEM_W; }

// The weight gradients' scratch and grids: what = 1, the doubles of the
// shares; 2, the first launch's CTAs; 3, the entries of a tile's share over
// every tile (the second launch's threads); 0, none (the first design's
// counters)
extern "C" long long vipnerf_heads_bwd_scratch(int scenes, int nps, int n_sec, int what) {
  const WArgs a = make_wargs(scenes, nps, n_sec);
  const WJob& last = a.job[NJOBS - 1];
  if (what == 1) return last.part0 + (long long)scenes * last.tiles * last.splits * job_pw(NJOBS - 1);
  return what == 2 ? weight_ctas(a) : (what == 3 ? share_entries(a) : 0);
}

// h (N, 256) bf16; ve, ve2, g f32 (N = scenes * nps rows); stream and small
// each scene's heads_bwd_stream and small weights; outputs: d_h (N, 256)
// bf16, feature and d feature (N, 256), D (N, 128), hv and d hv (N, 1 +
// n_sec, 128), and with dve d ve (N, 32) and d ve2 (N, 32 n_sec), each may
// be null
extern "C" int vipnerf_heads_bwd_points(const void* h, const void* ve, const void* ve2, const void* g,
                                        const void* stream, const void* small, void* d_h, void* feature, void* dfeat,
                                        void* D, void* hv, void* dhv, void* d_ve, void* d_ve2, int scenes, int nps,
                                        int n_sec, int dve, void* stream_) {
  if (!shape_ok(scenes, nps, n_sec)) return (int)cudaErrorInvalidValue;
  auto kernel = scenes > 1 ? heads_bwd_points_kernel<true> : heads_bwd_points_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_P);
  if (e != cudaSuccess) return (int)e;
  if (nps == 0) return 0;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  const int ntiles = scenes * ((nps + TILE - 1) / TILE);
  kernel<<<ntiles < sms ? ntiles : sms, THREADS, SMEM_P, (cudaStream_t)stream_>>>(
      (const __nv_bfloat16*)h, (const float*)ve, (const float*)ve2, (const float*)g, (const unsigned char*)stream,
      (const float*)small, (__nv_bfloat16*)d_h, (float*)feature, (float*)dfeat, (float*)D, (float*)hv, (float*)dhv,
      (float*)d_ve, (float*)d_ve2, scenes, nps, n_sec, dve);
  return (int)cudaGetLastError();
}

// The weight gradients from the inputs h, g, ve, ve2 of the per-point
// kernel and its outputs, per scene: w8 (256, 256), w9 (1, 256), w10f (128,
// 256), w10p (128, 32) (columns 0-26 real), w11 (4, 128), b8 (256), b9 (1),
// b10 (128), b11 (4); partials sized by vipnerf_heads_bwd_scratch. Two
// launches: the shares, then their sums.
extern "C" int vipnerf_heads_bwd_weights(const void* h, const void* g, const void* ve, const void* ve2,
                                         const void* feature, const void* dfeat, const void* D, const void* hv,
                                         const void* dhv, void* w8, void* w9, void* w10f, void* w10p, void* w11,
                                         void* b8, void* b9, void* b10, void* b11, void* partials, int scenes,
                                         int nps, int n_sec, void* stream) {
  if (!shape_ok(scenes, nps, n_sec)) return (int)cudaErrorInvalidValue;
  WArgs a = make_wargs(scenes, nps, n_sec);
  a.h = (const __nv_bfloat16*)h, a.g = (const float*)g, a.ve = (const float*)ve, a.ve2 = (const float*)ve2;
  a.feature = (const float*)feature, a.dfeat = (const float*)dfeat, a.D = (const float*)D;
  a.hv = (const float*)hv, a.dhv = (const float*)dhv;
  a.w8 = (float*)w8, a.w9 = (float*)w9, a.w10f = (float*)w10f, a.w10p = (float*)w10p, a.w11 = (float*)w11;
  a.b8 = (float*)b8, a.b9 = (float*)b9, a.b10 = (float*)b10, a.b11 = (float*)b11;
  a.partials = (double*)partials;
  // every scene's rows at once (at least one, for a map of no points)
  const cuuint64_t n = scenes * nps > 0 ? (cuuint64_t)scenes * nps : 1, views = 1 + n_sec, sec = n_sec > 0 ? n_sec : 1;
  const cuuint64_t d_w[2] = {WIDTH, n}, s_w32[1] = {WIDTH * 4}, s_w16[1] = {WIDTH * 2};
  const cuuint64_t d_hid[2] = {HID, n}, s_hid[1] = {HID * 4};
  const cuuint64_t d_dhv[3] = {HID, views, n}, s_dhv[2] = {HID * 4, views * HID * 4};
  const cuuint64_t d_ve[2] = {VIEW_IN, n}, s_ve[1] = {VIEW_IN * 4};
  const cuuint64_t d_ve2[3] = {VIEW_IN, sec, n}, s_ve2[2] = {VIEW_IN * 4, sec * VIEW_IN * 4};
  WMaps maps;
  if (!(encode(&maps.dfeat, dfeat, false, 2, d_w, s_w32, 64) && encode(&maps.h, h, true, 2, d_w, s_w16, WIDTH) &&
        encode(&maps.D, D, false, 2, d_hid, s_hid, HID) && encode(&maps.feature, feature, false, 2, d_w, s_w32, 128) &&
        encode(&maps.dhv, dhv, false, 3, d_dhv, s_dhv, HID) && encode(&maps.ve, ve, false, 2, d_ve, s_ve, VIEW_IN) &&
        encode(&maps.ve2, ve2, false, 3, d_ve2, s_ve2, VIEW_IN)))
    return (int)cudaErrorInvalidValue;
  auto kernel = scenes > 1 ? heads_bwd_weights_kernel<true> : heads_bwd_weights_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_W);
  if (e != cudaSuccess) return (int)e;
  kernel<<<weight_ctas(a), THREADS, SMEM_W, (cudaStream_t)stream>>>(a, maps);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  heads_bwd_reduce_kernel<<<(unsigned)((share_entries(a) + 255) / 256), 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
