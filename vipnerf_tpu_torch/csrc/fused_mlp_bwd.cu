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
// Arithmetic: every f32 product runs on the bf16 tensor cores
// (mma.sync.m16n8k16, f32 accumulation) as products of split operands, as
// the forward heads kernel does (csrc/fused_mlp.cu): an f32 value is three
// bf16 parts that sum to it exactly (each the round to nearest even of what
// the parts before it leave). A bf16 operand (h) times an f32 one takes the
// three products h p_j; two f32 operands take the six a_i b_j with
// i + j <= 2 (the three dropped are below 2^-24 of the product). The small
// products with 4 or 1 terms (d o_v W11, d sigma W9) run in f32 on the CUDA
// cores; hv's mask and the bias adds too.
//
// The tensor cores round each k16 step's sum toward zero (PERF.md section 6,
// measured for wgmma in the forward heads; mma.sync is assumed to do the
// same). A long chain into one accumulator then shrinks the sum: over the
// point axis (786,432 points in a training step's fine launch, ~49k k16
// steps) by ~3e-3. So no accumulator carries a long chain:
// - per-point kernel: each k16 step's part products go into a fresh
//   accumulator, smallest parts first, and the step's sum is added to the
//   running f32 total with an ordinary (round-to-nearest) add;
// - weight-gradient kernel: two accumulators per tile, one for the (0, 0)
//   part products and one for the smaller ones (so that no small product
//   truncates at the scale of the full sum), run PROMOTE = 4 k16 steps (64
//   points), then their sum joins a Kahan-compensated f32 total and they
//   restart;
//   each CTA takes KSPLIT = 8192 points of the reduction and writes its
//   total in f64; the last CTA of an output tile to finish (an integer
//   atomic counts them) sums the partials in f64 in a fixed order (four
//   running sums over the splits, then a fixed tree), so the result does
//   not depend on the CTAs' timing (no float atomics).
// The interval is sized by the numpy emulation in
// tests/test_torch_heads_backward.py, which shows the same arithmetic
// without promotion missing the tolerances over 786,432 points.
//
// What bounds it: tensor-core operations, ~1.58M bf16 products per point at
// n_sec 2 (per-point kernel ~1.06M, weights ~0.52M), against ~5.6 KB per
// point of intermediates written once and read once (PERF.md section 6).
// This is a first, simple design: the per-point kernel stages weight chunks
// through shared memory with cp.async and issues mma.sync from registers;
// the intermediates (feature, d feature, D, hv_v, d hv_v) go through device
// memory to the weight-gradient kernel, which reads the inputs h, PE(dir)
// and g where it needs them.
//
// Per-point kernel (heads_bwd_points_kernel): a CTA of 8 warps takes 128
// points, a warp 16 of them through the whole chain, so an accumulator's
// fragment is, register pair for register pair, the A fragment of the next
// product (the f32 value split into its parts in registers). All warps
// consume the same sequence of weight chunks (3 parts x 128 rows x 32 K of a
// K-contiguous image, double-buffered by cp.async). To stay within the
// registers, a product whose A operand is no longer in registers (G's
// feature, d PE(dir)'s d hv_v, d h's d feature) reads it back from the rows
// this thread stored, and G = feature W10f^T waits per thread in shared
// memory while the views run.
//
// Weight-gradient kernel (heads_bwd_weights_kernel): X^T Y products over the
// point axis for five jobs (dW8: d feature x h; dW10f: D x feature; dW10p:
// d hv x PE(dir) over points and views; dW11: d o x hv over points and
// views, d o read from g; dW9: d sigma x h), each a grid
// of 64 x 64 output tiles x splits of KSPLIT rows, with the column sums of
// X (the biases) beside. A CTA of 4 warps loads 32 rows of X and Y per
// step, splits them into bf16 parts transposed into shared memory (point
// axis contiguous, the MMA's K), and each warp runs a 32 x 32 block.

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

// One scene's image of split weights (kernels/fused_mlp.py heads_bwd_pack):
// each matrix (rows, cols) K-contiguous as its three bf16 parts in turn.
constexpr int M_W8 = 0;                             // (256, 256): feature = h W8^T
constexpr int M_W10F = M_W8 + 3 * WIDTH * WIDTH;    // (128, 256): W10's feature columns
constexpr int M_W10P = M_W10F + 3 * HID * WIDTH;    // (128, 32): W10's PE(dir) columns
constexpr int M_W10FT = M_W10P + 3 * HID * VIEW_IN;  // (256, 128)
constexpr int M_W8T = M_W10FT + 3 * WIDTH * HID;    // (256, 256)
constexpr int M_W10PT = M_W8T + 3 * WIDTH * WIDTH;  // (32, 128)
constexpr int IMG_ELEMS = M_W10PT + 3 * VIEW_IN * HID;
// one scene's f32 small weights: b8, b10, W9, W11 (4 rows)
constexpr int S_B8 = 0, S_B10 = WIDTH, S_W9 = WIDTH + HID, S_W11 = 2 * WIDTH + HID;
constexpr int SMALL_ELEMS = S_W11 + 4 * HID;
static_assert(IMG_ELEMS == 614400 && SMALL_ELEMS == 1152, "heads_bwd_pack");

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; r[i] holds matrix i's row (lane / 4), columns
// 2 (lane % 4) and + 1: an MMA fragment register
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d = a b (+ c): one m16n8k16 bf16 product, f32 accumulation. Fragments of
// lane l (g = l / 4, t = l % 4): a[0] rows g, K 2t..2t+1; a[1] row g + 8;
// a[2], a[3] the same rows at K + 8; b[0] K 2t..2t+1 of column g, b[1] K + 8;
// d[0..1] row g, columns 2t..2t+1, d[2..3] row g + 8.
__device__ __forceinline__ void mma_first(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = part 0 + part 1 + part 2 exactly; a pair of floats gives a bf16 pair
// per part (x in the low half), as the forward heads kernel splits
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

// the parts' A fragments of a k16 step from four float pairs (rows g and
// g + 8, K 2t and 2t + 8)
__device__ __forceinline__ void split_frag(const float2 (&v)[4], uint32_t (&a)[3][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) split_pair(v[k].x, v[k].y, a[0][k], a[1][k], a[2][k]);
}

// ------------------------------------------------------ per-point kernel

constexpr int WARPS_A = 8;
constexpr int THREADS_A = 32 * WARPS_A;
constexpr int TILE_A = 16 * WARPS_A;  // points per CTA
constexpr int H_PITCH = WIDTH + 8;    // bf16 per h row in shared memory (conflict-free fragments)
// a warp's shared memory: its h rows, then (thread-private slots) G and D
constexpr int WARP_SMEM = 2 * 64 * 32 * 4;
constexpr int CK = 32;           // K of a weight chunk
constexpr int C_PITCH = CK + 8;  // bf16 per chunk row (conflict-free fragments)
constexpr int C_ROWS = 128;      // rows per chunk (32 for W10p^T)
constexpr int CHUNK_ELEMS = 3 * C_ROWS * C_PITCH;
constexpr int SMEM_A = WARPS_A * WARP_SMEM + 2 * CHUNK_ELEMS * 2;
constexpr int JG = 8;  // n8 tiles whose product chains interleave
static_assert(WARP_SMEM >= 16 * H_PITCH * 2 && SMEM_A <= 232448 && WARP_SMEM % 16 == 0, "shared memory");

// The i-th weight chunk of a tile: rows [n0, n0 + nc) and columns
// [k0, k0 + 32) of an image matrix (offset, row length k, rows r), its three
// parts. The sequence: the feature (two halves of 8 chunks), G (8); per view
// W10p (1); with d PE(dir), per view W10p^T (4); d feature (two halves of
// 4); d h (two halves of 8).
struct Chunk {
  int mat, k, r, n0, nc, k0;
};
__device__ __forceinline__ Chunk chunk_of(int i, int views, int dve) {
  if (i < 16) return {M_W8, WIDTH, WIDTH, 128 * (i / 8), 128, CK * (i % 8)};
  i -= 16;
  if (i < 8) return {M_W10F, WIDTH, HID, 0, 128, CK * i};
  i -= 8;
  if (i < views) return {M_W10P, VIEW_IN, HID, 0, 128, 0};
  i -= views;
  if (dve) {
    if (i < 4 * views) return {M_W10PT, HID, VIEW_IN, 0, VIEW_IN, CK * (i % 4)};
    i -= 4 * views;
  }
  if (i < 8) return {M_W10FT, HID, WIDTH, 128 * (i / 4), 128, CK * (i % 4)};
  i -= 8;
  return {M_W8T, WIDTH, WIDTH, 128 * (i / 8), 128, CK * (i % 8)};
}

// The CTA's weight pipeline: chunk i in buffer i % 2, chunk i + 1 loading.
struct Pipe {
  const __nv_bfloat16* img;
  __nv_bfloat16* bufs;
  int i, total, views, dve;
  __device__ __forceinline__ void issue(int j) {
    if (j < total) {
      const Chunk c = chunk_of(j, views, dve);
      __nv_bfloat16* dst = bufs + (j & 1) * CHUNK_ELEMS;
      for (int q = threadIdx.x; q < 3 * c.nc * 4; q += THREADS_A) {
        const int p = q / (c.nc * 4), row = (q >> 2) % c.nc, piece = q & 3;
        cp_async16(dst + (p * C_ROWS + row) * C_PITCH + 8 * piece,
                   img + c.mat + (size_t)p * c.r * c.k + (size_t)(c.n0 + row) * c.k + c.k0 + 8 * piece);
      }
    }
    cp_async_commit();
  }
  __device__ __forceinline__ const __nv_bfloat16* acquire() {
    issue(i + 1);
    cp_async_wait1();
    __syncthreads();
    return bufs + (i & 1) * CHUNK_ELEMS;
  }
  __device__ __forceinline__ void release() {
    __syncthreads();
    ++i;
  }
};

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

// B fragments of n8 tiles j and j + 1 at k16 step s of a chunk, their three
// parts (one ldmatrix per part: the two tiles' K halves 0-7 and 8-15)
__device__ __forceinline__ void chunk_frag2(const __nv_bfloat16* chunk, int j, int s, int lane,
                                            uint32_t (&b0)[3][2], uint32_t (&b1)[3][2]) {
  const int m = lane >> 3, row = 8 * (j + (m >> 1)) + (lane & 7), col = 16 * s + 8 * (m & 1);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    uint32_t r[4];
    ldsm_x4(r, chunk + (p * C_ROWS + row) * C_PITCH + col);
    b0[p][0] = r[0], b0[p][1] = r[1], b1[p][0] = r[2], b1[p][1] = r[3];
  }
}

// The part pairs (A's part, B's part) of a product, smallest first: the six
// i + j <= 2 of two split operands, or an exact bf16 A times B's three parts
// (as functions of the pair's index q: the six are (2, 0), (1, 1), (0, 2),
// (1, 0), (0, 1), (0, 0), the three (0, 2), (0, 1), (0, 0))
__host__ __device__ constexpr int pair6_a(int q) { return q == 0 ? 2 : (q == 1 || q == 3 ? 1 : 0); }
__host__ __device__ constexpr int pair6_b(int q) { return q == 2 ? 2 : (q == 1 || q == 4 ? 1 : 0); }
__host__ __device__ constexpr int pair3_b(int q) { return 2 - q; }

// acc[NT tiles] (+)= A B^T over one chunk of 32 K: for each of its two k16
// steps, frag(step, a) gives A's NA parts; the part products of JG tiles at
// a time run as interleaved chains into fresh accumulators, each step's sum
// then added to acc
template <int NT, int NA, typename F>
__device__ __forceinline__ void chunk_mma(float (&acc)[4 * NT], const __nv_bfloat16* chunk, int lane, F&& frag) {
  constexpr int G = NT < JG ? NT : JG;
  constexpr int NP = NA == 3 ? 6 : 3;
  static_for<2>([&](auto s) {
    uint32_t a[NA][4];
    frag(s, a);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += G) {
      static_assert(G % 2 == 0, "tiles in pairs");
      uint32_t b[G][3][2];
#pragma unroll
      for (int j = 0; j < G; j += 2) chunk_frag2(chunk, j0 + j, decltype(s)::value, lane, b[j], b[j + 1]);
      float t[G][4];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int ia = NA == 3 ? pair6_a(q) : 0, ib = NA == 3 ? pair6_b(q) : pair3_b(q);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (q == 0)
            mma_first(t[j], a[ia], b[j][ib]);
          else
            mma_acc(t[j], a[ia], b[j][ib]);
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * (j0 + j) + e] += t[j][e];
    }
  });
}

// the split A fragments of k16 step s of a chunk at column k0 of rows r and
// r + 8 of an f32 matrix (row length ld; zeros for rows past the scene's
// end)
struct RowFrag {
  const float* src;
  int ld, k0, r, lane;
  bool lo, hi;
  template <typename S>
  __device__ __forceinline__ void operator()(S, uint32_t (&a)[3][4]) const {
    const int k = k0 + 16 * S::value + 2 * (lane & 3);
    const float2 z = make_float2(0.f, 0.f);
    const float* row_lo = src + (size_t)r * ld + k;
    const float* row_hi = row_lo + 8 * (size_t)ld;
    const float2 x[4] = {lo ? *reinterpret_cast<const float2*>(row_lo) : z,
                         hi ? *reinterpret_cast<const float2*>(row_hi) : z,
                         lo ? *reinterpret_cast<const float2*>(row_lo + 8) : z,
                         hi ? *reinterpret_cast<const float2*>(row_hi + 8) : z};
    split_frag(x, a);
  }
};

// stores an accumulator's columns [c0, c0 + 8 NT) of rows r and r + 8
template <int NT>
__device__ __forceinline__ void store_rows(const float (&acc)[4 * NT], float* out, int ld, int c0, int r, bool lo,
                                           bool hi, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = c0 + 8 * j + 2 * (lane & 3);
    if (lo) *reinterpret_cast<float2*>(out + (size_t)r * ld + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    if (hi) *reinterpret_cast<float2*>(out + (size_t)(r + 8) * ld + c) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

template <bool SCENES>
__global__ void __launch_bounds__(THREADS_A, 1)
    heads_bwd_points_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ ve,
                            const float* __restrict__ ve2, const float* __restrict__ g,
                            const __nv_bfloat16* __restrict__ img, const float* __restrict__ small,
                            __nv_bfloat16* __restrict__ d_h, float* __restrict__ feature_out,
                            float* __restrict__ dfeat_out, float* __restrict__ D_out, float* __restrict__ hv_out,
                            float* __restrict__ dhv_out, float* __restrict__ d_ve, float* __restrict__ d_ve2, int nps,
                            int n_sec, int dve) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tps = (nps + TILE_A - 1) / TILE_A;
  const int scene = SCENES ? blockIdx.x / tps : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int lrow = (blockIdx.x - scene * tps) * TILE_A + 16 * warp + gq;  // within the scene
  const int r = scene * nps + lrow;                                       // this thread's rows r, r + 8
  const bool lo = lrow < nps, hi = lrow + 8 < nps;
  const int views = 1 + n_sec, ve2_ld = VIEW_IN * (n_sec > 0 ? n_sec : 1);
  img += (size_t)scene * IMG_ELEMS;
  small += (size_t)scene * SMALL_ELEMS;
  unsigned char* mine = smem + warp * WARP_SMEM;
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(mine);
  float* sg = reinterpret_cast<float*>(mine);  // G, thread-private: slot i of lane l at 32 i + l
  float* sd = sg + 64 * 32;                    // D, likewise
  Pipe pipe{img, reinterpret_cast<__nv_bfloat16*>(smem + WARPS_A * WARP_SMEM), 0,
            16 + 8 + views * (1 + 4 * dve) + 8 + 16, views, dve};
  pipe.issue(0);

  // the warp's 16 rows of h; rows past the scene's end are zeros
  {
    const int row0 = r - gq;
    for (int q = lane; q < 16 * (WIDTH / 8); q += 32) {
      const int rr = q / (WIDTH / 8), c = q % (WIDTH / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (lrow - gq + rr < nps) v = __ldg(reinterpret_cast<const uint4*>(h + (size_t)(row0 + rr) * WIDTH) + c);
      *reinterpret_cast<uint4*>(sh + rr * H_PITCH + 8 * c) = v;
    }
    __syncwarp();
  }

  // feature = h W8^T + b8, a half of 128 columns at a time
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float f[64];
    zero(f);
#pragma unroll 1
    for (int c = 0; c < 8; ++c) {
      const __nv_bfloat16* chunk = pipe.acquire();
      chunk_mma<16, 1>(f, chunk, lane, [&](auto s, uint32_t (&a)[1][4]) {
        const __nv_bfloat16* hp = sh + gq * H_PITCH + CK * c + 16 * decltype(s)::value + 2 * tq;
        a[0][0] = *reinterpret_cast<const uint32_t*>(hp);
        a[0][1] = *reinterpret_cast<const uint32_t*>(hp + 8 * H_PITCH);
        a[0][2] = *reinterpret_cast<const uint32_t*>(hp + 8);
        a[0][3] = *reinterpret_cast<const uint32_t*>(hp + 8 * H_PITCH + 8);
      });
      pipe.release();
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(small + S_B8 + 128 * hf + 8 * j + 2 * tq);
      f[4 * j] += bb.x;
      f[4 * j + 1] += bb.y;
      f[4 * j + 2] += bb.x;
      f[4 * j + 3] += bb.y;
    }
    store_rows<16>(f, feature_out, WIDTH, 128 * hf, r, lo, hi, lane);
  }

  // G = feature W10[:, :256]^T, the feature read back from the rows this
  // thread stored; G waits in shared memory while the views run
  {
    float G[64];
    zero(G);
#pragma unroll 1
    for (int c = 0; c < 8; ++c) {
      const __nv_bfloat16* chunk = pipe.acquire();
      chunk_mma<16, 3>(G, chunk, lane, RowFrag{feature_out, WIDTH, CK * c, r, lane, lo, hi});
      pipe.release();
    }
    __syncwarp();  // every lane's h fragments are read
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sg[i * 32 + lane] = G[i];
      sd[i * 32 + lane] = 0.f;
    }
  }

  const float* w11 = small + S_W11;
#pragma unroll 1
  for (int v = 0; v < views; ++v) {
    const float* pe_src = v == 0 ? ve : ve2 + (v - 1) * VIEW_IN;
    const int pe_ld = v == 0 ? VIEW_IN : ve2_ld;
    // hv = G + pe_v W10[:, 256:]^T
    float hv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) hv[i] = sg[i * 32 + lane];
    {
      const __nv_bfloat16* chunk = pipe.acquire();
      chunk_mma<16, 3>(hv, chunk, lane, RowFrag{pe_src, pe_ld, 0, r, lane, lo, hi});
      pipe.release();
    }
    // d o_v of rows r and r + 8: g[1:5] for the primary view, only column 3
    // (g[4 + v]) for a secondary one
    float dlo[4] = {0.f, 0.f, 0.f, 0.f}, dhi[4] = {0.f, 0.f, 0.f, 0.f};
    if (v == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dlo[k] = lo ? g[(size_t)r * NOUT + 1 + k] : 0.f;
        dhi[k] = hi ? g[(size_t)(r + 8) * NOUT + 1 + k] : 0.f;
      }
    } else {
      dlo[3] = lo ? g[(size_t)r * NOUT + 4 + v] : 0.f;
      dhi[3] = hi ? g[(size_t)(r + 8) * NOUT + 4 + v] : 0.f;
    }
    // hv = relu(. + b10); d hv = (d o W11) where hv > 0; D += d hv. From
    // here on the register array hv holds d hv.
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tq;
      const float2 bb = *reinterpret_cast<const float2*>(small + S_B10 + c);
      float act[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c + (e & 1);
        const float* dd = e < 2 ? dlo : dhi;
        const float pre = hv[4 * j + e] + ((e & 1) ? bb.y : bb.x);
        float dh = __fmul_rn(dd[0], w11[col]);
        dh = __fmaf_rn(dd[1], w11[HID + col], dh);
        dh = __fmaf_rn(dd[2], w11[2 * HID + col], dh);
        dh = __fmaf_rn(dd[3], w11[3 * HID + col], dh);
        act[e] = fmaxf(pre, 0.f);
        hv[4 * j + e] = pre > 0.f ? dh : 0.f;
        sd[(4 * j + e) * 32 + lane] += hv[4 * j + e];
      }
      float* hv_row = hv_out + ((size_t)r * views + v) * HID + c;
      if (lo) *reinterpret_cast<float2*>(hv_row) = make_float2(act[0], act[1]);
      if (hi) *reinterpret_cast<float2*>(hv_row + 8 * views * HID) = make_float2(act[2], act[3]);
    }
    store_rows<16>(hv, dhv_out + v * HID, views * HID, 0, r, lo, hi, lane);
  }
  {
    float D[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) D[i] = sd[i * 32 + lane];
    store_rows<16>(D, D_out, HID, 0, r, lo, hi, lane);
  }

  // d pe_v = d hv_v W10[:, 256:], d hv_v read back from the rows this thread
  // stored: 4 chunks of W10p^T (32 rows) per view
  if (dve) {
#pragma unroll 1
    for (int v = 0; v < views; ++v) {
      float dp[16];
      zero(dp);
#pragma unroll 1
      for (int c = 0; c < 4; ++c) {
        const __nv_bfloat16* chunk = pipe.acquire();
        chunk_mma<4, 3>(dp, chunk, lane, RowFrag{dhv_out + v * HID, views * HID, CK * c, r, lane, lo, hi});
        pipe.release();
      }
      if (v == 0) {
        if (d_ve) store_rows<4>(dp, d_ve, VIEW_IN, 0, r, lo, hi, lane);
      } else if (d_ve2) {
        store_rows<4>(dp, d_ve2, VIEW_IN * n_sec, VIEW_IN * (v - 1), r, lo, hi, lane);
      }
    }
  }

  // d feature = D W10[:, :256], a half of 128 columns at a time, D read back
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float df[64];
    zero(df);
#pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      const __nv_bfloat16* chunk = pipe.acquire();
      chunk_mma<16, 3>(df, chunk, lane, RowFrag{D_out, HID, CK * c, r, lane, lo, hi});
      pipe.release();
    }
    store_rows<16>(df, dfeat_out, WIDTH, 128 * hf, r, lo, hi, lane);
  }

  // d h = d feature W8 + d sigma W9, to bf16, a half of 128 columns at a
  // time, d feature read back
  const float dsig_lo = lo ? g[(size_t)r * NOUT] : 0.f, dsig_hi = hi ? g[(size_t)(r + 8) * NOUT] : 0.f;
#pragma unroll 1
  for (int hh = 0; hh < 2; ++hh) {
    float dh[64];
    zero(dh);
#pragma unroll 1
    for (int c = 0; c < 8; ++c) {
      const __nv_bfloat16* chunk = pipe.acquire();
      chunk_mma<16, 3>(dh, chunk, lane, RowFrag{dfeat_out, WIDTH, CK * c, r, lane, lo, hi});
      pipe.release();
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 128 * hh + 8 * j + 2 * tq;
      const float2 w9 = *reinterpret_cast<const float2*>(small + S_W9 + c);
      const __nv_bfloat162 vlo = __floats2bfloat162_rn(__fadd_rn(dh[4 * j], __fmul_rn(dsig_lo, w9.x)),
                                                       __fadd_rn(dh[4 * j + 1], __fmul_rn(dsig_lo, w9.y)));
      const __nv_bfloat162 vhi = __floats2bfloat162_rn(__fadd_rn(dh[4 * j + 2], __fmul_rn(dsig_hi, w9.x)),
                                                       __fadd_rn(dh[4 * j + 3], __fmul_rn(dsig_hi, w9.y)));
      if (lo) *reinterpret_cast<__nv_bfloat162*>(d_h + (size_t)r * WIDTH + c) = vlo;
      if (hi) *reinterpret_cast<__nv_bfloat162*>(d_h + (size_t)(r + 8) * WIDTH + c) = vhi;
    }
  }
}

// ---------------------------------------------- weight-gradient kernel

constexpr int THREADS_B = 128;
constexpr int TM = 64, TN = 64;  // output tile
constexpr int KSPLIT = 8192;     // rows of the point axis per CTA
constexpr int PROMOTE = 4;       // k16 steps per accumulator before it joins the total
constexpr int X_PITCH = CK + 8;  // bf16 per row of a transposed part
constexpr int SMEM_B = 2 * 3 * TM * X_PITCH * 2;
// a CTA's partial, in doubles: the tile's (mv, nv) entries that lie in the
// output (every tile of a job has the same extent), then X's mv column sums
__host__ __device__ constexpr int partial_doubles(int m, int n) {
  return (m < TM ? m : TM) * (n < TN ? n : TN) + (m < TM ? m : TM);
}
static_assert(TM == TN && PROMOTE % 2 == 0, "tiles");

// How a job finds row k of the reduction in X and Y: ROWS_PLAIN, row k of
// each; the others run over (point p, view v) pairs, k = p views + v, with X
// (ROWS_PE) or Y (ROWS_DO) row k of an (N, views, .) tensor and the other
// side read from the kernels' inputs: ROWS_PE, Y = PE(dir) of view v, row p
// of ve (y) or columns 32 (v - 1).. of row p of ve2 (y2); ROWS_DO, X = d o_v
// of row p of g (x): g[1:5] for the primary view, only column 3 (g[4 + v])
// for a secondary one.
enum { ROWS_PLAIN = 0, ROWS_PE = 1, ROWS_DO = 2 };

// out = X^T Y over the point axis, per scene; xsum = X's column sums
struct Job {
  const float* x;
  const void* y;    // f32, or bf16 if y_bf16
  const float* y2;  // ROWS_PE: ve2
  float* out;       // (M, N) per scene
  float* xsum;      // (M) per scene, or null
  int ldx, ldy, ldy2, m, n, y_bf16, rows, views;
  int k;  // reduction rows per scene
  int tiles_m, tiles_n, splits;
  int cta0, tile0;     // the job's first CTA and output tile (counter)
  long long part0;     // its first partial, in doubles
};
constexpr int MAX_JOBS = 5;
struct Jobs {
  Job j[MAX_JOBS];
  int count;
};

__device__ __forceinline__ void kahan(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// The part products of a k16 step for the warp's 2 x 4 tiles, smallest
// first, each pair over the 8 tiles in turn (independent chains): NP = 6
// for X's three parts against Y's three (i + j <= 2), 3 against a bf16 Y.
// The (0, 0) products go to `big`, the others to `small`; `first` starts
// both afresh.
template <int NP>
__device__ __forceinline__ void mma_pairs(float (&big)[2][4][4], float (&small)[2][4][4], const uint32_t (&a)[2][3][4],
                                          const uint32_t (&b)[4][3][2], bool first, const bool (&mi_live)[2]) {
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int ia = NP == 3 ? 2 - q : pair6_a(q), ib = NP == 3 ? 0 : pair6_b(q);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (!mi_live[mi]) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        if (q == NP - 1) {
          if (first)
            mma_first(big[mi][nj], a[mi][ia], b[nj][ib]);
          else
            mma_acc(big[mi][nj], a[mi][ia], b[nj][ib]);
        } else if (q == 0 && first) {
          mma_first(small[mi][nj], a[mi][ia], b[nj][ib]);
        } else {
          mma_acc(small[mi][nj], a[mi][ia], b[nj][ib]);
        }
      }
    }
  }
}

// One CTA's rows of X and Y for a step of 32 rows: a unit is two rows x four
// columns, unit u = (k-pair u % 16, column quad u / 16), two units per
// thread (u = tid, tid + 128). Loads are 32-byte row segments; the stores of
// the transposed parts hit 32 distinct banks per warp.
struct Rows {
  float x[2][2][4], y[2][2][4];  // [unit][row of the pair][column]
};

// X's columns m .. m + 3 of reduction row k (x: the scene's base)
template <int ROWS>
__device__ __forceinline__ float4 x_quad(const Job& job, const float* x, int k, int m) {
  if constexpr (ROWS == ROWS_DO) {
    const int p = k / job.views, v = k - p * job.views;
    const float* gr = x + (size_t)p * job.ldx;
    return v == 0 ? make_float4(gr[1], gr[2], gr[3], gr[4]) : make_float4(0.f, 0.f, 0.f, gr[4 + v]);
  }
  return *reinterpret_cast<const float4*>(x + (size_t)k * job.ldx + m);
}

__device__ __forceinline__ const float* pe_row(const Job& job, const void* y, const float* y2, int k) {
  const int p = k / job.views, v = k - p * job.views;
  return v == 0 ? static_cast<const float*>(y) + (size_t)p * job.ldy : y2 + (size_t)p * job.ldy2 + VIEW_IN * (v - 1);
}

template <int ROWS>
__device__ __forceinline__ void load_rows(Rows& rw, const Job& job, const float* x, const void* ybase,
                                          const float* y2, int k0, int ke, int m0, int n0, int tid) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int unit = tid + THREADS_B * u, kp = unit & 15, cq = unit >> 4;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int k = k0 + 2 * kp + rr;
      const int m = m0 + 4 * cq, n = n0 + 4 * cq;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
      if (k < ke && m < job.m) xv = x_quad<ROWS>(job, x, k, m);
      if (k < ke && n < job.n) {
        if constexpr (ROWS == ROWS_PE) {
          yv = *reinterpret_cast<const float4*>(pe_row(job, ybase, y2, k) + n);
        } else if (job.y_bf16) {
          const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(ybase) +
                                                            (size_t)k * job.ldy + n);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          yv = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else {
          yv = *reinterpret_cast<const float4*>(static_cast<const float*>(ybase) + (size_t)k * job.ldy + n);
        }
      }
      rw.x[u][rr][0] = xv.x, rw.x[u][rr][1] = xv.y, rw.x[u][rr][2] = xv.z, rw.x[u][rr][3] = xv.w;
      rw.y[u][rr][0] = yv.x, rw.y[u][rr][1] = yv.y, rw.y[u][rr][2] = yv.z, rw.y[u][rr][3] = yv.w;
    }
  }
}

// the rows' split parts, transposed: part q of (row k, column c) at
// s[(q * 64 + c) * X_PITCH + k - k0] (a bf16 y: its values as part 0, the
// other parts unused)
__device__ __forceinline__ void store_rows_split(const Rows& rw, __nv_bfloat16* sx, __nv_bfloat16* sy, int tid,
                                                 bool y_bf16) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int unit = tid + THREADS_B * u, kp = unit & 15, cq = unit >> 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t p[3], q[3];
      split_pair(rw.x[u][0][c], rw.x[u][1][c], p[0], p[1], p[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) *reinterpret_cast<uint32_t*>(sx + (i * TM + 4 * cq + c) * X_PITCH + 2 * kp) = p[i];
      if (y_bf16) {  // exact in bf16: part 0 only
        const __nv_bfloat162 y2 = __floats2bfloat162_rn(rw.y[u][0][c], rw.y[u][1][c]);
        *reinterpret_cast<__nv_bfloat162*>(sy + (4 * cq + c) * X_PITCH + 2 * kp) = y2;
      } else {
        split_pair(rw.y[u][0][c], rw.y[u][1][c], q[0], q[1], q[2]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          *reinterpret_cast<uint32_t*>(sy + (i * TN + 4 * cq + c) * X_PITCH + 2 * kp) = q[i];
      }
    }
  }
}

// One CTA's share of a job (a tile and a split of the reduction), for the
// job's row mode
template <bool SCENES, int ROWS>
__device__ __forceinline__ void weights_cta(const Job& job, int local, double* __restrict__ partials,
                                            int* __restrict__ counters, __nv_bfloat16* sx, __nv_bfloat16* sy,
                                            int& last_s) {
  const int split = local % job.splits, tile = local / job.splits;
  const int tn = tile % job.tiles_n, tm = (tile / job.tiles_n) % job.tiles_m;
  const int scene = SCENES ? tile / (job.tiles_n * job.tiles_m) : 0;
  const int m0 = TM * tm, n0 = TN * tn;
  const int kb = split * KSPLIT, ke = min(job.k, kb + KSPLIT);
  // the scene's rows: job.k of each (N, .) or (N, views, .) tensor, k / views
  // of the inputs read per point (g for ROWS_DO's X, PE(dir) for ROWS_PE's Y)
  const size_t nps = ROWS == ROWS_PLAIN ? job.k : job.k / job.views;
  const float* x = job.x + scene * (ROWS == ROWS_DO ? nps : (size_t)job.k) * job.ldx;
  const size_t y_rows = ROWS == ROWS_PE ? nps : (size_t)job.k;
  const size_t y0 = scene * y_rows * job.ldy;
  const void* ybase = job.y_bf16 ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(job.y) + y0)
                                 : static_cast<const void*>(static_cast<const float*>(job.y) + y0);
  const float* y2 = ROWS == ROWS_PE ? job.y2 + scene * nps * job.ldy2 : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wm = 32 * (warp >> 1), wn = 32 * (warp & 1);
  const bool sums = job.xsum != nullptr && tn == 0;
  // X's column sums over this thread's rows (its units' columns 4 cq ..
  // 4 cq + 3, cq = tid / 16 + 8 u), exact in f64
  double colsum[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};

  // per tile of the warp: the (0, 0) part products and the others in two
  // accumulators, so that the small products are never added to a sum of
  // full size (each such add would truncate at its scale); both join the
  // Kahan total every PROMOTE k16 steps
  float big[2][4][4], small[2][4][4], tot[2][4][4], comp[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[a][b][e] = small[a][b][e] = tot[a][b][e] = comp[a][b][e] = 0.f;
  const bool mi_live[2] = {m0 + wm < job.m, m0 + wm + 16 < job.m};
  const bool n_live = n0 + wn < job.n;  // a job's n is a multiple of 32

  Rows rw;
  load_rows<ROWS>(rw, job, x, ybase, y2, kb, ke, m0, n0, tid);
  int steps = 0;
  for (int k0 = kb; k0 < ke; k0 += CK) {
    store_rows_split(rw, sx, sy, tid, job.y_bf16);
    if (sums) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) colsum[u][c] += (double)rw.x[u][0][c] + (double)rw.x[u][1][c];
    }
    __syncthreads();
    // the next step's rows, in flight
    if (k0 + CK < ke) load_rows<ROWS>(rw, job, x, ybase, y2, k0 + CK, ke, m0, n0, tid);
    if (n_live) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // fragments by ldmatrix: lane l addresses row l % 8 of matrix l / 8;
        // A's four are (rows 0-7 | 8-15) x (K 0-7 | 8-15), B's two tiles x
        // (K 0-7 | 8-15); a bf16 Y has part 0 only
        const int lm = lane >> 3, lrow = lane & 7;
        uint32_t a[2][3][4], b[4][3][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            ldsm_x4(a[mi][q], sx + (q * TM + wm + 16 * mi + 8 * (lm & 1) + lrow) * X_PITCH + 16 * s + 8 * (lm >> 1));
#pragma unroll
        for (int nj = 0; nj < 4; nj += 2)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t r[4] = {0u, 0u, 0u, 0u};
            if (q == 0 || !job.y_bf16)
              ldsm_x4(r, sy + (q * TN + wn + 8 * (nj + (lm >> 1)) + lrow) * X_PITCH + 16 * s + 8 * (lm & 1));
            b[nj][q][0] = r[0], b[nj][q][1] = r[1], b[nj + 1][q][0] = r[2], b[nj + 1][q][1] = r[3];
          }
        const bool first = steps % PROMOTE == 0 && s == 0;
        if (job.y_bf16)
          mma_pairs<3>(big, small, a, b, first, mi_live);
        else
          mma_pairs<6>(big, small, a, b, first, mi_live);
      }
    }
    steps += 2;
    if (steps % PROMOTE == 0 || k0 + CK >= ke) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kahan(tot[mi][nj][e], comp[mi][nj][e], __fadd_rn(big[mi][nj][e], small[mi][nj][e]));
            big[mi][nj][e] = small[mi][nj][e] = 0.f;
          }
      steps = 0;
    }
    __syncthreads();
  }

  // this CTA's partial, in f64 (tot - comp: Kahan's running compensation)
  const int mv = min(job.m, TM), nv = min(job.n, TN), pw = partial_doubles(job.m, job.n);
  double* part = partials + job.part0 + ((size_t)tile * job.splits + split) * pw;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm + 16 * mi + gq + 8 * (e >> 1), col = wn + 8 * nj + 2 * tq + (e & 1);
        if (row < mv && col < nv) part[row * nv + col] = (double)tot[mi][nj][e] - (double)comp[mi][nj][e];
      }
  // the column sums: the 16 threads of a column quad (lanes with equal
  // tid / 16, one per k-pair) in a fixed butterfly order
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      double v = colsum[u][c];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int col = 4 * ((tid >> 4) + 8 * u) + c;
      if ((tid & 15) == 0 && col < mv) part[mv * nv + col] = v;
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + job.tile0 + tile, 1) == job.splits - 1;
  __syncthreads();
  if (!last_s) return;
  // the tile's last CTA: every split's partial, summed in a fixed order
  // (four running sums over the splits, split sp in sum sp % 4 and the last
  // splits in the first, added as a tree), eight entries per thread at a
  // time: 32 loads in flight each
  __threadfence();
  const double* first = partials + job.part0 + (size_t)tile * job.splits * pw;
  float* out = job.out + (size_t)scene * job.m * job.n;
  for (int i0 = 8 * tid; i0 < pw; i0 += 8 * THREADS_B) {
    double acc[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[u][q] = 0.0;
    int sp = 0;
    for (; sp + 4 <= job.splits; sp += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (i0 + q < pw) acc[u][q] += __ldcg(first + (size_t)(sp + u) * pw + i0 + q);
    for (; sp < job.splits; ++sp)  // the last splits, into the first sum
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (i0 + q < pw) acc[0][q] += __ldcg(first + (size_t)sp * pw + i0 + q);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q;
      if (i >= pw) break;
      const double s = (acc[0][q] + acc[1][q]) + (acc[2][q] + acc[3][q]);
      if (i < mv * nv) {
        out[(size_t)(m0 + i / nv) * job.n + n0 + i % nv] = (float)s;
      } else if (sums) {
        job.xsum[(size_t)scene * job.m + m0 + i - mv * nv] = (float)s;
      }
    }
  }
}

template <bool SCENES>
__global__ void __launch_bounds__(THREADS_B)
    heads_bwd_weights_kernel(const Jobs jobs, double* __restrict__ partials, int* __restrict__ counters) {
  __shared__ __align__(16) __nv_bfloat16 sx[3 * TM * X_PITCH];
  __shared__ __align__(16) __nv_bfloat16 sy[3 * TN * X_PITCH];
  __shared__ int last_s;
  // this CTA's job: the last whose first CTA is at or before it (each job
  // read with a constant index, so the table stays in parameter space)
  Job job = jobs.j[0];
#pragma unroll
  for (int i = 1; i < MAX_JOBS; ++i)
    if (i < jobs.count && (int)blockIdx.x >= jobs.j[i].cta0) job = jobs.j[i];
  const int local = blockIdx.x - job.cta0;
  if (job.rows == ROWS_PE)
    weights_cta<SCENES, ROWS_PE>(job, local, partials, counters, sx, sy, last_s);
  else if (job.rows == ROWS_DO)
    weights_cta<SCENES, ROWS_DO>(job, local, partials, counters, sx, sy, last_s);
  else
    weights_cta<SCENES, ROWS_PLAIN>(job, local, partials, counters, sx, sy, last_s);
}

// The five jobs of one launch, their grid laid out in turn.
Jobs make_jobs(const void* h, const float* g, const float* ve, const float* ve2, const float* feature,
               const float* dfeat, const float* D, const float* hv, const float* dhv, float* w8, float* w9,
               float* w10f, float* w10p, float* w11, float* b8, float* b9, float* b10, float* b11, int scenes, int nps,
               int n_sec) {
  const int views = 1 + n_sec, ve2_ld = VIEW_IN * (n_sec > 0 ? n_sec : 1);
  Jobs jobs{};
  // x, y, y2, out, xsum, ldx, ldy, ldy2, m, n, y_bf16, rows, views, k
  const Job list[MAX_JOBS] = {
      {dfeat, h, nullptr, w8, b8, WIDTH, WIDTH, 0, WIDTH, WIDTH, 1, ROWS_PLAIN, 1, nps},  // dW8 = d feature^T h, b8
      {D, feature, nullptr, w10f, b10, HID, WIDTH, 0, HID, WIDTH, 0, ROWS_PLAIN, 1, nps},  // dW10[:, :256], b10
      // dW10[:, 256:] = sum_v d hv_v^T PE(dir)_v
      {dhv, ve, ve2, w10p, nullptr, HID, VIEW_IN, ve2_ld, HID, VIEW_IN, 0, ROWS_PE, views, nps * views},
      {g, hv, nullptr, w11, b11, NOUT, HID, 0, 4, HID, 0, ROWS_DO, views, nps * views},  // dW11 = sum_v d o^T hv, b11
      {g, h, nullptr, w9, b9, NOUT, WIDTH, 0, 1, WIDTH, 1, ROWS_PLAIN, 1, nps},  // dW9 = d sigma^T h, b9
  };
  int cta = 0, tiles = 0;
  long long part = 0;
  for (int i = 0; i < MAX_JOBS; ++i) {
    Job j = list[i];
    j.tiles_m = (j.m + TM - 1) / TM;
    j.tiles_n = (j.n + TN - 1) / TN;
    j.splits = j.k > 0 ? (j.k + KSPLIT - 1) / KSPLIT : 1;
    j.cta0 = cta;  // a CTA per (tile, split), and a partial each
    j.part0 = part;
    j.tile0 = tiles;
    tiles += scenes * j.tiles_m * j.tiles_n;
    cta += scenes * j.tiles_m * j.tiles_n * j.splits;
    part += (long long)scenes * j.tiles_m * j.tiles_n * j.splits * partial_doubles(j.m, j.n);
    jobs.j[i] = j;
  }
  jobs.count = MAX_JOBS;
  return jobs;
}

int total_ctas(const Jobs& jobs, int scenes) {
  const Job& j = jobs.j[jobs.count - 1];
  return j.cta0 + scenes * j.tiles_m * j.tiles_n * j.splits;
}

}  // namespace

extern "C" int vipnerf_heads_bwd_smem_bytes() { return SMEM_A; }

// what = 0: output tiles of the weight-gradient launch (its counters);
// what = 1: doubles of its partials
extern "C" long long vipnerf_heads_bwd_scratch(int scenes, int nps, int n_sec, int what) {
  const Jobs jobs = make_jobs(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, scenes, nps,
                              n_sec);
  long long tiles = 0, doubles = 0;
  for (int i = 0; i < jobs.count; ++i) {
    const Job& j = jobs.j[i];
    const long long t = (long long)scenes * j.tiles_m * j.tiles_n;
    tiles += t;
    doubles += t * j.splits * partial_doubles(j.m, j.n);
  }
  return what == 0 ? tiles : doubles;
}

static bool shape_ok(int scenes, int nps, int n_sec) {
  return n_sec >= 0 && n_sec <= MAX_SEC && scenes >= 1 && nps >= 0 &&
         (long long)scenes * nps * (1 + n_sec) <= 0x7fffffffLL;
}

// h (N, 256) bf16; ve, ve2, g f32 (N = scenes * nps rows); img and small
// each scene's heads_bwd_pack; outputs: d_h (N, 256) bf16, feature and
// d feature (N, 256), D (N, 128), hv and d hv (N, 1 + n_sec, 128), and with
// dve d ve (N, 32) and d ve2 (N, 32 n_sec), each may be null
extern "C" int vipnerf_heads_bwd_points(const void* h, const void* ve, const void* ve2, const void* g,
                                        const void* img, const void* small, void* d_h, void* feature, void* dfeat,
                                        void* D, void* hv, void* dhv, void* d_ve, void* d_ve2, int scenes, int nps,
                                        int n_sec, int dve, void* stream) {
  if (!shape_ok(scenes, nps, n_sec)) return (int)cudaErrorInvalidValue;
  auto kernel = scenes > 1 ? heads_bwd_points_kernel<true> : heads_bwd_points_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_A);
  if (e != cudaSuccess) return (int)e;
  if (nps == 0) return 0;
  const int blocks = scenes * ((nps + TILE_A - 1) / TILE_A);
  kernel<<<blocks, THREADS_A, SMEM_A, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const float*)ve, (const float*)ve2, (const float*)g, (const __nv_bfloat16*)img,
      (const float*)small, (__nv_bfloat16*)d_h, (float*)feature, (float*)dfeat, (float*)D, (float*)hv, (float*)dhv,
      (float*)d_ve, (float*)d_ve2, nps, n_sec, dve);
  return (int)cudaGetLastError();
}

// The weight gradients from the inputs h, g, ve, ve2 of the per-point
// kernel and its outputs, per scene: w8 (256, 256), w9 (1, 256), w10f (128,
// 256), w10p (128, 32) (columns 0-26 real), w11 (4, 128), b8 (256), b9 (1),
// b10 (128), b11 (4); partials and counters sized by
// vipnerf_heads_bwd_scratch, the counters zero.
extern "C" int vipnerf_heads_bwd_weights(const void* h, const void* g, const void* ve, const void* ve2,
                                         const void* feature, const void* dfeat, const void* D, const void* hv,
                                         const void* dhv, void* w8, void* w9, void* w10f, void* w10p, void* w11,
                                         void* b8, void* b9, void* b10, void* b11, void* partials, void* counters,
                                         int scenes, int nps, int n_sec, void* stream) {
  if (!shape_ok(scenes, nps, n_sec)) return (int)cudaErrorInvalidValue;
  const Jobs jobs = make_jobs(h, (const float*)g, (const float*)ve, (const float*)ve2, (const float*)feature,
                              (const float*)dfeat, (const float*)D, (const float*)hv, (const float*)dhv, (float*)w8,
                              (float*)w9, (float*)w10f, (float*)w10p, (float*)w11, (float*)b8, (float*)b9,
                              (float*)b10, (float*)b11, scenes, nps, n_sec);
  auto kernel = scenes > 1 ? heads_bwd_weights_kernel<true> : heads_bwd_weights_kernel<false>;
  kernel<<<total_ctas(jobs, scenes), THREADS_B, 0, (cudaStream_t)stream>>>(jobs, (double*)partials, (int*)counters);
  return (int)cudaGetLastError();
}
