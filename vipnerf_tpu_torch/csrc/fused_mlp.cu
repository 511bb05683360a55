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
// ridge. The design keeps every activation out of device memory: a CTA owns
// a tile of points, holds the tile's activations in shared memory from the
// first layer to the last, and writes only the 8 raw outputs per point.
// Weights (1.19 MB in bf16) are read from global memory and stay resident
// in L2; each weight fragment a warp loads feeds every point of the tile.
//
// bf16 instance: 128 points per CTA, 8 warps, mma.sync m16n8k16 with f32
// accumulators. Each warp owns a column slice of the layer for all 128 rows
// (or a row slice for the 8-wide outputs). Per layer the f32 sum is rounded
// to bf16, the bf16 bias is added as bf16(float(h) + float(b)), then ReLU:
// the numerics of _make_fwd_kernel and of models/mlp.py with bf16 matmuls.
// Weights come pre-arranged in fragment order (kernels/fused_mlp.py).
//
// f32 instance: 64 points per CTA, plain FFMA on an 8x8 register tile per
// thread, weights in (in, out) row-major.
//
// Both mask the ragged last tile: rows past n load as zeros and are never
// stored. C entry points return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PTS_IN = 64;
constexpr int VIEW_IN = 32;
constexpr int WIDTH = 256;
constexpr int NOUT = 8;
constexpr int MAX_SEC = 3;
constexpr int THREADS = 256;
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
static_assert(w_off(NLAYERS) == 596992, "weight table");
static_assert(b_off(NLAYERS) == 2448, "bias table");

// ------------------------------------------------------------------ bf16

constexpr int BM16 = 128;
constexpr int XE_LD = PTS_IN + 8;                   // +8: conflict-free ldmatrix
constexpr int H_LD = WIDTH + 8;
constexpr int VE_LD = VIEW_IN * (1 + MAX_SEC) + 8;
constexpr int SMEM16 = BM16 * (XE_LD + 2 * H_LD + VE_LD) * 2 + BM16 * NOUT * 4;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Epilogue sinks: a bf16 activation buffer in shared memory ...
struct ToSmem16 {
  __nv_bfloat16* p;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(p + r * ld + c) = __floats2bfloat162_rn(v0, v1);
  }
};

// ... or columns [lo, hi) of a layer's output into the f32 output tile at dst.
struct ToOut {
  float* p;
  int lo, hi, dst;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    if (c >= lo && c < hi) p[r * NOUT + dst + c - lo] = v0;
    if (c + 1 >= lo && c + 1 < hi) p[r * NOUT + dst + c + 1 - lo] = v1;
  }
};

// One layer on the tile: out = epilogue(A @ W^T + b). A is two column
// segments in shared memory (kt1 and kt2 steps of 16), so the skip concat
// [xe, h] and the view concat [feature, PE(dir)] are never copied. Warps
// form a (8 / WARPS_N) x WARPS_N grid; each owns MT m16 tiles x NTW n8 tiles.
template <int MT, int NTW, int WARPS_N, bool RELU, class Store>
__device__ __forceinline__ void layer16(const __nv_bfloat16* a1, int lda1, int kt1,
                                        const __nv_bfloat16* a2, int lda2, int kt2,
                                        const uint2* __restrict__ wf,
                                        const float* __restrict__ bias, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp / WARPS_N) * MT * 16;
  const int nt0 = (warp % WARPS_N) * NTW;
  const int kts = kt1 + kt2;
  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int arow = lane & 15, acol = (lane >> 4) * 8;
  // B fragments of step kt+1 are in flight while step kt computes
  uint2 b[NTW], bn[NTW];
#pragma unroll
  for (int j = 0; j < NTW; ++j) b[j] = __ldg(&wf[(nt0 + j) * kts * 32 + lane]);
  for (int kt = 0; kt < kts; ++kt) {
    const bool first = kt < kt1;
    const __nv_bfloat16* a = first ? a1 : a2;
    const int lda = first ? lda1 : lda2;
    const int kc = (first ? kt : kt - kt1) * 16;
    if (kt + 1 < kts) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) bn[j] = __ldg(&wf[((nt0 + j) * kts + kt + 1) * 32 + lane]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (m0 + i * 16 + arow) * lda + kc + acol);
#pragma unroll
      for (int j = 0; j < NTW; ++j) mma_bf16(acc[i][j], af, b[j]);
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j) b[j] = bn[j];
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = (nt0 + j) * 8 + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = bf16_round(bf16_round(acc[i][j][2 * h]) + b0);
        float v1 = bf16_round(bf16_round(acc[i][j][2 * h + 1]) + b1);
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        store(m0 + i * 16 + g + h * 8, col, v0, v1);
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ xe,
                          const __nv_bfloat16* __restrict__ ve,
                          const __nv_bfloat16* __restrict__ ve2,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int n, int n_sec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][XE_LD]
  __nv_bfloat16* h0 = sx + BM16 * XE_LD;                       // [BM][H_LD]
  __nv_bfloat16* h1 = h0 + BM16 * H_LD;                        // [BM][H_LD]
  __nv_bfloat16* sv = h1 + BM16 * H_LD;                        // [BM][VE_LD]
  float* so = reinterpret_cast<float*>(sv + BM16 * VE_LD);     // [BM][NOUT]

  const int row0 = blockIdx.x * BM16;
  const int tid = threadIdx.x;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int ve2_ld = VIEW_IN * (n_sec > 0 ? n_sec : 1);

  // Stage the tile's inputs in 16-byte pieces (8 bf16): xe has 8 per row,
  // ve 4, ve2 4 per secondary view. Rows past n are zeros.
  for (int i = tid; i < BM16 * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool in = row0 + r < n;
    const uint4 v = in ? __ldg(reinterpret_cast<const uint4*>(xe + (size_t)(row0 + r) * PTS_IN) + c) : zero;
    *reinterpret_cast<uint4*>(sx + r * XE_LD + c * 8) = v;
  }
  const int vpieces = 4 * (1 + n_sec);
  for (int i = tid; i < BM16 * vpieces; i += THREADS) {
    const int r = i / vpieces, c = i % vpieces;
    const bool in = row0 + r < n;
    uint4 v = zero;
    if (in) {
      v = c < 4 ? __ldg(reinterpret_cast<const uint4*>(ve + (size_t)(row0 + r) * VIEW_IN) + c)
                : __ldg(reinterpret_cast<const uint4*>(ve2 + (size_t)(row0 + r) * ve2_ld) + c - 4);
    }
    *reinterpret_cast<uint4*>(sv + r * VE_LD + c * 8) = v;
  }
  for (int i = tid; i < BM16 * NOUT; i += THREADS) so[i] = 0.f;
  __syncthreads();

  const uint2* wf = reinterpret_cast<const uint2*>(w);
#define W16(l) (wf + w_off(l) / 4)
#define B16(l) (bias + b_off(l))
  // trunk: activations ping-pong between h0 and h1
  layer16<8, 4, 8, true>(sx, XE_LD, 4, sx, XE_LD, 0, W16(0), B16(0), ToSmem16{h0, H_LD});
  __syncthreads();
  layer16<8, 4, 8, true>(h0, H_LD, 16, h0, H_LD, 0, W16(1), B16(1), ToSmem16{h1, H_LD});
  __syncthreads();
  layer16<8, 4, 8, true>(h1, H_LD, 16, h1, H_LD, 0, W16(2), B16(2), ToSmem16{h0, H_LD});
  __syncthreads();
  layer16<8, 4, 8, true>(h0, H_LD, 16, h0, H_LD, 0, W16(3), B16(3), ToSmem16{h1, H_LD});
  __syncthreads();
  layer16<8, 4, 8, true>(h1, H_LD, 16, h1, H_LD, 0, W16(4), B16(4), ToSmem16{h0, H_LD});
  __syncthreads();
  // skip layer: [xe, h] with no copy
  layer16<8, 4, 8, true>(sx, XE_LD, 4, h0, H_LD, 16, W16(5), B16(5), ToSmem16{h1, H_LD});
  __syncthreads();
  layer16<8, 4, 8, true>(h1, H_LD, 16, h1, H_LD, 0, W16(6), B16(6), ToSmem16{h0, H_LD});
  __syncthreads();
  layer16<8, 4, 8, true>(h0, H_LD, 16, h0, H_LD, 0, W16(7), B16(7), ToSmem16{h1, H_LD});
  __syncthreads();
  // heads: feature -> h0, sigma -> output column 0
  layer16<8, 4, 8, false>(h1, H_LD, 16, h1, H_LD, 0, W16(8), B16(8), ToSmem16{h0, H_LD});
  layer16<1, 1, 1, false>(h1, H_LD, 16, h1, H_LD, 0, W16(9), B16(9), ToOut{so, 0, 1, 0});
  __syncthreads();
  // view branch, primary view: rgb + vis -> output columns 1..4
  layer16<8, 2, 8, true>(h0, H_LD, 16, sv, VE_LD, 2, W16(10), B16(10), ToSmem16{h1, H_LD});
  __syncthreads();
  layer16<1, 1, 1, false>(h1, H_LD, 8, h1, H_LD, 0, W16(11), B16(11), ToOut{so, 0, 4, 1});
  // secondary views: vis only -> output column 5 + j
  for (int j = 0; j < n_sec; ++j) {
    __syncthreads();
    layer16<8, 2, 8, true>(h0, H_LD, 16, sv + VIEW_IN * (1 + j), VE_LD, 2, W16(10), B16(10),
                           ToSmem16{h1, H_LD});
    __syncthreads();
    layer16<1, 1, 1, false>(h1, H_LD, 8, h1, H_LD, 0, W16(11), B16(11), ToOut{so, 3, 4, 5 + j});
  }
#undef W16
#undef B16
  __syncthreads();

  for (int r = tid; r < BM16; r += THREADS) {
    if (row0 + r >= n) continue;
    const float* o = so + r * NOUT;
    const uint4 q = make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]),
                               pack_bf16x2(o[4], o[5]), pack_bf16x2(o[6], o[7]));
    *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * NOUT) = q;
  }
}

// ------------------------------------------------------------------- f32

constexpr int BM32 = 64;
constexpr int VE32_LD = VIEW_IN * (1 + MAX_SEC);
constexpr int SMEM32 = BM32 * (PTS_IN + 2 * WIDTH + VE32_LD + NOUT) * 4;

struct ToSmem32 {
  float* p;
  int ld;
  __device__ void operator()(int r, int c, float v) const { p[r * ld + c] = v; }
};

struct ToOut32 {
  float* p;
  int lo, hi, dst;
  __device__ void operator()(int r, int c, float v) const {
    if (c >= lo && c < hi) p[r * NOUT + dst + c - lo] = v;
  }
};

// out = epilogue(A @ W + b), W (K, N) row-major. Thread tile RT rows x CT
// columns; a warp shares its rows, so the A reads are broadcasts and the W
// reads are contiguous.
template <int N, int RT, int CT, bool RELU, class Store>
__device__ __forceinline__ void layer32(const float* a1, int lda1, int k1, const float* a2,
                                        int lda2, int k2, const float* __restrict__ wt,
                                        const float* __restrict__ bias, Store store) {
  constexpr int NCG = N / CT;
  static_assert((BM32 / RT) * NCG == THREADS, "thread tiling");
  const int c0 = (threadIdx.x % NCG) * CT, r0 = (threadIdx.x / NCG) * RT;
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < k1 + k2; ++k) {
    const bool first = k < k1;
    const float* a = first ? a1 + k : a2 + (k - k1);
    const int lda = first ? lda1 : lda2;
    float wv[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) wv[j] = __ldg(wt + k * N + c0 + j);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float av = a[(r0 + i) * lda];
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      float v = acc[i][j] + bias[c0 + j];
      if (RELU) v = fmaxf(v, 0.f);
      store(r0 + i, c0 + j, v);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_mlp_f32_kernel(const float* __restrict__ xe, const float* __restrict__ ve,
                         const float* __restrict__ ve2, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ out, int n,
                         int n_sec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);  // [BM][64]
  float* h0 = sx + BM32 * PTS_IN;              // [BM][256]
  float* h1 = h0 + BM32 * WIDTH;               // [BM][256]
  float* sv = h1 + BM32 * WIDTH;               // [BM][128]
  float* so = sv + BM32 * VE32_LD;             // [BM][8]

  const int row0 = blockIdx.x * BM32;
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ve2_ld = VIEW_IN * (n_sec > 0 ? n_sec : 1);

  for (int i = tid; i < BM32 * (PTS_IN / 4); i += THREADS) {
    const int r = i / (PTS_IN / 4), c = i % (PTS_IN / 4);
    const float4 v = row0 + r < n ? __ldg(reinterpret_cast<const float4*>(xe + (size_t)(row0 + r) * PTS_IN) + c) : zero;
    *reinterpret_cast<float4*>(sx + r * PTS_IN + c * 4) = v;
  }
  const int vpieces = (VIEW_IN / 4) * (1 + n_sec);
  for (int i = tid; i < BM32 * vpieces; i += THREADS) {
    const int r = i / vpieces, c = i % vpieces;
    float4 v = zero;
    if (row0 + r < n) {
      v = c < VIEW_IN / 4
              ? __ldg(reinterpret_cast<const float4*>(ve + (size_t)(row0 + r) * VIEW_IN) + c)
              : __ldg(reinterpret_cast<const float4*>(ve2 + (size_t)(row0 + r) * ve2_ld) + c - VIEW_IN / 4);
    }
    *reinterpret_cast<float4*>(sv + r * VE32_LD + c * 4) = v;
  }
  for (int i = tid; i < BM32 * NOUT; i += THREADS) so[i] = 0.f;
  __syncthreads();

#define W32(l) (w + w_off(l))
#define B32(l) (bias + b_off(l))
  layer32<256, 8, 8, true>(sx, PTS_IN, 64, sx, PTS_IN, 0, W32(0), B32(0), ToSmem32{h0, WIDTH});
  __syncthreads();
  layer32<256, 8, 8, true>(h0, WIDTH, 256, h0, WIDTH, 0, W32(1), B32(1), ToSmem32{h1, WIDTH});
  __syncthreads();
  layer32<256, 8, 8, true>(h1, WIDTH, 256, h1, WIDTH, 0, W32(2), B32(2), ToSmem32{h0, WIDTH});
  __syncthreads();
  layer32<256, 8, 8, true>(h0, WIDTH, 256, h0, WIDTH, 0, W32(3), B32(3), ToSmem32{h1, WIDTH});
  __syncthreads();
  layer32<256, 8, 8, true>(h1, WIDTH, 256, h1, WIDTH, 0, W32(4), B32(4), ToSmem32{h0, WIDTH});
  __syncthreads();
  layer32<256, 8, 8, true>(sx, PTS_IN, 64, h0, WIDTH, 256, W32(5), B32(5), ToSmem32{h1, WIDTH});
  __syncthreads();
  layer32<256, 8, 8, true>(h1, WIDTH, 256, h1, WIDTH, 0, W32(6), B32(6), ToSmem32{h0, WIDTH});
  __syncthreads();
  layer32<256, 8, 8, true>(h0, WIDTH, 256, h0, WIDTH, 0, W32(7), B32(7), ToSmem32{h1, WIDTH});
  __syncthreads();
  layer32<256, 8, 8, false>(h1, WIDTH, 256, h1, WIDTH, 0, W32(8), B32(8), ToSmem32{h0, WIDTH});
  layer32<8, 2, 1, false>(h1, WIDTH, 256, h1, WIDTH, 0, W32(9), B32(9), ToOut32{so, 0, 1, 0});
  __syncthreads();
  layer32<128, 8, 4, true>(h0, WIDTH, 256, sv, VE32_LD, VIEW_IN, W32(10), B32(10), ToSmem32{h1, WIDTH});
  __syncthreads();
  layer32<8, 2, 1, false>(h1, WIDTH, 128, h1, WIDTH, 0, W32(11), B32(11), ToOut32{so, 0, 4, 1});
  for (int j = 0; j < n_sec; ++j) {
    __syncthreads();
    layer32<128, 8, 4, true>(h0, WIDTH, 256, sv + VIEW_IN * (1 + j), VE32_LD, VIEW_IN, W32(10),
                             B32(10), ToSmem32{h1, WIDTH});
    __syncthreads();
    layer32<8, 2, 1, false>(h1, WIDTH, 128, h1, WIDTH, 0, W32(11), B32(11), ToOut32{so, 3, 4, 5 + j});
  }
#undef W32
#undef B32
  __syncthreads();

  for (int i = tid; i < BM32 * 2; i += THREADS) {
    const int r = i >> 1, c = i & 1;
    if (row0 + r < n)
      reinterpret_cast<float4*>(out + (size_t)(row0 + r) * NOUT)[c] =
          reinterpret_cast<const float4*>(so + r * NOUT)[c];
  }
}

}  // namespace

extern "C" int vipnerf_fused_mlp_bf16(const void* xe, const void* ve, const void* ve2,
                                      const void* w, const void* bias, void* out, int n,
                                      int n_sec, void* stream) {
  if (n_sec < 0 || n_sec > MAX_SEC) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM16);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  fused_mlp_bf16_kernel<<<(n + BM16 - 1) / BM16, THREADS, SMEM16, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)xe, (const __nv_bfloat16*)ve, (const __nv_bfloat16*)ve2,
      (const __nv_bfloat16*)w, (const float*)bias, (__nv_bfloat16*)out, n, n_sec);
  return (int)cudaGetLastError();
}

extern "C" int vipnerf_fused_mlp_f32(const void* xe, const void* ve, const void* ve2,
                                     const void* w, const void* bias, void* out, int n,
                                     int n_sec, void* stream) {
  if (n_sec < 0 || n_sec > MAX_SEC) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM32);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  fused_mlp_f32_kernel<<<(n + BM32 - 1) / BM32, THREADS, SMEM32, (cudaStream_t)stream>>>(
      (const float*)xe, (const float*)ve, (const float*)ve2, (const float*)w,
      (const float*)bias, (float*)out, n, n_sec);
  return (int)cudaGetLastError();
}
