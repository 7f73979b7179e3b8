// Fused conv3x3 + max-pool 3x3/2 for Hopper (sm_90a): the deep torso's
// section-1 convolution and pool in bfloat16, with the pre-pool tensor kept
// out of device memory.
//
// Replaces the Pallas TPU kernel scripts/pallas_conv_pool.py `_kernel`
// (driven by its `fused_conv_pool`). It computes, for uint8 frames
// [N, H, W, 3] (NHWC), a conv weight [16, 3, 3, 3] (OIHW) and a bias [16],
// both bf16, the output bf16 [N, ceil(H/2), ceil(W/2), 16] (NHWC):
//
//   x   = bf16(bf16(frame) / 255)
//   y   = conv3x3(x, w), SAME (zero pad 1), float32 sums of bf16 products
//   p   = max-pool 3x3 stride 2 of y, SAME: -inf pads of (0, 1) at an even
//         size and (1, 1) at an odd one (XLA's rule)
//   out = bf16(bf16(p) + b)
//
// These are the rounding points of the JAX script's function; rounding
// after the max equals rounding before it, since rounding is monotone.
//
// Design. One block per (sample, tile of kRows x kCols pooled outputs).
// The block stages its input window, (2 kRows + 3) x (2 kCols + 3) pixels
// with the zero halo, in shared memory as float32 values of the bf16 x,
// and the weights as float32 [27][16]. Each thread then computes one conv
// position of the tile's (2 kRows + 1) x (2 kCols + 1) window, all 16
// channels, once, summing in a fixed (dy, dx, ci) order, into a float32
// tile in shared memory; positions outside the image hold -inf, which is
// the pool's pad. Last, each thread pools four channels of one output from
// that tile, rounds, adds the bias and writes 8 bytes of NHWC output: a
// warp writes contiguous bytes. Neighbouring tiles recompute their shared
// edge row and column of conv positions (12% more conv work at 72x96)
// instead of exchanging it. The TPU kernel's banded matmul, 0/1
// compaction matmul and out-of-kernel row stride were workarounds for
// Mosaic's layouts and are not carried over.
//
// What bounds it on this card. The function reads N*H*W*3 bytes and writes
// 32 bytes (16 bf16) per pooled output: at N=3232, 72x96 that is
// 245.7 MB, 73.4 us at 3.35 TB/s, against 19.3 GFLOP, 19.5 us at the bf16
// tensor-core rate. So the bytes set the bound. This kernel runs its 432
// multiply-adds per conv position on the CUDA cores in float32 (67 TFLOP/s
// peak: 0.29 ms for the same FLOPs), so it is bound by arithmetic, not by
// the bytes it moves once; a tensor-core (wgmma) form is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kCin = 3;
constexpr int kCout = 16;
constexpr int kTaps = 9 * kCin;                 // (dy, dx, ci)
constexpr int kRows = 6;                        // pooled rows per block
constexpr int kCols = 16;                       // pooled columns per block
constexpr int kConvRows = 2 * kRows + 1;
constexpr int kConvCols = 2 * kCols + 1;
constexpr int kInRows = kConvRows + 2;
constexpr int kInCols = kConvCols + 2;
constexpr int kThreads = 448;
// One thread per conv position and per pooled quad of channels: each
// phase is a single pass. (A loop over positions would let the compiler
// hoist the 432 loop-invariant weight loads into registers, and spill.)
static_assert(kThreads >= kConvRows * kConvCols, "one pass of conv");
static_assert(kThreads >= kRows * kCols * (kCout / 4), "one pass of pool");

// XLA's SAME rule: the low pad of a 3-wide, stride-2 window.
int same_pad_low(int size, int out) {
  const int total = (out - 1) * 2 + 3 - size;
  return total > 0 ? total / 2 : 0;
}

__global__ void __launch_bounds__(kThreads)
conv_pool_kernel(const uint8_t* __restrict__ frames,
                 const __nv_bfloat16* __restrict__ weight,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int h, int w, int out_h,
                 int out_w, int pad_top, int pad_left, int row_tiles,
                 int col_tiles) {
  __shared__ float s_in[kInRows][kInCols][kCin];
  __shared__ __align__(16) float s_w[kTaps][kCout];
  __shared__ __align__(16) float s_conv[kConvRows][kConvCols][kCout];
  __shared__ float s_bias[kCout];

  int tile = blockIdx.x;
  const int col_tile = tile % col_tiles;
  tile /= col_tiles;
  const int row_tile = tile % row_tiles;
  const int n = tile / row_tiles;
  const int p0 = row_tile * kRows;   // first pooled row of the tile
  const int q0 = col_tile * kCols;   // first pooled column
  const int y0 = 2 * p0 - pad_top;   // image row of conv tile row 0
  const int x0 = 2 * q0 - pad_left;  // image column of conv tile column 0

  // Weights OIHW [co][ci][dy][dx] -> s_w[(dy * 3 + dx) * 3 + ci][co].
  for (int i = threadIdx.x; i < kCout * kTaps; i += blockDim.x) {
    const int co = i / kTaps, ci = (i / 9) % kCin, dy = (i % 9) / 3,
              dx = i % 3;
    s_w[(dy * 3 + dx) * kCin + ci][co] = __bfloat162float(weight[i]);
  }
  if (threadIdx.x < kCout) {
    s_bias[threadIdx.x] = __bfloat162float(bias[threadIdx.x]);
  }
  // The input window, zero outside the image: x = bf16(u / 255), exact
  // for u in 0..255 in bf16 before the division, rounded once after it.
  const uint8_t* frame = frames + static_cast<size_t>(n) * h * w * kCin;
  for (int i = threadIdx.x; i < kInRows * kInCols * kCin; i += blockDim.x) {
    const int row = i / (kInCols * kCin);
    const int col = (i / kCin) % kInCols;
    const int ci = i % kCin;
    const int y = y0 - 1 + row, x = x0 - 1 + col;
    float v = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float u = frame[(static_cast<size_t>(y) * w + x) * kCin + ci];
      v = __bfloat162float(__float2bfloat16_rn(u / 255.0f));
    }
    s_in[row][col][ci] = v;
  }
  __syncthreads();

  // Each conv position of the tile once, all 16 channels.
  if (threadIdx.x < kConvRows * kConvCols) {
    const int row = threadIdx.x / kConvCols, col = threadIdx.x % kConvCols;
    const int y = y0 + row, x = x0 + col;
    float acc[kCout];
    if (y < 0 || y >= h || x < 0 || x >= w) {
#pragma unroll
      for (int co = 0; co < kCout; ++co) acc[co] = -CUDART_INF_F;
    } else {
#pragma unroll
      for (int co = 0; co < kCout; ++co) acc[co] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int ci = 0; ci < kCin; ++ci) {
            const float v = s_in[row + dy][col + dx][ci];
            const float4* wv = reinterpret_cast<const float4*>(
                s_w[(dy * 3 + dx) * kCin + ci]);
#pragma unroll
            for (int q = 0; q < kCout / 4; ++q) {
              const float4 w4 = wv[q];
              acc[4 * q + 0] = fmaf(v, w4.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(v, w4.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(v, w4.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(v, w4.w, acc[4 * q + 3]);
            }
          }
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(s_conv[row][col]);
#pragma unroll
    for (int q = 0; q < kCout / 4; ++q) {
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                           acc[4 * q + 3]);
    }
  }
  __syncthreads();

  // Pool four channels of one output per thread; round, add the bias in
  // bf16 (float sum, one rounding, as PyTorch's bf16 add), write NHWC.
  const int quad = threadIdx.x % (kCout / 4);
  const int pc = (threadIdx.x / (kCout / 4)) % kCols;
  const int pr = threadIdx.x / (kCols * (kCout / 4));
  const int p = p0 + pr, q = q0 + pc;
  if (pr < kRows && p < out_h && q < out_w) {
    float m[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                  -CUDART_INF_F};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 v = reinterpret_cast<const float4*>(
            s_conv[2 * pr + dy][2 * pc + dx])[quad];
        m[0] = fmaxf(m[0], v.x);
        m[1] = fmaxf(m[1], v.y);
        m[2] = fmaxf(m[2], v.z);
        m[3] = fmaxf(m[3], v.w);
      }
    }
    __align__(8) __nv_bfloat16 o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pooled = __bfloat162float(__float2bfloat16_rn(m[k]));
      o[k] = __float2bfloat16_rn(pooled + s_bias[4 * quad + k]);
    }
    const size_t offset =
        ((static_cast<size_t>(n) * out_h + p) * out_w + q) * kCout + 4 * quad;
    *reinterpret_cast<uint2*>(out + offset) = *reinterpret_cast<uint2*>(o);
  }
}

}  // namespace

// Launches on `stream` and returns a cudaError_t as an int (0 = ok).
// Pointers are device pointers to contiguous arrays: frames uint8
// [n, h, w, 3], weight bf16 [16, 3, 3, 3], bias bf16 [16], and the output
// bf16 [n, ceil(h/2), ceil(w/2), 16].
extern "C" int conv_pool_launch(const void* frames, const void* weight,
                                const void* bias, void* out, int n, int h,
                                int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int out_h = (h + 1) / 2, out_w = (w + 1) / 2;
  const int row_tiles = (out_h + kRows - 1) / kRows;
  const int col_tiles = (out_w + kCols - 1) / kCols;
  const long long blocks =
      static_cast<long long>(n) * row_tiles * col_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv_pool_kernel<<<static_cast<int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames),
      static_cast<const __nv_bfloat16*>(weight),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), h, w, out_h, out_w,
      same_pad_low(h, out_h), same_pad_low(w, out_w), row_tiles, col_tiles);
  return static_cast<int>(cudaGetLastError());
}
