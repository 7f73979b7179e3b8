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
// What bounds it on this card. The function reads N*H*W*3 bytes and writes
// 32 bytes (16 bf16) per pooled output: at N=3232, 72x96 that is
// 245.7 MB, 73.4 us at 3.35 TB/s, against 19.3 GFLOP, 19.5 us at the bf16
// tensor-core rate. So the bytes set the bound. The first form of this
// kernel ran the 432 multiply-adds of a conv position in float32 on the
// CUDA cores, with four shared-memory weight loads per 16 FMAs, over tiles
// of 6x16 pooled outputs that recomputed 12% of the conv positions: it was
// bound by that arithmetic (1.6 ms). This form is bound by the
// instructions and shared-memory traffic of its four phases per band
// (PERF.md has their split), not by the bytes or the tensor cores.
//
// Design. One block per (frame, band of `rows` pooled rows, tile of `cols`
// pooled columns); at 72x96 a tile is the full width (48 pooled columns),
// so no column is recomputed and a band of input rows is one contiguous
// byte range.
//   1. Stage. The band's input rows (with the conv's one-row halo) are
//      copied into shared memory with 16-byte cp.async where the 16 bytes
//      lie inside the row, and byte by byte at the row's ragged ends; the
//      weights go to registers meanwhile.
//   2. Convert. x = bf16(u / 255) into a window with the zero halo, kept
//      twice: the second copy shifted by one element, so that any two
//      neighbouring elements are one aligned 32-bit load from one of them.
//   3. Convolve on the tensor cores: mma.sync m16n8k16, bf16 in, f32 sums.
//      A is 16 conv positions of one conv row x 32 taps (the 27 taps in
//      pairs of neighbouring window elements, zero-padded to 32: 2
//      k-steps); each thread's 8 pairs sit at fixed offsets from a
//      position, so its A fragments are 8 aligned 32-bit loads straight
//      from the window, on 32 banks (no im2col tile, which would cost a
//      second pass through shared memory; ldmatrix would need 16-byte
//      aligned rows of taps, which 3-channel pixels do not give). B, the
//      packed weight [32, 16] (conv_pool_cuda.pack_weight), lives in 8
//      registers. A warp owns a 16-column segment and walks the band's
//      conv rows down, so the pool's max over rows is taken in registers.
//      mma.sync and not wgmma: with N = 16 output channels and the bytes
//      as the bound, wgmma's 64-row tiles and shared-memory descriptors
//      buy nothing here.
//   4. Pool. The row maxima, rounded to bf16, go to a shared tile; each
//      thread takes the max over three columns for 8 channels of one
//      output, adds the bias and writes 16 bytes, so a warp writes a
//      contiguous run of the NHWC output.
// The pool's -inf pads are never computed: a SAME window always holds an
// image row (column) next to any row (column) of it outside the image, so
// the max with -inf pads equals the max with each outside index clamped
// to the nearest image one, which is what the kernel takes. The launch
// geometry (rows, cols, threads, shared bytes) is chosen in Python
// (ops/conv_pool_cuda.py launch_geometry) and checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

// Phases compiled out, by bit (1 the copies of stage, 2 convert, 4
// convolve, 8 pool): 0 but for scripts/kernel_phases.py, which times the
// kernel without each phase in turn. The results are then wrong.
#ifndef SKIP_PHASES
#define SKIP_PHASES 0
#endif

namespace {

constexpr unsigned kSkip = SKIP_PHASES;

constexpr int kCin = 3;
constexpr int kCout = 16;
constexpr int kSeg = 16;         // conv positions per mma tile
constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 16;                   // pooled rows per band
constexpr int kMaxInRows = 2 * kMaxRows + 3;   // window rows
constexpr int kNoRow = INT_MIN;
constexpr int kMaxSharedBytes = 232448;
constexpr float kInv255 = 0x1.010102p-8f;  // 1/255 rounded to float

// XLA's SAME rule: the low pad of a 3-wide, stride-2 window.
int same_pad_low(int size, int out) {
  const int total = (out - 1) * 2 + 3 - size;
  return total > 0 ? total / 2 : 0;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Geometry {
  int h, w, out_h, out_w, pad_top, pad_left;
  int rows;       // pooled rows per band
  int cols;       // pooled columns per tile
  int row_bands, col_tiles;
  int segs;       // 16-position segments of a conv row
  int in_rows;    // input rows of a band: 2 rows + 3
  int in_pixels;  // input columns of a tile: 2 cols + 3
  int raw_stride;  // bytes per staged input row
  int win_stride;  // bf16 elements per window row
  int copy1;       // bytes from the window's copy 0 to copy 1
  int win_offset, vmax_offset, smem_bytes;
};

Geometry make_geometry(int h, int w, int rows, int cols) {
  Geometry g;
  g.h = h;
  g.w = w;
  g.out_h = (h + 1) / 2;
  g.out_w = (w + 1) / 2;
  g.pad_top = same_pad_low(h, g.out_h);
  g.pad_left = same_pad_low(w, g.out_w);
  g.rows = rows;
  g.cols = cols;
  g.row_bands = (g.out_h + rows - 1) / rows;
  g.col_tiles = (g.out_w + cols - 1) / cols;
  g.segs = (2 * cols + 1 + kSeg - 1) / kSeg;
  g.in_rows = 2 * rows + 3;
  g.in_pixels = 2 * cols + 3;
  g.raw_stride = round_up(g.in_pixels * kCin + 15, 16);
  // A window row holds 3 * 16 segs + 9 elements (+1 of shift) at least,
  // and a multiple of 6 (two pixels per converting thread). Its stride
  // and copy 1's offset mod 128 bytes put the 32 lanes of every A load on
  // 32 banks (tests/test_torch_kernel_layout.py counts them).
  g.win_stride = 3 * kSeg * g.segs + (g.segs % 2 ? 24 : 72);
  g.copy1 = round_up(g.in_rows * g.win_stride * 2, 128) + 56;
  // The staged rows, with 16 bytes of slack before them: the conversion's
  // aligned loads start up to 7 bytes early.
  g.win_offset = 16 + g.in_rows * g.raw_stride;
  g.vmax_offset =
      g.win_offset + round_up(g.copy1 + g.in_rows * g.win_stride * 2, 16);
  g.smem_bytes = g.vmax_offset + rows * g.segs * kSeg * kCout * 2;
  return g;
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The K order of the mma (conv_pool_cuda.k_element): k = 2p + h; pair
// p = 4 dy + j (j < 4) holds elements 2j + h of a position's 9 taps
// (3 dx + ci) in window row dy, pair 12 + dy elements 8 + h; element 9
// (the next pixel's) and pair 15 have zero weight. So every pair is two
// neighbouring window elements, and the four pairs one load instruction
// reads (tig = 0..3) lie in one window row, or are the rows' element 8.
// Offset of pair p's first element from a position's first element:
__device__ __forceinline__ int pair_offset(int p, int win_stride) {
  if (p < 12) return (p / 4) * win_stride + 2 * (p % 4);
  if (p < 15) return (p - 12) * win_stride + 8;
  return 0;
}

// One conv row of 16 positions (rows gid and gid + 8 of the tile): D = A B
// over two k-steps, A gathered from the window at `base`.
__device__ __forceinline__ void conv_row(float (&d)[2][4], const uint8_t* base,
                                         const uint32_t (&a_off)[2][2],
                                         const uint32_t (&b)[2][2][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) d[j][c] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(base + a_off[s][0]);
    a[1] = *reinterpret_cast<const uint32_t*>(base + a_off[s][0] + 48);
    a[2] = *reinterpret_cast<const uint32_t*>(base + a_off[s][1]);
    a[3] = *reinterpret_cast<const uint32_t*>(base + a_off[s][1] + 48);
#pragma unroll
    for (int j = 0; j < 2; ++j) mma_bf16(d[j], a, b[s][j][0], b[s][j][1]);
  }
}

// A band of one frame: where it sits in the image.
struct Band {
  int n, p0, q0;  // frame, first pooled row, first pooled column
  int y0, x0;     // image row and column of conv row / column 0
  int xs, xe;     // image columns staged: [xs, xe)
};

__device__ __forceinline__ Band band_of(const Geometry& g, int tile) {
  Band t;
  const int col_tile = tile % g.col_tiles;
  tile /= g.col_tiles;
  t.n = tile / g.row_bands;
  t.p0 = (tile % g.row_bands) * g.rows;
  t.q0 = col_tile * g.cols;
  t.y0 = 2 * t.p0 - g.pad_top;
  t.x0 = 2 * t.q0 - g.pad_left;
  t.xs = max(t.x0 - 1, 0);
  t.xe = min(t.x0 - 1 + g.in_pixels, g.w);
  return t;
}

// 1. Stage a band's input rows into `raw`: window row r is image row
// y0 - 1 + r; byte i of its staged piece lands at head + i, head being the
// piece's address mod 16, so whole 16-byte chunks go by cp.async as they
// are and the ragged ends byte by byte. Thread t takes chunk t % chunks of
// every (threads / chunks)-th row. row_off[r] gets the offset of window
// row r's element 0 in `raw` (below 0 by up to the left pad), or kNoRow.
// The caller waits for the copies (cp.async group) and syncs.
__device__ void stage_band(const Geometry& g, const uint8_t* frames,
                           const Band& t, uint8_t* raw, int* row_off) {
  const uint8_t* frame = frames + static_cast<size_t>(t.n) * g.h * g.w * kCin;
  const int chunks = g.raw_stride / 16;
  if (threadIdx.x < chunks * (blockDim.x / chunks)) {
    const int c = threadIdx.x % chunks;
    for (int r = threadIdx.x / chunks; r < g.in_rows;
         r += blockDim.x / chunks) {
      const int y = t.y0 - 1 + r;
      if (y < 0 || y >= g.h) continue;
      const uint8_t* src =
          frame + (static_cast<size_t>(y) * g.w + t.xs) * kCin;
      const int head = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
      const int end = head + (t.xe - t.xs) * kCin;
      const int lo = 16 * c, hi = 16 * c + 16;
      uint8_t* dst = raw + r * g.raw_stride;
      if (kSkip & 1) {
        // The copies compiled out (scripts/kernel_phases.py).
      } else if (lo >= head && hi <= end) {
        cp_async_16(dst + lo, src - head + lo);
      } else {
        for (int b = max(lo, head); b < min(hi, end); ++b) {
          dst[b] = src[b - head];
        }
      }
      if (c == 0) {
        row_off[r] = r * g.raw_stride + head - kCin * (t.xs - (t.x0 - 1));
      }
    }
  }
  if (threadIdx.x < g.in_rows) {
    const int y = t.y0 - 1 + threadIdx.x;
    if (y < 0 || y >= g.h) row_off[threadIdx.x] = kNoRow;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One block per band.
__global__ void __launch_bounds__(kMaxThreads)
conv_pool_kernel(const uint8_t* __restrict__ frames,
                 const __nv_bfloat16* __restrict__ wpack,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int row_offs[kMaxInRows];
  const uint8_t* raw = smem + 16;
  uint8_t* win = smem + g.win_offset;
  uint8_t* vmax = smem + g.vmax_offset;
  const int copy1 = g.copy1;
  const int vmax_row = g.segs * kSeg * kCout * 2;  // bytes per row

  const Band t = band_of(g, blockIdx.x);
  const int y0 = t.y0, x0 = t.x0;
  stage_band(g, frames, t, smem + 16, row_offs);
  // The pool's threads keep the bias of their 8 channels in registers.
  const int half = threadIdx.x % 2;
  float bias_f[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bias_f[k] = __bfloat162float(bias[8 * half + k]);
  // mma m16n8k16 fragments (PTX ISA): lane = 4 gid + tig; A rows gid and
  // gid + 8, A/B k columns 2 tig (+1) and 2 tig + 8 (+1); B and D column
  // gid / 2 tig. The weights are loaded while the band's bytes arrive.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  uint32_t b[2][2][2];  // [k-step][n-tile][register]
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int reg = 0; reg < 2; ++reg) {
        const int k = 16 * s + 2 * tig + 8 * reg;
        const int co = 8 * j + gid;
        b[s][j][reg] = pack_bf16(wpack[k * kCout + co],
                                 wpack[(k + 1) * kCout + co]);
      }
    }
  }
  // Byte offsets of this thread's A pairs (k-step s, low/high 8 k) from
  // its position's first element (row gid of the tile): each pair is one
  // 32-bit load from whichever copy aligns it.
  uint32_t a_off[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int half_k = 0; half_k < 2; ++half_k) {
      const int e =
          3 * gid + pair_offset(8 * s + tig + 4 * half_k, g.win_stride);
      a_off[s][half_k] = (e % 2 == 0) ? 2 * e : copy1 + 2 * (e + 1);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. Convert: window element e of row r is channel e % 3 of image column
  // x0 - 1 + e / 3; zero outside the image (the conv's SAME pad). Copy 0
  // holds element e at e, copy 1 at e + 1. Thread t converts the six
  // elements 6j .. 6j + 5 (two pixels; j = t % per_row) of every
  // (threads / per_row)-th row into three aligned 32-bit words of each
  // copy. x = bf16(u * (1/255)) is bf16(u / 255) for every byte u
  // (tests/test_torch_kernel_layout.py).
  const int per_row = g.win_stride / 6;
  if (threadIdx.x < per_row * (blockDim.x / per_row) && !(kSkip & 2)) {
    const int j = threadIdx.x % per_row;
    const int in_elems = g.in_pixels * kCin;
    bool valid[7];  // elements 6j - 1 .. 6j + 5 inside the image columns
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int el = 6 * j - 1 + k;
      const int x = x0 - 1 + (el + kCin) / kCin - 1;
      valid[k] = el >= 0 && el < in_elems && x >= 0 && x < g.w;
    }
    for (int r = threadIdx.x / per_row; r < g.in_rows;
         r += blockDim.x / per_row) {
      const int row_off = row_offs[r];
      // The 7 staged bytes of elements 6j - 1 .. 6j + 5, by three aligned
      // 32-bit loads (the slack before the rows covers a start below 0;
      // bytes past the row are read but not used).
      uint32_t lo = 0, hi = 0;
      if (row_off != kNoRow) {
        const int first = row_off + 6 * j - 1;
        const int aligned = first & ~3;
        const uint32_t* words =
            reinterpret_cast<const uint32_t*>(raw + aligned);
        const uint32_t w0 = words[0], w1 = words[1], w2 = words[2];
        lo = __funnelshift_r(w0, w1, 8 * (first - aligned));
        hi = __funnelshift_r(w1, w2, 8 * (first - aligned));
      }
      __nv_bfloat16 v[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const uint32_t u = ((k < 4 ? lo : hi) >> (8 * (k % 4))) & 0xff;
        v[k] = __float2bfloat16_rn(
            row_off != kNoRow && valid[k]
                ? __fmul_rn(static_cast<float>(u), kInv255) : 0.0f);
      }
      uint32_t* w0 = reinterpret_cast<uint32_t*>(
          win + 2 * (r * g.win_stride + 6 * j));
      uint32_t* w1 = reinterpret_cast<uint32_t*>(
          win + copy1 + 2 * (r * g.win_stride + 6 * j));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w0[k] = pack_bf16(v[2 * k + 1], v[2 * k + 2]);
        w1[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
      }
    }
  }
  __syncthreads();

  // 3. Convolve and take the max over rows. A SAME pool window always
  // holds an image row next to any row of it outside the image, so the
  // max with -inf pads equals the max with each outside row replaced by
  // its nearest image row: conv rows are clamped into the image, and no
  // pad value is ever computed. A warp owns a 16-column segment and walks
  // the conv rows of its pooled rows down: pooled row pr takes the max of
  // conv rows 2pr, 2pr+1 and 2pr+2, the first shared with pooled row pr-1.
  for (int seg = warp; seg < g.segs && !(kSkip & 4);
       seg += blockDim.x / 32) {
    const uint8_t* seg_base = win + 2 * seg * 3 * kSeg;
    auto row_base = [&](int i) {  // conv row i, clamped into the image
      const int ic = min(max(y0 + i, 0), g.h - 1) - y0;
      return seg_base + 2 * ic * g.win_stride;
    };
    // The row maxima of position jx keep channels 8h .. 8h + 7 at
    // 8 (h ^ (jx / 4 % 2)): the 32 lanes' stores then hit 32 banks.
    const int swz = 8 * (gid / 4 % 2);
    float last[2][4], mid[2][4], next[2][4];
    conv_row(last, row_base(0), a_off, b);
    for (int pr = 0; pr < g.rows; ++pr) {
      conv_row(mid, row_base(2 * pr + 1), a_off, b);
      conv_row(next, row_base(2 * pr + 2), a_off, b);
      uint8_t* dst = vmax + pr * vmax_row + (seg * kSeg + gid) * kCout * 2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ch = 8 * j + 2 * tig;
        float m[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          m[c] = fmaxf(fmaxf(last[j][c], mid[j][c]), next[j][c]);
          last[j][c] = next[j][c];
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + 2 * (ch ^ swz)) =
            __floats2bfloat162_rn(m[0], m[1]);
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * kCout * 2 +
                                           2 * (ch ^ swz)) =
            __floats2bfloat162_rn(m[2], m[3]);
      }
    }
  }
  __syncthreads();

  // 4. Pool over columns (clamped into the image, as the rows were), add
  // the bias (float sum, one rounding, as PyTorch's bf16 add), write 8
  // channels (16 bytes) per thread: channels 8 half .. 8 half + 7, half
  // being the thread's parity.
  for (int i = threadIdx.x; i < g.rows * g.cols * 2 && !(kSkip & 8);
       i += blockDim.x) {
    const int qc = (i / 2) % g.cols;
    const int pr = (i / 2) / g.cols;
    const int p = t.p0 + pr, q = t.q0 + qc;
    if (p >= g.out_h || q >= g.out_w) continue;
    const uint8_t* row = vmax + pr * vmax_row;
    uint4 m;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int jx = min(max(x0 + 2 * qc + dx, 0), g.w - 1) - x0;
      const uint4 v = *reinterpret_cast<const uint4*>(
          row + (jx * kCout + 8 * (half ^ (jx / 4 % 2))) * 2);
      if (dx == 0) {
        m = v;
      } else {
        __nv_bfloat162* mm = reinterpret_cast<__nv_bfloat162*>(&m);
        const __nv_bfloat162* vv =
            reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) mm[k] = __hmax2(mm[k], vv[k]);
      }
    }
    const __nv_bfloat16* pooled = reinterpret_cast<const __nv_bfloat16*>(&m);
    uint4 o;
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ob[k] = __float2bfloat16_rn(__bfloat162float(pooled[k]) + bias_f[k]);
    }
    const size_t offset =
        ((static_cast<size_t>(t.n) * g.out_h + p) * g.out_w + q) * kCout +
        8 * half;
    *reinterpret_cast<uint4*>(out + offset) = o;
  }
}

}  // namespace

// Launches on `stream` and returns a cudaError_t as an int (0 = ok).
// Pointers are device pointers to contiguous arrays: frames uint8
// [n, h, w, 3], the packed weight bf16 [32, 16] (conv_pool_cuda.
// pack_weight), bias bf16 [16], and the output bf16
// [n, ceil(h/2), ceil(w/2), 16]. The geometry: `rows` pooled rows per
// band, `cols` pooled columns per tile, `threads` per block and
// `smem_bytes` of dynamic shared memory, which must equal what the others
// imply. A geometry this kernel cannot run returns cudaErrorInvalidValue
// and launches nothing.
extern "C" int conv_pool_launch(const void* frames, const void* wpack,
                                const void* bias, void* out, int n, int h,
                                int w, int rows, int cols, int threads,
                                int smem_bytes, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || rows <= 0 || rows > kMaxRows ||
      cols <= 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = make_geometry(h, w, rows, cols);
  // Every 16-byte chunk of a staged row and every six window elements of
  // a row need a thread of their own in one pass.
  if (smem_bytes != g.smem_bytes || threads < g.raw_stride / 16 ||
      threads < g.win_stride / 6 ||
      smem_bytes > kMaxSharedBytes - kMaxInRows * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      static_cast<long long>(n) * g.row_bands * g.col_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Above 48 KB a block's dynamic shared memory must be allowed first, on
  // each device.
  static int allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_bytes > 48 * 1024 && smem_bytes > allowed[device]) {
    err = cudaFuncSetAttribute(conv_pool_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = smem_bytes;
  }
  conv_pool_kernel<<<static_cast<int>(blocks), threads, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames),
      static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}
