// Fused V-trace for Hopper (sm_90a): one kernel, no intermediate in
// device memory.
//
// Replaces the Pallas TPU kernel scalable_agent_tpu/ops/vtrace_pallas.py
// `_vtrace_kernel` (driven by its `from_importance_weights`, and per
// shard by `sharded_from_importance_weights`). It computes all of V-trace
// on time-major [T, N] float32 inputs, N being the product of the
// trailing dims:
//
//   rho_t   = exp(log_rho_t)
//   delta_t = min(rho_bar, rho_t) * (r_t + gamma_t * V_{t+1} - V_t)
//   acc_t   = delta_t + gamma_t * min(1, rho_t) * acc_{t+1}
//   vs_t    = acc_t + V_t
//   pg_t    = min(pg_rho_bar, rho_t) * (r_t + gamma_t * vs_{t+1} - V_t)
//
// with V_T = vs_T = bootstrap. A threshold of +inf means "no clipping".
//
// What bounds it on this card. The kernel reads 4*T*N + N floats and
// writes 2*T*N, once each: at the learner's shape (T=100, N=32) 77 KB,
// 0.02 us at 3.35 TB/s. The real floor is the launch latency, one round
// trip to bring the columns in, and the T-step dependent chain of acc
// (one multiply and one add per step). The first form of this kernel
// walked t = T-1 ... 0 straight out of global memory, one thread per
// column: each of the 100 steps waited on its own loads (~200 ns a step,
// ~20 us in all).
//
// Design. A block owns `cols` neighbouring columns and walks time in
// chunks of `chunk` steps from the end (t = T-1 downward):
//   1. Stage. All threads copy the chunk's rows of the four [T, N] inputs
//      into shared memory with cp.async: 16-byte copies where a row's
//      piece is 16-byte aligned, 4-byte copies otherwise (odd N, narrow
//      blocks). With two stages the next chunk (earlier times) is in
//      flight while this one is walked.
//   2. Pre-pass. All threads compute, in parallel over the chunk, what
//      does not wait on acc: rho, c_t = gamma min(1, rho) and delta (the
//      last row's delta needs V from the chunk after it in time, which
//      the walker holds).
//   3. Walk. One thread per column runs acc_t = delta_t + c_t acc_{t+1}
//      out of shared memory (two loads, a multiply, an add and a store
//      per step), keeping acc, V and vs across chunks in registers; the
//      loads of each 8 steps are issued one block ahead.
//   4. Post-pass. All threads compute vs_t = acc_t + V_t and pg_t from
//      vs_{t+1}, in parallel.
//   5. Store. All threads write the chunk's vs and pg rows back: 16-byte
//      stores where aligned, 4-byte ones otherwise.
// The walk stays serial in t: a parallel scan would reorder the sums, and
// at T=100 the chain is already shorter than the launch. The launch
// geometry (cols, chunk, stages, threads, shared bytes) is chosen in
// Python (ops/vtrace_cuda.py launch_geometry) and checked here.
//
// The arithmetic is the plain twin's (ops/vtrace_cuda.py), operation by
// operation: products and sums go through __fmul_rn/__fadd_rn/__fsub_rn,
// which the compiler does not contract into FMAs, so each rounds where the
// twin's separate PyTorch ops round, and the results are bit-equal. The
// minimum keeps NaN the way torch.clamp and jnp.minimum do:
// `x > hi ? hi : x` returns x when x is NaN, where fminf would return hi.

#include <cuda_runtime.h>

#include <cstdint>

// Phases compiled out, by bit (1 stage, 2 pre-pass, 4 walk, 8 post-pass,
// 16 store): 0 but for scripts/kernel_phases.py, which times the kernel
// without each phase in turn. The results are then wrong.
#ifndef SKIP_PHASES
#define SKIP_PHASES 0
#endif

namespace {

constexpr unsigned kSkip = SKIP_PHASES;

constexpr int kInputs = 4;   // log_rhos, discounts, rewards, values
constexpr int kOutputs = 2;  // vs, pg_advantages
constexpr int kMaxSharedBytes = 232448;
constexpr int kMaxThreads = 512;
// Rows of the serial walk whose loads are issued together, one block
// ahead of their part of the chain.
constexpr int kWalkBlock = 8;

__device__ __forceinline__ float min_keep_nan(float x, float hi) {
  return x > hi ? hi : x;
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct Args {
  const float* in[kInputs];
  const float* bootstrap;
  float* out[kOutputs];
  int t_len, n_cols;
  float clip_rho, clip_pg_rho;
  int chunk, stages;
};

// Rows [t0, t0 + rows) of this block's columns [c0, c0 + width) of the
// four inputs -> buf[a][row][col] (row stride kCols floats). Thread i
// copies 4-column group i % (kCols / 4) of every (threads / (kCols / 4))-th
// row.
template <int kCols>
__device__ void stage_chunk(const Args& args, float* buf, int t0, int rows,
                            int c0, int width) {
  const int groups = kCols / 4;
  const int g = threadIdx.x % groups;
  const int step = blockDim.x / groups;
  if (4 * g >= width || (kSkip & 1)) return;
#pragma unroll
  for (int a = 0; a < kInputs; ++a) {
    const float* in = args.in[a] + static_cast<size_t>(t0) * args.n_cols + c0;
    float* dst_a = buf + a * args.chunk * kCols;
    for (int row = threadIdx.x / groups; row < rows; row += step) {
      const float* src = in + static_cast<size_t>(row) * args.n_cols + 4 * g;
      float* dst = dst_a + row * kCols + 4 * g;
      if (4 * g + 4 <= width && aligned16(src)) {
        cp_async_16(dst, src);
      } else {
        for (int k = 0; k < 4 && 4 * g + k < width; ++k) {
          cp_async_4(dst + k, src + k);
        }
      }
    }
  }
}

// out[o][row][col] of rows [t0, t0 + rows) -> the global outputs.
template <int kCols>
__device__ void store_chunk(const Args& args, const float* out, int t0,
                            int rows, int c0, int width) {
  const int groups = kCols / 4;
  const int g = threadIdx.x % groups;
  const int step = blockDim.x / groups;
  if (4 * g >= width || (kSkip & 16)) return;
#pragma unroll
  for (int o = 0; o < kOutputs; ++o) {
    float* dst_o = args.out[o] + static_cast<size_t>(t0) * args.n_cols + c0;
    const float* src_o = out + o * args.chunk * kCols;
    for (int row = threadIdx.x / groups; row < rows; row += step) {
      float* dst = dst_o + static_cast<size_t>(row) * args.n_cols + 4 * g;
      const float* src = src_o + row * kCols + 4 * g;
      if (4 * g + 4 <= width && aligned16(dst)) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int k = 0; k < 4 && 4 * g + k < width; ++k) dst[k] = src[k];
      }
    }
  }
}

// kCols: the block's columns (4, 8, 16 or 32), a compile-time row stride
// of the shared planes.
template <int kCols>
__global__ void __launch_bounds__(kMaxThreads) vtrace_kernel(const Args args) {
  extern __shared__ __align__(16) float smem[];
  const int plane = args.chunk * kCols;  // floats of one [chunk, cols]
  const int stage_floats = kInputs * plane;
  float* out = smem + args.stages * stage_floats;

  const int c0 = blockIdx.x * kCols;
  const int width = min(kCols, args.n_cols - c0);
  // The pre- and post-pass map thread i to column i % cols and every
  // (threads / cols)-th row from i / cols; the walk to column i.
  const int col = threadIdx.x % kCols;
  const int row_step = blockDim.x / kCols;
  const int c = threadIdx.x;
  const bool walker = c < width;
  const int n_chunks = (args.t_len + args.chunk - 1) / args.chunk;
  // Chunk k holds times [t_hi(k) - rows(k), t_hi(k)), t_hi(k) = T - k*chunk.
  auto chunk_rows = [&](int k) {
    return min(args.chunk, args.t_len - k * args.chunk);
  };
  auto chunk_t0 = [&](int k) {
    return args.t_len - k * args.chunk - chunk_rows(k);
  };

  // Prologue: chunks 0 .. stages-2 in flight.
  for (int k = 0; k < args.stages - 1 && k < n_chunks; ++k) {
    stage_chunk<kCols>(args, smem + k * stage_floats, chunk_t0(k),
                       chunk_rows(k), c0, width);
    cp_async_commit();
  }

  float boot = 0.0f;
  if (walker) boot = args.bootstrap[c0 + c];
  float acc = 0.0f;
  float v_next = boot;   // V at the first time after this chunk
  float vs_next = boot;  // vs at the first time after this chunk

  for (int k = 0; k < n_chunks; ++k) {
    // Issue chunk k + stages - 1 (into the buffer chunk k - 1 used, which
    // every thread finished reading by the barrier after its post-pass), and
    // always commit a group, so that "all but stages - 1 groups done"
    // means chunk k has landed.
    const int next = k + args.stages - 1;
    if (next < n_chunks) {
      stage_chunk<kCols>(args, smem + (next % args.stages) * stage_floats,
                         chunk_t0(next), chunk_rows(next), c0, width);
    }
    cp_async_commit();
    if (args.stages == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int rows = chunk_rows(k);
    float* buf = smem + (k % args.stages) * stage_floats;
    float* deltas = buf;  // log_rhos, then delta, then acc
    const float* discounts = buf + plane;
    const float* rewards = buf + 2 * plane;
    const float* values = buf + 3 * plane;
    float* vs = out;          // c_t, then vs
    float* pg = out + plane;  // rho, then pg

    // Pre-pass: rho, c_t = gamma min(1, rho) and delta_t = min(rho_bar,
    // rho) (r + gamma V_{t+1} - V_t) of every row but the last, whose
    // V_{t+1} the walker holds.
    if (col < width && !(kSkip & 2)) {
      for (int row = threadIdx.x / kCols; row < rows; row += row_step) {
        const int j = row * kCols + col;
        const float rho = expf(deltas[j]);
        const float gamma = discounts[j];
        pg[j] = rho;
        vs[j] = __fmul_rn(gamma, min_keep_nan(rho, 1.0f));
        if (row + 1 < rows) {
          deltas[j] = __fmul_rn(
              min_keep_nan(rho, args.clip_rho),
              __fsub_rn(__fadd_rn(rewards[j],
                                  __fmul_rn(gamma, values[j + kCols])),
                        values[j]));
        }
      }
    }
    __syncthreads();

    // Walk, one thread per column: acc_t = delta_t + c_t acc_{t+1}, into
    // the delta plane; the post-pass forms vs_t = acc_t + V_t.
    float pg_top = 0.0f;
    if (walker && !(kSkip & 4)) {
      const int top = (rows - 1) * kCols + c;
      const float rho = pg[top], gamma = discounts[top], v = values[top];
      const float r = rewards[top];
      const float delta_top = __fmul_rn(
          min_keep_nan(rho, args.clip_rho),
          __fsub_rn(__fadd_rn(r, __fmul_rn(gamma, v_next)), v));
      // pg_t = min(pg_rho_bar, rho) * (r + gamma * vs_{t+1} - V_t)
      pg_top = __fmul_rn(
          min_keep_nan(rho, args.clip_pg_rho),
          __fsub_rn(__fadd_rn(r, __fmul_rn(gamma, vs_next)), v));
      acc = __fadd_rn(delta_top, __fmul_rn(vs[top], acc));
      deltas[top] = acc;
      // The first (rows - 1) % 8 steps one by one, then whole blocks of 8
      // rows, each loaded into registers one block earlier: the loads of
      // the next block are issued before this block's part of the chain
      // (and before its stores, which reach only rows already loaded), and
      // no step of a block is guarded.
      int row = rows - 2;
      for (; row >= 0 && (row + 1) % kWalkBlock != 0; --row) {
        const int j = row * kCols + c;
        acc = __fadd_rn(deltas[j], __fmul_rn(vs[j], acc));
        deltas[j] = acc;
      }
      float d[kWalkBlock], cc[kWalkBlock];
      auto load = [&](int hi) {
#pragma unroll
        for (int s = 0; s < kWalkBlock; ++s) {
          const int j = (hi - s) * kCols + c;
          d[s] = deltas[j];
          cc[s] = vs[j];
        }
      };
      if (row >= 0) load(row);
      for (int hi = row; hi >= 0; hi -= kWalkBlock) {
        float cd[kWalkBlock], ccc[kWalkBlock];
#pragma unroll
        for (int s = 0; s < kWalkBlock; ++s) {
          cd[s] = d[s];
          ccc[s] = cc[s];
        }
        if (hi >= kWalkBlock) load(hi - kWalkBlock);
        float* acc_row = deltas + hi * kCols + c;
#pragma unroll
        for (int s = 0; s < kWalkBlock; ++s) {
          acc = __fadd_rn(cd[s], __fmul_rn(ccc[s], acc));
          acc_row[-s * kCols] = acc;
        }
      }
      // What the next chunk (earlier in time) needs: V and vs at row 0.
      v_next = values[c];
      vs_next = __fadd_rn(acc, v_next);
    }
    if (walker) pg[(rows - 1) * kCols + c] = pg_top;
    __syncthreads();

    // Post-pass: vs_t = acc_t + V_t of every row, and pg of every row but
    // the last, from vs_{t+1} (formed again from acc_{t+1}, the same add).
    if (col < width && !(kSkip & 8)) {
      for (int row = threadIdx.x / kCols; row < rows; row += row_step) {
        const int j = row * kCols + col;
        vs[j] = __fadd_rn(deltas[j], values[j]);
        if (row + 1 < rows) {
          const float vs_t1 = __fadd_rn(deltas[j + kCols], values[j + kCols]);
          pg[j] = __fmul_rn(
              min_keep_nan(pg[j], args.clip_pg_rho),
              __fsub_rn(__fadd_rn(rewards[j], __fmul_rn(discounts[j], vs_t1)),
                        values[j]));
        }
      }
    }
    __syncthreads();
    store_chunk<kCols>(args, out, chunk_t0(k), rows, c0, width);
  }
}

}  // namespace

// The dynamic shared memory a launch of this geometry needs: `stages`
// buffers of the four inputs and one of the two outputs, chunk x cols
// floats each. ops/vtrace_cuda.py launch_geometry computes the same.
static long long shared_bytes(int cols, int chunk, int stages) {
  return 4LL * (stages * kInputs + kOutputs) * chunk * cols;
}

// Launches on `stream` and returns a cudaError_t as an int (0 = ok).
// Pointers are device pointers to contiguous float32 arrays: five inputs
// of [t_len, n_cols] (bootstrap: [n_cols]) and two outputs of
// [t_len, n_cols]. The geometry: `cols` columns per block (a multiple of
// 4 that divides `threads`), time chunks of `chunk` steps, `stages` (1 or 2)
// input buffers, `threads` per block and `smem_bytes` of dynamic shared
// memory, which must equal what the other four imply. A geometry this
// kernel cannot run returns cudaErrorInvalidValue and launches nothing.
extern "C" int vtrace_launch(const void* log_rhos, const void* discounts,
                             const void* rewards, const void* values,
                             const void* bootstrap, void* vs,
                             void* pg_advantages, int t_len, int n_cols,
                             float clip_rho, float clip_pg_rho, int cols,
                             int chunk, int stages, int threads,
                             int smem_bytes, void* stream) {
  if (n_cols <= 0 || t_len <= 0) return 0;
  if ((cols != 4 && cols != 8 && cols != 16 && cols != 32) ||
      threads % cols != 0 ||
      threads % 32 != 0 || threads > kMaxThreads || chunk <= 0 ||
      stages < 1 || stages > 2 ||
      smem_bytes != shared_bytes(cols, chunk, stages) ||
      smem_bytes > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Above 48 KB a block's dynamic shared memory must be allowed first, on
  // each device, for each of the four kernels.
  static int allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_bytes > 48 * 1024 && smem_bytes > allowed[device]) {
    const void* kernels[] = {
        reinterpret_cast<const void*>(vtrace_kernel<4>),
        reinterpret_cast<const void*>(vtrace_kernel<8>),
        reinterpret_cast<const void*>(vtrace_kernel<16>),
        reinterpret_cast<const void*>(vtrace_kernel<32>)};
    for (const void* kernel : kernels) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    allowed[device] = smem_bytes;
  }
  Args args;
  args.in[0] = static_cast<const float*>(log_rhos);
  args.in[1] = static_cast<const float*>(discounts);
  args.in[2] = static_cast<const float*>(rewards);
  args.in[3] = static_cast<const float*>(values);
  args.bootstrap = static_cast<const float*>(bootstrap);
  args.out[0] = static_cast<float*>(vs);
  args.out[1] = static_cast<float*>(pg_advantages);
  args.t_len = t_len;
  args.n_cols = n_cols;
  args.clip_rho = clip_rho;
  args.clip_pg_rho = clip_pg_rho;
  args.chunk = chunk;
  args.stages = stages;
  const int blocks = (n_cols + cols - 1) / cols;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 4: vtrace_kernel<4><<<blocks, threads, smem_bytes, s>>>(args); break;
    case 8: vtrace_kernel<8><<<blocks, threads, smem_bytes, s>>>(args); break;
    case 16: vtrace_kernel<16><<<blocks, threads, smem_bytes, s>>>(args); break;
    default: vtrace_kernel<32><<<blocks, threads, smem_bytes, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
