// The backward of a bf16 ReLU layer and its bias gradient in one pass: g =
// grad where y > 0 and 0 elsewhere, and db = the column sums of g in
// float32, for each hidden layer of mip-NeRF 360's two MLPs
// (nerf_pl_tpu_torch/models/mipnerf360.py's _DenseReLU, through
// nerf_pl_tpu_torch/ops/relu_bgrad.py). This source ports no TPU kernel:
// the JAX package has no mip-NeRF 360, and in PyTorch the layer's backward
// was two passes, threshold_backward(grad, y, 0) and then g.sum(0), which
// read g a second time. The rule is threshold_backward's (0 where y <= 0,
// grad elsewhere, so a NaN in y passes grad), so g has its bits.
//
// The bound is bytes: 6 bytes a value (grad and y read, g written). A
// 16,384-ray step of the mip-NeRF 360 cell holds 6,509,559,808 values in
// its 17 ReLU layers (524,288 points x 1024 columns in 8 NeRF layers,
// x 128 in the view layer, 2,097,152 x 256 in 4 proposal layers at both
// levels): 39,057 MB, 11.66 ms at 3.35 TB/s.
//
// Each thread owns 8 consecutive columns (the element-wise path: one),
// so a row costs it one 16-byte load of grad, one of y and one 16-byte
// store of g, and its 8 column sums stay in float32 registers while it
// walks the rows, ROWS_IN_FLIGHT of them loaded before any is used. A
// block's threads take `lanes` rows side by side; the grid is the blocks
// the SMs hold at once (the occupancy API's count times the SMs), so one
// wave walks all rows. Each block sums its lanes in shared memory in a
// fixed order and writes one float32 row of partial sums; a second launch
// sums the partial rows per column, in a fixed order too. Nothing is
// added atomically, so two launches give the same bits. grad may be a
// view with a row stride of its own (layer 4's gradient is the first 1024
// columns of layer 5's 1096-wide input gradient) and is read where it
// lies. A width, a row stride or an address that is not a multiple of 8
// values (16 bytes) takes the element-wise path.

#include <cuda_runtime.h>

#include <cstdint>

namespace nerf {
namespace relu_bgrad {

constexpr int THREADS = 256;
constexpr int ROWS_IN_FLIGHT = 4;
constexpr int SUM_COLS = 32;      // columns a block of the partials' sum
constexpr int SUM_GROUPS = 32;    // takes, and its threads a column

// A bf16 held in the high or the low half of a 32-bit word, as a float.
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}

// Two bf16 of grad and y (the first in the low half): grad where y > 0 or
// y is NaN, else +0, and both kept values added to their column sums.
__device__ __forceinline__ uint32_t mask_pair(uint32_t gw, uint32_t yw,
                                              float& s0, float& s1) {
  const uint32_t keep = (lo_f(yw) <= 0.0f ? 0u : 0x0000ffffu) |
                        (hi_f(yw) <= 0.0f ? 0u : 0xffff0000u);
  const uint32_t o = gw & keep;
  s0 += lo_f(o);
  s1 += hi_f(o);
  return o;
}

// V consecutive bf16 of one row: 8 in one 16-byte word, or 1.
template <int V>
struct Row;

template <>
struct Row<8> {
  uint4 v;
  __device__ __forceinline__ void load(const uint16_t* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void store(uint16_t* p) const {
    *reinterpret_cast<uint4*>(p) = v;
  }
  __device__ __forceinline__ void mask(const Row& y, float* s) {
    v.x = mask_pair(v.x, y.v.x, s[0], s[1]);
    v.y = mask_pair(v.y, y.v.y, s[2], s[3]);
    v.z = mask_pair(v.z, y.v.z, s[4], s[5]);
    v.w = mask_pair(v.w, y.v.w, s[6], s[7]);
  }
};

template <>
struct Row<1> {
  uint16_t v;
  __device__ __forceinline__ void load(const uint16_t* p) { v = __ldg(p); }
  __device__ __forceinline__ void store(uint16_t* p) const { *p = v; }
  __device__ __forceinline__ void mask(const Row& y, float* s) {
    const uint32_t o = lo_f(y.v) <= 0.0f ? 0u : v;
    s[0] += lo_f(o);
    v = static_cast<uint16_t>(o);
  }
};

// How a launch's threads cover the columns: `tile` chunks of V columns a
// row lane, `lanes` rows a block side by side, `col_tiles` blocks across
// the columns (more than one only past 256 chunks).
struct Layout {
  int tile, lanes, col_tiles;
};

__host__ __device__ inline Layout layout_of(int cols, int vec) {
  const int chunks = (cols + vec - 1) / vec;
  const int tile = chunks < THREADS ? chunks : THREADS;
  return {tile, THREADS / tile, (chunks + tile - 1) / tile};
}

// Block (x, y) walks rows x * lanes + lane, stepping gridDim.x * lanes, over
// column tile y, and writes row x of `partial` (blocks x cols floats) for
// its columns.
template <int V>
__global__ void __launch_bounds__(THREADS)
    relu_bgrad_kernel(const uint16_t* __restrict__ grad, long long ld,
                      const uint16_t* __restrict__ y,
                      uint16_t* __restrict__ g, float* __restrict__ partial,
                      long long rows, int cols) {
  __shared__ float s_sum[V][THREADS];
  const Layout L = layout_of(cols, V);
  const int c = threadIdx.x % L.tile;
  const int lane = threadIdx.x / L.tile;
  const long long col = (static_cast<long long>(blockIdx.y) * L.tile + c) * V;
  const bool active = lane < L.lanes && col < cols;
  float sum[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sum[k] = 0.0f;
  if (active) {
    const long long step = static_cast<long long>(gridDim.x) * L.lanes;
    for (long long r = static_cast<long long>(blockIdx.x) * L.lanes + lane;
         r < rows; r += ROWS_IN_FLIGHT * step) {
      Row<V> gr[ROWS_IN_FLIGHT], yr[ROWS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const long long ru = r + u * step;
        if (ru < rows) {
          gr[u].load(grad + ru * ld + col);
          yr[u].load(y + ru * cols + col);
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const long long ru = r + u * step;
        if (ru < rows) {
          gr[u].mask(yr[u], sum);
          gr[u].store(g + ru * cols + col);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) s_sum[k][threadIdx.x] = sum[k];
  __syncthreads();
  if (lane == 0 && active) {
    float* out = partial + static_cast<long long>(blockIdx.x) * cols + col;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t = s_sum[k][c];
      for (int l = 1; l < L.lanes; ++l) t += s_sum[k][l * L.tile + c];
      out[k] = t;
    }
  }
}

// db[col] = the sum of partial[b][col] over b = 0 .. blocks - 1: thread
// group j sums rows j, j + SUM_GROUPS, ... in order, then the groups' sums
// are added in order.
__global__ void __launch_bounds__(SUM_COLS* SUM_GROUPS)
    relu_bgrad_sum_kernel(const float* __restrict__ partial, int blocks,
                          int cols, float* __restrict__ db) {
  __shared__ float s_sum[SUM_GROUPS][SUM_COLS + 1];
  const int x = threadIdx.x % SUM_COLS;
  const int j = threadIdx.x / SUM_COLS;
  const int col = blockIdx.x * SUM_COLS + x;
  float acc = 0.0f;
  if (col < cols) {
#pragma unroll 4
    for (int b = j; b < blocks; b += SUM_GROUPS)
      acc += partial[static_cast<long long>(b) * cols + col];
  }
  s_sum[j][x] = acc;
  __syncthreads();
  if (j == 0 && col < cols) {
    float t = s_sum[0][x];
    for (int k = 1; k < SUM_GROUPS; ++k) t += s_sum[k][x];
    db[col] = t;
  }
}

// The blocks a launch's row walk takes: those the SMs hold at once, split
// among the column tiles, and no more than the rows need; < 0 on a CUDA
// error.
int blocks_for(long long rows, int cols, int vec) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        vec == 8 ? relu_bgrad_kernel<8> : relu_bgrad_kernel<1>, THREADS, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const Layout L = layout_of(cols, vec);
  long long n = static_cast<long long>(sms) * per_sm / L.col_tiles;
  const long long need = (rows + L.lanes - 1) / L.lanes;
  if (n > need) n = need;
  return n < 1 ? 1 : static_cast<int>(n);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace relu_bgrad
}  // namespace nerf

extern "C" {

// Blocks (the partial rows) of a launch over rows x cols at vec 8 or 1 on
// the current device; < 0: a CUDA error, negated; 0: bad arguments.
int nerf_relu_bgrad_blocks(long long rows, int cols, int vec) {
  if (rows < 1 || cols < 1 || (vec != 8 && vec != 1)) return 0;
  return nerf::relu_bgrad::blocks_for(rows, cols, vec);
}

// g (rows x cols, contiguous) and db (cols floats) of grad (rows x cols,
// rows `ld` values apart) and y (rows x cols, contiguous), all bf16, through
// `partial` (blocks x cols floats), on `stream`. vec 8 takes 16-byte words:
// cols and ld multiples of 8, every address 16-byte aligned.
int nerf_relu_bgrad(const void* grad, long long ld, const void* y, void* g,
                    void* partial, void* db, long long rows, int cols,
                    int vec, int blocks, void* stream) {
  namespace R = nerf::relu_bgrad;
  if (rows < 1 || cols < 1 || blocks < 1 || ld < cols ||
      (vec != 8 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 8 && (cols % 8 || ld % 8 || !R::aligned16(grad) ||
                   !R::aligned16(y) || !R::aligned16(g)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const R::Layout L = R::layout_of(cols, vec);
  const dim3 grid(blocks, L.col_tiles);
  const auto* gp = static_cast<const uint16_t*>(grad);
  const auto* yp = static_cast<const uint16_t*>(y);
  auto* op = static_cast<uint16_t*>(g);
  auto* pp = static_cast<float*>(partial);
  if (vec == 8)
    R::relu_bgrad_kernel<8><<<grid, R::THREADS, 0, s>>>(gp, ld, yp, op, pp,
                                                        rows, cols);
  else
    R::relu_bgrad_kernel<1><<<grid, R::THREADS, 0, s>>>(gp, ld, yp, op, pp,
                                                        rows, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  R::relu_bgrad_sum_kernel<<<(cols + R::SUM_COLS - 1) / R::SUM_COLS,
                             R::SUM_COLS * R::SUM_GROUPS, 0, s>>>(
      pp, blocks, cols, static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
