// Adam over every leaf of a training step in one launch: optax's
// scale_by_adam followed by scale_by_learning_rate and apply_updates, as
// nerf_pl_tpu_torch/training/optimizers.py's foreach chain computes them,
// operation for operation and rounding for rounding, so the two give the
// same bits; nerf_pl_tpu_torch/ops/adam.py launches it. This source ports
// no TPU kernel: the JAX package leaves optax's chain to XLA, which fuses
// it into the step's program, while in PyTorch the chain is ~14 foreach
// passes over the 48 leaves of the two MLPs, 0.36 ms of a 3.6 ms step, and
// it was added to take their place. Its bound: each parameter reads p, g,
// mu and nu and writes p, mu and nu, 28 bytes a parameter, 33.4 MB for the
// 1,191,688 parameters of the two MLPs, 10 us at 3.35 TB/s.
//
// The leaves travel as one table passed by value (__grid_constant__): for
// each leaf its inputs, its outputs (the inputs themselves for an update
// in place), its rows, columns and the gradient's row stride (a strided
// view of the kernels' gradient buffers is read where it lies) and the
// first block of its range. A block finds its leaf by a binary search of
// those prefix offsets and updates BLOCK_ELEMS consecutive elements of it.
// nvcc contracts a * b + c into one FMA by default, and the chain rounds
// each product and sum: every operation here is an explicitly rounded
// intrinsic. b1^t and b2^t are taken in double from the device count and
// rounded to float, as optimizers.py's _decay_pow. With a clip scale (a
// float32 device scalar: the global-norm clip's factor, which the step
// computes before the launch) every gradient is multiplied by it first, as
// the chain's clipped gradients are; without one the kernel reads none.

#include <cuda_runtime.h>

#include <cstring>

namespace nerf {
namespace adam {

constexpr int MAX_LEAVES = 56;    // the table stays under 4 KB
constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int BLOCK_ELEMS = THREADS * PER_THREAD;

struct Leaf {             // 72 bytes
  const float* p;
  const float* g;
  const float* mu;
  const float* nu;
  float* p_out;
  float* mu_out;
  float* nu_out;
  int rows;
  int cols;
  int g_stride;           // floats between rows of g (cols: contiguous)
  int first_block;        // the prefix offset of the leaf's blocks
};

struct Table {
  const int* count;       // Adam's count, already incremented: t
  const float* lr;        // the learning rate, a float32 device scalar
  const float* clip_scale;  // the gradients' factor, or null: no clip
  float b1, b2;           // the decays, rounded to float
  float one_minus_b1;     // 1 - b1 and 1 - b2 taken in double, then
  float one_minus_b2;     // rounded to float, as torch rounds a scalar
  float eps;
  float weight_decay;
  int decay;              // coupled L2: g + weight_decay * p
  int n_leaves;
  Leaf leaves[MAX_LEAVES];
};
static_assert(sizeof(Leaf) == 72, "the leaf's layout");
static_assert(sizeof(Table) <= 4096, "a classic kernel argument list");

__device__ __forceinline__ long long g_index(const Leaf& L, int e) {
  if (L.g_stride == L.cols) return e;
  return static_cast<long long>(e / L.cols) * L.g_stride + e % L.cols;
}

__global__ void __launch_bounds__(THREADS)
    adam_kernel(const __grid_constant__ Table t) {
  __shared__ float s_corr[2];     // 1 - b1^t, 1 - b2^t
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;   // the last leaf that starts at or
  while (lo < hi) {                  // before this block
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaves[mid].first_block <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& L = t.leaves[lo];
  if (threadIdx.x == 0) {
    const double step = static_cast<double>(*t.count);
    s_corr[0] = __fsub_rn(1.0f, __double2float_rn(
                                    pow(static_cast<double>(t.b1), step)));
    s_corr[1] = __fsub_rn(1.0f, __double2float_rn(
                                    pow(static_cast<double>(t.b2), step)));
  }
  __syncthreads();
  const float corr1 = s_corr[0], corr2 = s_corr[1];
  const float step_size = -*t.lr;
  const bool clip = t.clip_scale != nullptr;
  const float scale = clip ? *t.clip_scale : 1.0f;
  const int n = L.rows * L.cols;
  const int base = (b - L.first_block) * BLOCK_ELEMS + threadIdx.x;

  float p[PER_THREAD], g[PER_THREAD], m[PER_THREAD], v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int e = base + k * THREADS;
    if (e < n) {
      p[k] = L.p[e];
      g[k] = __ldg(L.g + g_index(L, e));
      m[k] = L.mu[e];
      v[k] = L.nu[e];
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int e = base + k * THREADS;
    if (e >= n) continue;
    float gk = g[k];
    if (clip) gk = __fmul_rn(gk, scale);
    if (t.decay) gk = __fadd_rn(gk, __fmul_rn(p[k], t.weight_decay));
    const float mu = __fadd_rn(__fmul_rn(m[k], t.b1),
                               __fmul_rn(gk, t.one_minus_b1));
    const float nu = __fadd_rn(__fmul_rn(v[k], t.b2),
                               __fmul_rn(__fmul_rn(gk, gk), t.one_minus_b2));
    const float mu_hat = __fdiv_rn(mu, corr1);
    const float nu_hat = __fdiv_rn(nu, corr2);
    const float u = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), t.eps));
    L.p_out[e] = __fadd_rn(p[k], __fmul_rn(u, step_size));
    L.mu_out[e] = mu;
    L.nu_out[e] = nu;
  }
}

// Whether the table's prefix offsets give each leaf its blocks, in order,
// and `blocks` in all.
bool layout_ok(const Table& t, int blocks) {
  if (t.count == nullptr || t.lr == nullptr || t.n_leaves < 1 ||
      t.n_leaves > MAX_LEAVES)
    return false;
  long long next = 0;
  for (int i = 0; i < t.n_leaves; ++i) {
    const Leaf& L = t.leaves[i];
    if (L.first_block != next || L.rows < 0 || L.cols < 1 ||
        L.g_stride < L.cols)
      return false;
    const long long n = static_cast<long long>(L.rows) * L.cols;
    if (n > 0x7fffffffLL) return false;
    next += (n + BLOCK_ELEMS - 1) / BLOCK_ELEMS;
  }
  return next == blocks;
}

}  // namespace adam
}  // namespace nerf

extern "C" {

int nerf_adam_table_bytes() {
  return static_cast<int>(sizeof(nerf::adam::Table));
}

int nerf_adam_block_elems() { return nerf::adam::BLOCK_ELEMS; }

// One Adam step over the leaves of `table` (a host copy of a Table) in
// `blocks` blocks on `stream`.
int nerf_adam(const void* table, int blocks, void* stream) {
  nerf::adam::Table t;
  std::memcpy(&t, table, sizeof(t));
  if (!nerf::adam::layout_ok(t, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  nerf::adam::adam_kernel<<<blocks, nerf::adam::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
