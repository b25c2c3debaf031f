// The fused NeRF point MLP on raw points: forward, sigma-only forward and
// the weight-gradient backward.
//
//   mlp_fwd    replaces the forward of fused_nerf_mlp
//              (nerf_pl_tpu/ops/fused_mlp.py, _fused_fwd_call, body
//              _fwd_kernel): (P, 8) raw points and directions -> (P, 8)
//              [rgb (3) after the sigmoid, raw sigma, 0, 0, 0, 0].
//   sigma_fwd  replaces nerf_sigma_fused (same file, body _sigma_kernel):
//              (P, 8) raw points -> raw sigma (P,).
//   mlp_bwd    replaces the backward of fused_nerf_mlp (_fused_bwd, body
//              _bwd_kernel): the weight gradients for a per-point cotangent
//              g (P, 8) = [d rgb (3), d raw sigma, ...], in three launches:
//                A'  mlp_bwd    per tile, the forward again, keeping every
//                               bf16 activation in the scratch; the rgb
//                               head's cotangent g c (1 - c) from the f32
//                               recomputed rgb c; then mlp_grad.cuh's
//                               data-gradient chain;
//                B, C           mlp_grad.cuh's wgrad and ordered sums.
//              The points get no gradients (the TPU kernel returns zeros).
//
// A block takes PPB = 4 tiles of consecutive points and runs nerf_mlp.cuh's
// tile on each, its inputs loaded from rows of p8 / d8
// (build_point_inputs) instead of built from o + d z. A ragged P is masked:
// rows past P are zero inputs whose outputs are never written and whose
// cotangents are zero, so they add exactly nothing to any gradient sum.
// (The JAX wrapper pads P to its tile with zero points instead and slices
// them off, so their cotangents are zero there too.)
//
// What bounds them: tensor-core work, 1.19 MFLOP per point forward (0.98
// for sigma only) and 2.94x that for the backward. Device memory sees the
// points and outputs (~32 bytes a point each way) and, for mlp_bwd, ~10 KB
// of bf16 scratch per point, written by A' and read by B, as in
// mse_render.
//
// Launch contract: the caller's stream, no allocation (mlp_bwd takes a
// workspace of nerf_mlp_workspace_bytes(P)), and the entry points return
// the first CUDA error of their launches.
#include <cuda_runtime.h>

#include "mlp_grad.cuh"

namespace nerf {

constexpr int PPB = 4 * TP;     // points per block

inline int point_blocks(int P) { return (P + PPB - 1) / PPB; }

// The render kernels' shared memory for one "ray" of TP samples (its ray
// and depth regions go unused), plus mlp_bwd's TP x 4 head cotangents.
struct PointLayout {
  SmemLayout base;
  size_t dzr, total;
  __host__ __device__ explicit PointLayout(bool full) : base(TP, 1, full) {
    dzr = base.total;
    total = dzr + align128(sizeof(float) * TP * 4);
  }
};

// FULL: out (P, 8) = [rgb, raw sigma, 0, 0, 0, 0]; else out (P,) raw sigma.
template <bool FULL>
__global__ void __launch_bounds__(NTHREADS, 2)
point_fwd_kernel(const float* __restrict__ p8, const float* __restrict__ d8,
                 int P, MlpWeights p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = smem_at(smem_raw, PointLayout(FULL).base);
  const int p0 = blockIdx.x * PPB;
  const int end = min(P, p0 + PPB);
  for (int t0 = p0; t0 < end; t0 += TP) {
    const int nv = min(TP, end - t0);
    build_point_inputs<FULL>(sm, p8, d8, t0, end);
    __syncthreads();
    mlp_tile<FULL>(p, sm, sm.sig, sm.rgb, nv);
    __syncthreads();
    if constexpr (FULL) {
      for (int i = threadIdx.x; i < nv * 8; i += NTHREADS) {
        const int r = i >> 3, c = i & 7;
        out[(size_t)t0 * 8 + i] =
            c < 3 ? sm.rgb[r * 3 + c] : (c == 3 ? sm.sig[r] : 0.f);
      }
    } else {
      for (int i = threadIdx.x; i < nv; i += NTHREADS)
        out[(size_t)t0 + i] = sm.sig[i];
    }
  }
}

struct PointGradArgs : GradArgs {
  const float* p8;
  const float* d8;
  const float* g8;          // (P, 8): d rgb in cols 0..2, d raw sigma col 3
  int P;
  float* bias_part;         // (gridDim.x, NBIAS)
};

__global__ void __launch_bounds__(NTHREADS, 2)
mlp_bwd_kernel(PointGradArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const PointLayout L(true);
  const Smem sm = smem_at(smem_raw, L.base);
  float* dzr = reinterpret_cast<float*>(smem_raw + L.dzr);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PPB;
  const int end = min(a.P, p0 + PPB);
  float* bias = a.bias_part + (size_t)blockIdx.x * NBIAS;
  for (int i = tid; i < NBIAS; i += NTHREADS) bias[i] = 0.f;
  __syncthreads();

  for (int t0 = p0; t0 < end; t0 += TP) {
    const int nv = min(TP, end - t0);
    const size_t g0 = t0;
    build_point_inputs<true>(sm, a.p8, a.d8, t0, end);
    __syncthreads();
    copy_rows(sm.x, LDX, a.s.x + g0 * KX, KX, nv);
    copy_rows(sm.d, LDD, a.s.d + g0 * KD, KD, nv);
    const ActSink keep{a.s.act + g0 * W, a.s.P * W, a.s.feat + g0 * W,
                       a.s.hd + g0 * WD};
    mlp_tile<true, true>(a.p, sm, sm.sig, sm.rgb, nv, &keep);
    __syncthreads();
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, gs = 0.f;
    if (tid < nv) {
      const float* g = a.g8 + (g0 + tid) * 8;
      const float* c = sm.rgb + tid * 3;
      v0 = g[0] * c[0] * (1.f - c[0]);
      v1 = g[1] * c[1] * (1.f - c[1]);
      v2 = g[2] * c[2] * (1.f - c[2]);
      gs = g[3];
    }
    backward_from_heads(a, sm, dzr, v0, v1, v2, gs, nv, g0, bias);
    __syncthreads();
  }
}

template <bool FULL>
int launch_fwd(const void* p8, const void* d8, int P, const MlpWeights& p,
               void* out, void* stream) {
  if (P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = PointLayout(FULL).base.total;
  cudaError_t err = cudaFuncSetAttribute(
      point_fwd_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  point_fwd_kernel<FULL><<<point_blocks(P), NTHREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p8), static_cast<const float*>(d8), P, p,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nerf

extern "C" {

int nerf_mlp_fwd(const void* p8, const void* d8, int P, const void* w0,
                 const void* wt, const void* wsk, const void* bt,
                 const void* ws, const void* bs, const void* wf,
                 const void* bf, const void* wdf, const void* wdd,
                 const void* bd, const void* wr, const void* br, void* out8,
                 void* stream) {
  const nerf::MlpWeights p = nerf::weights_at(w0, wt, wsk, bt, ws, bs, wf,
                                              bf, wdf, wdd, bd, wr, br);
  return nerf::launch_fwd<true>(p8, d8, P, p, out8, stream);
}

int nerf_sigma_fwd(const void* p8, int P, const void* w0, const void* wt,
                   const void* wsk, const void* bt, const void* ws,
                   const void* bs, void* sigma, void* stream) {
  const nerf::MlpWeights p = nerf::weights_at(
      w0, wt, wsk, bt, ws, bs, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr);
  return nerf::launch_fwd<false>(p8, nullptr, P, p, sigma, stream);
}

long long nerf_mlp_workspace_bytes(int P) {
  return static_cast<long long>(
      nerf::Workspace(P, nerf::point_blocks(P)).total);
}

int nerf_mlp_bwd(const void* p8, const void* d8, const void* g8, int P,
                 const void* w0, const void* wt, const void* wsk,
                 const void* bt, const void* ws, const void* bs,
                 const void* wf, const void* bf, const void* wdf,
                 const void* wdd, const void* bd, const void* wr,
                 const void* br, const void* wdfT, const void* wfT,
                 const void* wtT, void* workspace, void* grad,
                 void* stream) {
  using namespace nerf;
  if (P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace wsp(P, point_blocks(P));
  unsigned char* base = static_cast<unsigned char*>(workspace);
  PointGradArgs a{};
  a.p = weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br);
  a.wdfT = static_cast<const bf16*>(wdfT);
  a.wfT = static_cast<const bf16*>(wfT);
  a.wtT = static_cast<const bf16*>(wtT);
  a.s = scratch_at(base, wsp.P);
  a.p8 = static_cast<const float*>(p8);
  a.d8 = static_cast<const float*>(d8);
  a.g8 = static_cast<const float*>(g8);
  a.P = P;
  a.bias_part = reinterpret_cast<float*>(base + wsp.bias);

  const PointLayout L(true);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_bwd_kernel<<<wsp.grid_a, NTHREADS, L.total, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(
      a.s, wsp, base, a.bias_part, static_cast<float*>(grad), st));
}

}  // extern "C"
