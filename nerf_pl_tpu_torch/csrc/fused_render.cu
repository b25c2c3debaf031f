// Fused test-time render kernels: ray -> points -> MLP -> quadrature, with
// only per-ray data crossing device memory.
//
//   sigma_render  replaces fused_sigma_render (nerf_pl_tpu/ops/fused_render.py,
//                 body _sigma_render_kernel): sigma-only trunk + quadrature
//                 -> per-sample weights (R, S) and opacity (R,).
//   render_eval   replaces fused_render_eval (same file, body _render_kernel):
//                 full MLP + quadrature -> rgb (R, 3), depth (R,), opacity (R,).
//
// A block takes rpb = max(1, 256 / S) whole rays, so each ray's quadrature
// stays inside one block. It runs the MLP (nerf_mlp.cuh) over its rpb * S
// points in tiles of TP, keeping raw sigma (and rgb) per point in shared
// memory, then integrates each ray with one warp: an f32 warp scan gives
// the exclusive sum of delta * relu(sigma) (the TPU kernel used a
// triangular matmul at HIGHEST precision only because it had no scan).
// Transmittance is exp(-exclusive sum), without the +1e-10 of
// volume_quadrature, as in the TPU kernels. A ragged R is masked here;
// nothing is padded.
//
// What bounds it: on paper, tensor-core work (~1.2 MFLOP per point for
// the full MLP, ~1.0 for the trunk): device memory sees only rays, z and
// the per-ray outputs (plus weights (R, S) for sigma_render, which
// sample_pdf needs). In practice the per-layer phases of each 64-point
// tile (weight slabs from L2, WMMA fragments from shared memory, the
// epilogue) and the barriers between layers keep the tensor cores far
// from busy; nerf_mlp.cuh streams weights per warp so that the K loop
// itself has no block-wide barrier.
//
// Launch contract: the caller's stream, no allocation, and the entry
// points return cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "nerf_mlp.cuh"

namespace nerf {

template <bool FULL>
__device__ void quadrature(const Smem& sm, int S, int nray, int ray0,
                           int white_back, float* __restrict__ weights_out,
                           float* __restrict__ rgb_out,
                           float* __restrict__ depth_out,
                           float* __restrict__ opacity_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nray; r += NWARPS) {
    const float* ray = sm.rays + r * 8;
    const float dn = sqrtf(__fadd_rn(
        __fadd_rn(__fmul_rn(ray[3], ray[3]), __fmul_rn(ray[4], ray[4])),
        __fmul_rn(ray[5], ray[5])));
    const float* zr = sm.z + r * S;
    const float* sr = sm.sig + r * S;
    float carry = 0.f, op = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      float o = 0.f;
      if (s < S) {
        const float delta = s + 1 < S ? zr[s + 1] - zr[s] : 1e10f;
        o = __fmul_rn(__fmul_rn(delta, dn), fmaxf(sr[s], 0.f));
      }
      float inc = o;                       // inclusive scan over the warp
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += y;
      }
      float exc = __shfl_up_sync(0xffffffffu, inc, 1);
      exc = (lane == 0 ? 0.f : exc) + carry;
      carry += __shfl_sync(0xffffffffu, inc, 31);
      if (s < S) {
        const float w = (1.f - expf(-o)) * expf(-exc);
        op += w;
        if (FULL) {
          const float* c = sm.rgb + (size_t)(r * S + s) * 3;
          c0 += w * c[0];
          c1 += w * c[1];
          c2 += w * c[2];
          dep += w * zr[s];
        } else {
          weights_out[(size_t)(ray0 + r) * S + s] = w;
        }
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      op += __shfl_xor_sync(0xffffffffu, op, m);
      if (FULL) {
        c0 += __shfl_xor_sync(0xffffffffu, c0, m);
        c1 += __shfl_xor_sync(0xffffffffu, c1, m);
        c2 += __shfl_xor_sync(0xffffffffu, c2, m);
        dep += __shfl_xor_sync(0xffffffffu, dep, m);
      }
    }
    if (lane == 0) {
      const size_t g = (size_t)ray0 + r;
      opacity_out[g] = op;
      if (FULL) {
        const float bg = white_back ? 1.f - op : 0.f;
        rgb_out[g * 3 + 0] = c0 + bg;
        rgb_out[g * 3 + 1] = c1 + bg;
        rgb_out[g * 3 + 2] = c2 + bg;
        depth_out[g] = dep;
      }
    }
  }
}

template <bool FULL>
__global__ void __launch_bounds__(NTHREADS, 2)
render_kernel(const float* __restrict__ rays, const float* __restrict__ z,
              int R, int S, int rpb, MlpWeights p, int white_back,
              float* __restrict__ weights_out, float* __restrict__ rgb_out,
              float* __restrict__ depth_out, float* __restrict__ opacity_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SmemLayout L(S, rpb, FULL);
  Smem sm;
  sm.h = reinterpret_cast<bf16*>(smem_raw + L.h);
  sm.x = reinterpret_cast<bf16*>(smem_raw + L.x);
  sm.d = reinterpret_cast<bf16*>(smem_raw + L.d);
  sm.slab = reinterpret_cast<bf16*>(smem_raw + L.slab);
  sm.stage = reinterpret_cast<float*>(smem_raw + L.stage);
  sm.rays = reinterpret_cast<float*>(smem_raw + L.rays);
  sm.z = reinterpret_cast<float*>(smem_raw + L.z);
  sm.sig = reinterpret_cast<float*>(smem_raw + L.sig);
  sm.rgb = reinterpret_cast<float*>(smem_raw + L.rgb);

  const int ray0 = blockIdx.x * rpb;
  const int nray = min(rpb, R - ray0);
  const int P = nray * S;                  // valid points of this block
  for (int i = threadIdx.x; i < rpb * 8; i += NTHREADS)
    sm.rays[i] = i < nray * 8 ? rays[(size_t)ray0 * 8 + i] : 0.f;
  for (int i = threadIdx.x; i < P; i += NTHREADS)
    sm.z[i] = z[(size_t)ray0 * S + i];
  __syncthreads();

  for (int t0 = 0; t0 < P; t0 += TP) {
    build_inputs<FULL>(sm, S, t0, P);
    __syncthreads();
    mlp_tile<FULL>(p, sm, sm.sig + t0, FULL ? sm.rgb + (size_t)t0 * 3 : nullptr,
                   min(TP, P - t0));
    __syncthreads();
  }
  quadrature<FULL>(sm, S, nray, ray0, white_back, weights_out, rgb_out,
                   depth_out, opacity_out);
}

inline int rays_per_block(int S) { return S >= 4 * TP ? 1 : (4 * TP) / S; }

template <bool FULL>
int launch(const void* rays, const void* z, int R, int S, const MlpWeights& p,
           int white_back, void* weights, void* rgb, void* depth,
           void* opacity, void* stream) {
  if (R <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = rays_per_block(S);
  const SmemLayout L(S, rpb, FULL);
  cudaError_t err = cudaFuncSetAttribute(
      render_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (R + rpb - 1) / rpb;
  render_kernel<FULL><<<grid, NTHREADS, L.total,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(z), R, S,
      rpb, p, white_back, static_cast<float*>(weights),
      static_cast<float*>(rgb), static_cast<float*>(depth),
      static_cast<float*>(opacity));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nerf

using nerf::bf16;

extern "C" {

int nerf_sigma_render(const void* rays, const void* z, int R, int S,
                      const void* w0, const void* wt, const void* wsk,
                      const void* bt, const void* ws, const void* bs,
                      void* weights, void* opacity, void* stream) {
  nerf::MlpWeights p{};
  p.w0 = static_cast<const bf16*>(w0);
  p.wt = static_cast<const bf16*>(wt);
  p.wsk = static_cast<const bf16*>(wsk);
  p.bt = static_cast<const float*>(bt);
  p.ws = static_cast<const bf16*>(ws);
  p.bs = static_cast<const float*>(bs);
  return nerf::launch<false>(rays, z, R, S, p, 0, weights, nullptr, nullptr,
                             opacity, stream);
}

int nerf_render_eval(const void* rays, const void* z, int R, int S,
                     const void* w0, const void* wt, const void* wsk,
                     const void* bt, const void* ws, const void* bs,
                     const void* wf, const void* bf, const void* wdf,
                     const void* wdd, const void* bd, const void* wr,
                     const void* br, int white_back, void* rgb, void* depth,
                     void* opacity, void* stream) {
  nerf::MlpWeights p{};
  p.w0 = static_cast<const bf16*>(w0);
  p.wt = static_cast<const bf16*>(wt);
  p.wsk = static_cast<const bf16*>(wsk);
  p.bt = static_cast<const float*>(bt);
  p.ws = static_cast<const bf16*>(ws);
  p.bs = static_cast<const float*>(bs);
  p.wf = static_cast<const bf16*>(wf);
  p.bf = static_cast<const float*>(bf);
  p.wdf = static_cast<const bf16*>(wdf);
  p.wdd = static_cast<const bf16*>(wdd);
  p.bd = static_cast<const float*>(bd);
  p.wr = static_cast<const bf16*>(wr);
  p.br = static_cast<const float*>(br);
  return nerf::launch<true>(rays, z, R, S, p, white_back, nullptr, rgb, depth,
                            opacity, stream);
}

}  // extern "C"
