// Fused test-time render kernels: ray -> points -> MLP -> quadrature, with
// only per-ray data crossing device memory.
//
//   sigma_render  replaces fused_sigma_render (nerf_pl_tpu/ops/fused_render.py,
//                 body _sigma_render_kernel): sigma-only trunk + quadrature
//                 -> per-sample weights (R, S) and opacity (R,).
//   render_eval   replaces fused_render_eval (same file, body _render_kernel):
//                 full MLP + quadrature -> rgb (R, 3), depth (R,),
//                 opacity (R,).
//
// Both keep each ray's quadrature inside one block: a block runs the MLP
// over the points of whole rays, keeping raw sigma (and rgb) per point in
// shared memory, then integrates each ray with one warp: an f32 warp scan
// gives the exclusive sum of delta * relu(sigma) (the TPU kernel used a
// triangular matmul at HIGHEST precision only because it had no scan).
// Transmittance is exp(-exclusive sum), without the +1e-10 of
// volume_quadrature, as in the TPU kernels. A ragged R is masked here;
// nothing is padded.
//
// render_eval is train_fwd (fused_train.cu's fwd_quad_kernel) with no
// sigma noise and no (R, S) weights written: ray_tile.cuh's blocks of rays
// on mlp_wgmma.cuh's forward tile loop (128-point tiles on wgmma
// m64n256k16, 32 KB weight slabs that one TMA producer warpgroup streams
// to two consumer warpgroups), then quad_forward with a null noise. The
// eval quadrature is _quadrature_tile, the same expressions as
// _quad_forward at noise 0, so render_eval's rgb, depth and opacity equal
// train_fwd's out8[:, 0:5] on a zero noise tensor bit for bit. Its grid
// is persistent: min(groups, WAVE = 132) blocks, each walking groups g =
// blockIdx.x, + gridDim.x, ... of rpb rays, so a block initialises its
// barriers and bias copy once and its producer streams the next group's
// slabs while the consumers integrate the last one. rpb is the count of
// rays whose points fill the largest share of their 128-point tiles, the
// most of equal share within shared memory (20 bytes a point: z, sigma,
// rgb): S = 64: 16 rays in 8 tiles, S = 128: 8 in 8, S = 192: 4 in 6
// (one ray would fill 192 of 256 rows). More rays a group give the
// quadrature more warps at once and fewer barriers a tile: 1-2% faster at
// R = 32768 than the fewest rays of the same share, in one call on an
// NVIDIA H100 80GB HBM3 at 700 W.
//
// sigma_render still runs nerf_mlp.cuh's WMMA tile: a block takes rpb =
// max(1, 256 / S) whole rays in tiles of TP = 64.
//
// What bounds them: tensor-core work, 1.19 MFLOP per point for the full
// MLP (5.03 ms at R = 32768, S = 128 on an H100 SXM's 989 TFLOP/s) and
// 0.98 for the trunk; device memory sees only rays, z and the per-ray
// outputs (plus weights (R, S) for sigma_render, which sample_pdf needs).
// render_eval reads each 32 KB weight slab from L2 once per 128 points
// (~9.4 KB a point).
//
// Launch contract: the caller's stream, no allocation, and the entry
// points return the first CUDA error of their launch.
#include <cuda_runtime.h>

#include "nerf_mlp.cuh"
#include "ray_tile.cuh"

namespace nerf {

// --------------------------------------------------------- sigma_render --

__device__ void sigma_quadrature(const Smem& sm, int S, int nray, int ray0,
                                 float* __restrict__ weights_out,
                                 float* __restrict__ opacity_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nray; r += NWARPS) {
    const float* ray = sm.rays + r * 8;
    const float dn = sqrtf(__fadd_rn(
        __fadd_rn(__fmul_rn(ray[3], ray[3]), __fmul_rn(ray[4], ray[4])),
        __fmul_rn(ray[5], ray[5])));
    const float* zr = sm.z + r * S;
    const float* sr = sm.sig + r * S;
    float carry = 0.f, op = 0.f;
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
        weights_out[(size_t)(ray0 + r) * S + s] = w;
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      op += __shfl_xor_sync(0xffffffffu, op, m);
    if (lane == 0) opacity_out[(size_t)ray0 + r] = op;
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
sigma_render_kernel(const float* __restrict__ rays,
                    const float* __restrict__ z, int R, int S, int rpb,
                    MlpWeights p, float* __restrict__ weights_out,
                    float* __restrict__ opacity_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = smem_at(smem_raw, SmemLayout(S, rpb));

  const int ray0 = blockIdx.x * rpb;
  const int nray = min(rpb, R - ray0);
  const int P = nray * S;                  // valid points of this block
  for (int i = threadIdx.x; i < rpb * 8; i += NTHREADS)
    sm.rays[i] = i < nray * 8 ? rays[(size_t)ray0 * 8 + i] : 0.f;
  for (int i = threadIdx.x; i < P; i += NTHREADS)
    sm.z[i] = z[(size_t)ray0 * S + i];
  __syncthreads();

  for (int t0 = 0; t0 < P; t0 += TP) {
    build_inputs(sm, S, t0, P);
    __syncthreads();
    mlp_tile(p, sm, sm.sig + t0, min(TP, P - t0));
    __syncthreads();
  }
  sigma_quadrature(sm, S, nray, ray0, weights_out, opacity_out);
}

// ---------------------------------------------------------- render_eval --

struct EvalArgs : RayArgs {
  MlpWeights p;
  float* rgb;       // (R, 3)
  float* depth;     // (R,)
  float* opacity;   // (R,)
};

// Rays a group of render_eval: the count whose rpb * S points fill the
// largest share of their 128-point tiles, the most of equal share, among
// those whose block fits shared memory with a 3-stage ring (1 if none
// does).
inline int eval_rays_per_block(int S) {
  int best = 1;
  long long best_pts = 0, best_rows = 1;
  for (int r = 1; FbLayout(S, r, 3, EVAL).total <= MAX_SMEM; ++r) {
    const long long pts = (long long)r * S;
    const long long rows = (pts + AT - 1) / AT * AT;
    if (pts * best_rows >= best_pts * rows) {  // pts / rows no smaller
      best = r;
      best_pts = pts;
      best_rows = rows;
    }
  }
  return best;
}

__global__ void __launch_bounds__(A_THREADS, 1)
eval_quad_kernel(const __grid_constant__ WeightMaps wm, EvalArgs a,
                 int nst) {
  extern __shared__ __align__(1024) unsigned char araw[];
  unsigned char* base = align1024(araw);
  const FbLayout L(a.S, a.rpb, nst, EVAL);
  unsigned char* xd = base + L.xd;
  unsigned char* h = base + L.h;
  float* eb = reinterpret_cast<float*>(base + L.bias);
  Ring ring = start_block(base + L.ring,
                          reinterpret_cast<uint64_t*>(base + L.bar), nst,
                          a.p, eb);
  RayBlock blk(base, L, a);
  const int ngroup = (a.R + a.rpb - 1) / a.rpb;
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid >= 256) {                       // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256)
      for (int g = blockIdx.x; g < ngroup; g += gridDim.x)
        for (int t = 0; t < blk.ntile; ++t) produce_fwd(wm, ring);
    return;
  }
  regs_alloc<232>();

  const Wg wg = consumer_wg();
  float* pts = reinterpret_cast<float*>(base + L.stage) + wg.g * L.pts_wg;
  const RaySmem& sm = blk.sm;
  int held = -1;
  for (int g = blockIdx.x; g < ngroup; g += gridDim.x) {
    blk.load(a, g, tid, 256);             // the last group is integrated
    named_sync(1, 256);
    for (int t = 0; t < blk.ntile; ++t) {
      const int t0 = t * AT, nv = min(AT, blk.npt - t0);
      ray_points(wg, sm, a.S, t0, nv, pts);
      embed_tile<false>(wg, nv, pts, xd, nullptr, nullptr);
      forward_tile<false>(wg, ring, held, a.p, eb, nullptr, xd, h, nullptr,
                          0, nv, sm.sig + t0, sm.rgb + (size_t)t0 * 3);
    }
    named_sync(1, 256);
    for (int r = tid >> 5; r < blk.nray; r += 8) {
      const RayQuad q = quad_forward(a, sm, blk.ex, r,
                                     dir_norm(sm.rays + r * 8), nullptr);
      const size_t gr = (size_t)blk.ray0 + r;
      if (wg.lane == 0) {
        a.rgb[gr * 3 + 0] = q.rgb0;
        a.rgb[gr * 3 + 1] = q.rgb1;
        a.rgb[gr * 3 + 2] = q.rgb2;
        a.depth[gr] = q.dep;
        a.opacity[gr] = q.op;
      }
    }
    named_sync(1, 256);                   // before the next group's load
  }
}

cudaError_t launch_eval(const EvalArgs& a, cudaStream_t st) {
  WeightMaps wm;
  if (!weight_maps(a.p, &wm)) return cudaErrorInvalidValue;
  const int nst = ring_stages(a.S, a.rpb, EVAL);
  const size_t smem = FbLayout(a.S, a.rpb, nst, EVAL).total;
  cudaError_t err = cudaFuncSetAttribute(
      eval_quad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int ngroup = (a.R + a.rpb - 1) / a.rpb;
  eval_quad_kernel<<<ngroup < WAVE ? ngroup : WAVE, A_THREADS, smem, st>>>(
      wm, a, nst);
  return cudaGetLastError();
}

}  // namespace nerf

extern "C" {

int nerf_sigma_render(const void* rays, const void* z, int R, int S,
                      const void* w0, const void* wt, const void* wsk,
                      const void* bt, const void* ws, const void* bs,
                      void* weights, void* opacity, void* stream) {
  using namespace nerf;
  if (R <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const MlpWeights p = weights_at(w0, wt, wsk, bt, ws, bs, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, nullptr,
                                  nullptr);
  const int rpb = rays_per_block(S);
  const SmemLayout L(S, rpb);
  cudaError_t err = cudaFuncSetAttribute(
      sigma_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  sigma_render_kernel<<<(R + rpb - 1) / rpb, NTHREADS, L.total,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(z), R, S,
      rpb, p, static_cast<float*>(weights), static_cast<float*>(opacity));
  return static_cast<int>(cudaGetLastError());
}

int nerf_render_eval(const void* rays, const void* z, int R, int S,
                     const void* w0, const void* wt, const void* wsk,
                     const void* bt, const void* ws, const void* bs,
                     const void* wf, const void* bf, const void* wdf,
                     const void* wdd, const void* bd, const void* wr,
                     const void* br, int white_back, void* rgb, void* depth,
                     void* opacity, void* stream) {
  using namespace nerf;
  if (R <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  EvalArgs a{};
  a.rays = static_cast<const float*>(rays);
  a.z = static_cast<const float*>(z);
  a.R = R;
  a.S = S;
  a.rpb = eval_rays_per_block(S);
  a.white_back = white_back;
  a.p = weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br);
  a.rgb = static_cast<float*>(rgb);
  a.depth = static_cast<float*>(depth);
  a.opacity = static_cast<float*>(opacity);
  return static_cast<int>(
      launch_eval(a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
