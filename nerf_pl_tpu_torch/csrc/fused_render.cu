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
// train_fwd's out8[:, 0:5] on a zero noise tensor bit for bit.
//
// sigma_render is render_eval on the trunk alone: per tile, ray_points
// without directions -> embed_tile of gamma(x) alone -> trunk_tile (the
// sigma head in layer D-1's epilogue) into the block's sigma, its producer
// streaming produce_trunk's 32 slabs a tile; then a warp per ray runs
// quad_weights with a null noise, the weight part of quad_forward, and
// writes the (R, S) weights and the opacity. Its C entry takes the trunk's
// weights alone (TMA maps of w0, wt and wsk; a bias copy of bt). Its sigma
// is train_fwd's (the same trunk_tile on the same gamma(x)) and its
// weights the same expressions, so its weights and opacity equal
// train_fwd's weights and out8[:, 4] on a zero noise tensor bit for bit.
//
// Both grids are persistent: min(groups, WAVE = 132) blocks, each walking
// groups g = blockIdx.x, + gridDim.x, ... of rpb rays, so a block
// initialises its barriers and bias copy once and its producer streams the
// next group's slabs while the consumers integrate the last one. rpb is
// the count of rays whose points fill the largest share of their 128-point
// tiles, the most of equal share within shared memory with a 3-stage ring
// (render_eval 20 bytes a point: z, sigma, rgb; sigma_render 8: z, sigma):
// render_eval at S = 64: 16 rays in 8 tiles, S = 128: 8 in 8, S = 192: 4
// in 6 (one ray would fill 192 of 256 rows); sigma_render at S = 64: 42
// rays in 21 tiles, S = 128: 22 in 22, S = 192: 14 in 21. More rays a
// group give the quadrature more warps at once and fewer barriers a tile:
// render_eval was 1-2% faster at R = 32768 than with the fewest rays of the
// same share, in one call on an NVIDIA H100 80GB HBM3 at 700 W.
//
// What bounds them: tensor-core work, 1.19 MFLOP per point for the full
// MLP (5.03 ms at R = 32768, S = 128 on an H100 SXM's 989 TFLOP/s) and
// 0.98 for the trunk (2.08 ms at R = 32768, S = 64); device memory sees
// only rays, z and the per-ray outputs (plus weights (R, S) for
// sigma_render, which sample_pdf needs). render_eval reads each 32 KB
// weight slab from L2 once per 128 points (~9.4 KB a point), sigma_render
// 32 slabs (~8 KB a point).
//
// Launch contract: the caller's stream, no allocation, and the entry
// points return the first CUDA error of their launch.
#include <cuda_runtime.h>

#include "ray_tile.cuh"

namespace nerf {

// ---------------------------------------------------------- render_eval --

struct EvalArgs : RayArgs {
  MlpWeights p;
  float* rgb;       // (R, 3)
  float* depth;     // (R,)
  float* opacity;   // (R,)
};

// Rays a group of render_eval (EVAL) or sigma_render (TRUNK): the count
// whose rpb * S points fill the largest share of their 128-point tiles, the
// most of equal share, among those whose block fits shared memory with a
// 3-stage ring (1 if none does).
inline int rays_per_group(int S, Pass pass) {
  int best = 1;
  long long best_pts = 0, best_rows = 1;
  for (int r = 1; FbLayout(S, r, 3, pass).total <= MAX_SMEM; ++r) {
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

// ---------------------------------------------------------- sigma_render --

struct SigmaArgs : RayArgs {
  MlpWeights p;
  float* weights;   // (R, S)
  float* opacity;   // (R,)
};

// sigma_render: eval_quad_kernel on the trunk alone, then quad_weights.
__global__ void __launch_bounds__(A_THREADS, 1)
sigma_quad_kernel(const __grid_constant__ TrunkMaps wm, SigmaArgs a,
                  int nst) {
  extern __shared__ __align__(1024) unsigned char araw[];
  unsigned char* base = align1024(araw);
  const FbLayout L(a.S, a.rpb, nst, TRUNK);
  unsigned char* xd = base + L.xd;
  unsigned char* h = base + L.h;
  float* eb = reinterpret_cast<float*>(base + L.bias);
  Ring ring = start_block(base + L.ring,
                          reinterpret_cast<uint64_t*>(base + L.bar), nst,
                          a.p, eb, N_TRUNK_BIAS);
  RayBlock blk(base, L, a);
  const int ngroup = (a.R + a.rpb - 1) / a.rpb;
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid >= 256) {                       // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256)
      for (int g = blockIdx.x; g < ngroup; g += gridDim.x)
        for (int t = 0; t < blk.ntile; ++t) produce_trunk(wm, ring);
    return;
  }
  regs_alloc<232>();

  const Wg wg = consumer_wg();
  float* pts = reinterpret_cast<float*>(base + L.stage) + wg.g * L.pts_wg;
  const RaySmem& sm = blk.sm;
  const int S = a.S;
  int held = -1;
  for (int g = blockIdx.x; g < ngroup; g += gridDim.x) {
    blk.load(a, g, tid, 256);             // the last group is integrated
    named_sync(1, 256);
    for (int t = 0; t < blk.ntile; ++t) {
      const int t0 = t * AT, nv = min(AT, blk.npt - t0);
      ray_points<false>(wg, sm, S, t0, nv, pts);
      embed_tile<false, false>(wg, nv, pts, xd, nullptr, nullptr);
      float acc[128];
      trunk_tile<false>(acc, wg, ring, held, a.p, eb, nullptr, xd, h,
                        nullptr, 0, nv, sm.sig + t0);
    }
    named_sync(1, 256);
    for (int r = tid >> 5; r < blk.nray; r += 8) {
      const size_t gr = (size_t)blk.ray0 + r;
      float* wr = a.weights + gr * S;
      float op = 0.f;
      quad_weights(sm, nullptr, S, r, dir_norm(sm.rays + r * 8),
                   [&](int s, float w, float) {
                     wr[s] = w;
                     op += w;
                   });
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1)
        op += __shfl_xor_sync(0xffffffffu, op, m);
      if (wg.lane == 0) a.opacity[gr] = op;
    }
    named_sync(1, 256);                   // before the next group's load
  }
}

// -------------------------------------------------------------- launches --

// The persistent grid of a launch on rays: min(groups, WAVE) blocks.
inline int ray_grid(const RayArgs& a) {
  const int ngroup = (a.R + a.rpb - 1) / a.rpb;
  return ngroup < WAVE ? ngroup : WAVE;
}

cudaError_t launch_sigma(const SigmaArgs& a, cudaStream_t st) {
  TrunkMaps wm;
  if (!trunk_maps(a.p, &wm)) return cudaErrorInvalidValue;
  const int nst = ring_stages(a.S, a.rpb, TRUNK);
  const size_t smem = FbLayout(a.S, a.rpb, nst, TRUNK).total;
  cudaError_t err = cudaFuncSetAttribute(
      sigma_quad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sigma_quad_kernel<<<ray_grid(a), A_THREADS, smem, st>>>(wm, a, nst);
  return cudaGetLastError();
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
  eval_quad_kernel<<<ray_grid(a), A_THREADS, smem, st>>>(wm, a, nst);
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
  SigmaArgs a{};
  a.rays = static_cast<const float*>(rays);
  a.z = static_cast<const float*>(z);
  a.R = R;
  a.S = S;
  a.rpb = rays_per_group(S, TRUNK);
  a.p = weights_at(w0, wt, wsk, bt, ws, bs, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr);
  a.weights = static_cast<float*>(weights);
  a.opacity = static_cast<float*>(opacity);
  return static_cast<int>(
      launch_sigma(a, static_cast<cudaStream_t>(stream)));
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
  a.rpb = rays_per_group(S, EVAL);
  a.white_back = white_back;
  a.p = weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br);
  a.rgb = static_cast<float*>(rgb);
  a.depth = static_cast<float*>(depth);
  a.opacity = static_cast<float*>(opacity);
  return static_cast<int>(
      launch_eval(a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
