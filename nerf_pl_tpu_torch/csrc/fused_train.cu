// Fused training render of one NeRF MLP over a ray batch: forward, the
// training quadrature, its VJP and the MLP's weight gradients. Three
// kernels of nerf_pl_tpu/ops/fused_train.py:
//
//   mse_render  replaces fused_mse_render (body _mse_fwdbwd_kernel): the
//               forward, the MSE cotangent 2 * scale * (rgb - gt) and the
//               whole backward, gradients as outputs;
//   train_fwd   replaces the forward of fused_train_render
//               (_train_fwd_call, body _train_fwd_kernel): out8 (rgb,
//               depth, opacity) and the (R, S) weights;
//   train_bwd   replaces its backward (_train_bwd, body _train_bwd_kernel):
//               the weight gradients for cotangents g8 (R, 8) on out8 and
//               gw (R, S) on the weights (null reads as zero).
//
// Per tile of rays they compute the points o + d*z, gamma(x) and gamma(d),
// the MLP forward in bf16 with f32 sums (mlp_wgmma.cuh's forward_tile) and
// the training quadrature with sigma noise (ray_tile.cuh's blocks of rays
// and quad_forward, shared by the three as the TPU kernels share
// _quad_forward, and with render_eval in fused_render.cu). The two
// backwards then form a_k = dL/dw_k from their cotangent (a template
// policy: the MSE cotangent, or the given g8 and gw), run the analytic
// quadrature VJP (quad_vjp) and the weight gradients. train_bwd
// recomputes the forward, as the TPU backward does, so the two-kernel path
// does one forward more than mse_render. train_fwd runs the very forward
// and quadrature of mse_render, so its out8 and weights equal
// mse_render's bit for bit.
//
// Why it is not carried over block by block: the TPU kernel keeps the
// weights, every activation of a tile and 2.4 MB of f32 gradient
// accumulators in VMEM across a sequential grid. Here blocks run
// concurrently, a block has at most 227 KB of shared memory, and a
// 128-point tile's activations alone are 2432 bf16 per point (~620 KB).
// So each backward is three launches, none with float atomics (two
// launches on the same inputs give bit-identical gradients):
//
//   A  fwdbwd       one block per rpb whole rays, tiles of 128 points on
//                   wgmma (mlp_wgmma.cuh). The forward stores every bf16
//                   activation of its points to a global scratch; a warp
//                   per ray runs the quadrature and its VJP in f32 (warp
//                   scans: the exclusive prefix sum for T and a true
//                   exclusive suffix sum for dL/do = a T exp(-o) - suffix,
//                   never a (T - w), which cancels for saturated samples);
//                   then, tile by tile, the data-gradient chain from the
//                   heads' cotangents.
//   B  wgrad        every dW = act^T dz (mlp_grad.cuh, wgmma),
//   C  sum_slots    then the ordered sums of its slots and of the bias
//      sum_rows     partials, one row per consumer warpgroup of A.
// train_fwd (fwd_quad) is launch A's forward and quadrature alone: no
// scratch, no masks, no backward regions of shared memory, and the
// producer streams only the forward's slabs.
//
// A ragged R is masked: a block's rays past R are zero rows whose outputs
// are never written and whose cotangents are zero. (The TPU wrapper refuses
// an R that is not a multiple of 8 instead; the train CLI keeps that rule.)
//
// What bounds a backward (H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s):
// 2.302 MFLOP a point in A (forward 1.186816, data gradients 1.115392),
// 0.305 ms at P = 131,072 (R = 1024, S = 128), and 1.187 in B, 0.157 ms;
// and the scratch round trip, 10,016 bytes of bf16 a point written by A
// and read by B (1.313 GB, 0.39 ms each way), which is this design's floor
// (~0.8 ms). Weight gradients are summed over points in f32 (wgmma
// accumulators, then the slots); bias gradients sum the f32 cotangents.
// train_fwd is bound by its 1.187 MFLOP a point (0.157 ms at P = 131,072);
// it reads and writes only per-ray and per-sample f32 data.
//
// Launch contract: the caller's stream, no allocation (a backward takes a
// workspace of nerf_mse_workspace_bytes(R, S)), and the entry points return
// the first CUDA error of their launches.
#include <cuda_runtime.h>

#include <numeric>

#include "ray_tile.cuh"

namespace nerf {

struct TrainArgs : GradArgs, RayArgs {
  const float* gt;          // (R, 3)  mse_render
  const float* g8;          // (R, 8)  train_bwd: [d rgb (3), d depth, d op]
  const float* gw;          // (R, S)  train_bwd, may be null
  float scale;
  float* out8;
  float* weights;
  float* bias_part;         // (rows, NBIAS)
  uint4* bits;              // launch A's ReLU masks (MASK_TILE_BYTES a tile)
};

// Lanes 0..7 write the ray's out8 row [rgb, depth, opacity, 0, 0, 0].
__device__ __forceinline__ void write_out8(float* row, const RayQuad& q) {
  const int lane = threadIdx.x & 31;
  if (lane < 8) {
    const float v[8] = {q.rgb0, q.rgb1, q.rgb2, q.dep, q.op, 0.f, 0.f, 0.f};
    row[lane] = v[lane];
  }
}

// A ray's cotangents on the forward's outputs: g0..g2 on the rgb and, when
// given (train_bwd), gdep on the depth, gop on the opacity and the row gw
// on the weights (null: zero).
struct RayCot {
  float g0, g1, g2, gdep, gop;
  const float* gw;
};

// Warp per ray: the quadrature VJP of ray r, after quad_forward. a_k =
// dL/dw_k = (gw_k + gdep z_k + gop) + sum_c g_c c_k - white_back sum_c g_c
// (GIVEN; the MSE cotangent has only the rgb terms), then, last chunk
// first, dL/do_k = a_k T_k exp(-o_k) - suffix_k with suffix_k = sum_{i > k}
// a_i w_i, and dL/dsigma_k = dL/do_k delta_k where sigma_k + n_k > 0, to
// ex.gsig. The rgb terms are summed by the same expressions in both
// policies and the other terms added after them, so that on the MSE
// cotangent alone train_bwd forms the very a_k of mse_render: the compiler
// may fuse g0 c0 + g1 c1 into one FMA either way round, and does so
// alike.
template <bool GIVEN>
__device__ void quad_vjp(const TrainArgs& a, const RaySmem& sm,
                         const Extra& ex, int r, float dn, const RayCot& g) {
  const int lane = threadIdx.x & 31;
  const int S = a.S;
  const float* zr = sm.z + r * S;
  const float* sr = sm.sig + r * S;
  const float* nr = ex.noise ? ex.noise + r * S : nullptr;
  const float* cr = sm.rgb + (size_t)r * S * 3;
  const float* wr = ex.w + r * S;
  const float* tr = ex.trans + r * S;
  const float gsum = (g.g0 + g.g1) + g.g2;
  float later = 0.f;                     // sum of a w over later chunks
  for (int s0 = ((S - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    float av = 0.f, aw = 0.f;
    if (s < S) {
      av = g.g0 * cr[s * 3 + 0];
      av = av + g.g1 * cr[s * 3 + 1];
      av = av + g.g2 * cr[s * 3 + 2];
      if (GIVEN) {
        float base = (g.gw ? g.gw[s] : 0.f) + g.gdep * zr[s];
        base = base + g.gop;
        av = base + av;
      }
      if (a.white_back) av = av - gsum;
      aw = av * wr[s];
    }
    float inc = aw;                      // inclusive suffix scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, inc, off);
      if (lane + off < 32) inc += y;
    }
    float exc = __shfl_down_sync(0xffffffffu, inc, 1);
    exc = (lane == 31 ? 0.f : exc) + later;
    later += __shfl_sync(0xffffffffu, inc, 0);
    if (s < S) {
      const float delta = sample_delta(zr, s, S, dn);
      const float s_eff = sr[s] + (nr ? nr[s] : 0.f);
      const float o = __fmul_rn(delta, fmaxf(s_eff, 0.f));
      const float d_o = av * tr[s] * expf(-o) - exc;
      ex.gsig[r * S + s] = s_eff > 0.f ? d_o * delta : 0.f;
    }
  }
}

// ------------------------------------------------------ launches on rays --
//
// One block per rpb whole rays: their points in tiles of AT = 128
// (mlp_wgmma.cuh's block shape). Shared memory (ray_tile.cuh's FbLayout,
// pass BWD or FWD) is the tile loops' regions, the warpgroups' point rows
// (in the column-sum stage of a backward, a region of their own in
// train_fwd), and the per-ray and per-point f32 data: rays, z, sigma,
// noise, rgb, quadrature weights and transmittance, and for a backward
// dL/dsigma (32 bytes a point, 36 with the backward's). The ring has nst =
// 3 stages, 2 where a long ray would not fit 227 KB with 3 (a backward at
// S > ~390, train_fwd at S > ~670).
//
// rpb is the fewest rays whose points fill whole tiles, AT / gcd(S, AT),
// where a backward block of that many fits with three stages; else AT / S
// rays (S < AT) or one, and the last tile of a block is partly padding
// rows. A ray's quadrature stays in its block, and which rows share a tile
// changes no row's products, so out8 and the weights do not depend on rpb.
// At R = 1024, one block per SM:
//   S = 32:  rpb 4, 1 tile, 256 blocks, 1.9 waves of 132 SMs, 222,848 bytes;
//   S = 64:  rpb 2, 1 tile, 512 blocks, 3.9 waves, 222,848 bytes;
//   S = 96:  rpb 4, 3 tiles, 256 blocks, 1.9 waves (6 tile-times an SM, as
//            against 8 for a block per ray, whose tile is a quarter
//            padding), 232,064 bytes: 384 under MAX_SMEM, so the BWD
//            layout takes nothing more without redoing this sum;
//   S = 128: rpb 1, 1 tile, 1024 blocks, 7.8 waves, 222,848 bytes
// (train_fwd's FWD blocks take 8,064 bytes less at S = 32, 64 and 128,
// 9,088 at S = 96). S = 48 and 192 also lose their padding (rpb 8 and 2,
// three tiles); at S = 24, 400 or 1024 a block of whole tiles would not
// fit, or is one ray already.

inline int a_rays_per_block(int S) {
  const int whole = AT / std::gcd(S, AT);
  if (FbLayout(S, whole, 3, BWD).total <= MAX_SMEM) return whole;
  return S >= AT ? 1 : AT / S;
}

// The block grid of launch A over R rays of S samples and its scratch
// rows (whole tiles per block; rows of a block's tiles past its points,
// whole tiles of them in a ragged last block, are zero cotangents).
struct AShape {
  int rpb, ntile, grid;
  size_t rows;
  AShape(int R, int S)
      : rpb(a_rays_per_block(S)),
        ntile((rpb * S + AT - 1) / AT),
        grid((R + rpb - 1) / rpb),
        rows((size_t)grid * ntile * AT) {}
};

// Launch A of both backwards. !GIVEN (mse_render): writes out8 and the
// weights and forms the MSE cotangent; GIVEN (train_bwd): takes g8 and gw.
template <bool GIVEN>
__global__ void __launch_bounds__(A_THREADS, 1)
fwdbwd_kernel(const __grid_constant__ WeightMaps wm,
              const __grid_constant__ ScratchMaps scm, TrainArgs a,
              int nst) {
  extern __shared__ __align__(1024) unsigned char araw[];
  unsigned char* base = align1024(araw);
  const FbLayout L(a.S, a.rpb, nst, BWD);
  unsigned char* xd = base + L.xd;
  unsigned char* h = base + L.h;
  float* stage = reinterpret_cast<float*>(base + L.stage);
  float* dzr_s = reinterpret_cast<float*>(base + L.dzr);
  float* eb = reinterpret_cast<float*>(base + L.bias);
  Ring ring = start_block(base + L.ring,
                          reinterpret_cast<uint64_t*>(base + L.bar), nst,
                          a.p, eb);
  RayBlock blk(base, L, a);
  blk.load(a, blockIdx.x, threadIdx.x, A_THREADS);
  const RaySmem& sm = blk.sm;
  const Extra& ex = blk.ex;
  const int tid = threadIdx.x;
  const int S = a.S;
  const size_t prow0 = (size_t)blockIdx.x * blk.ntile * AT;
  __syncthreads();
  if (tid >= 256) {                       // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256) {
      for (int t = 0; t < blk.ntile; ++t) produce_fwd(wm, ring);
      for (int t = 0; t < blk.ntile; ++t) produce_bwd(wm, ring);
    }
    return;
  }
  regs_alloc<232>();

  const Wg wg = consumer_wg();
  float* bias = a.bias_part + (size_t)(2 * blockIdx.x + wg.g) * NBIAS;
  for (int i = wg.t; i < NBIAS; i += 128) bias[i] = 0.f;
  float* pts = stage + wg.g * L.pts_wg;
  int held = -1;

  for (int t = 0; t < blk.ntile; ++t) {   // forward, keeping activations
    const int t0 = t * AT, nv = min(AT, blk.npt - t0);
    const size_t row0 = prow0 + t0;
    ray_points(wg, sm, S, t0, nv, pts);
    embed_tile<true>(wg, nv, pts, xd, a.s.x + row0 * KX, a.s.d + row0 * KD);
    forward_tile<true>(wg, ring, held, a.p, eb, &scm, xd, h,
                       a.bits + (row0 / AT) * MASK_LAYERS * 256, row0, nv,
                       sm.sig + t0, sm.rgb + (size_t)t0 * 3);
  }
  if (wg.leader) {                        // the stores are in the scratch
    bulk_wait_all();
    fence_async_all();
  }
  named_sync(1, 256);

  for (int r = tid >> 5; r < blk.nray; r += 8) {   // quadrature, its VJP
    const size_t gr = (size_t)blk.ray0 + r;
    const float dn = dir_norm(sm.rays + r * 8);
    RayCot g;
    if (GIVEN) {
      quad_forward(a, sm, ex, r, dn, nullptr);
      const float* g8 = a.g8 + gr * 8;
      g = {g8[0], g8[1], g8[2], g8[3], g8[4], a.gw ? a.gw + gr * S : nullptr};
    } else {
      const RayQuad q = quad_forward(a, sm, ex, r, dn, a.weights + gr * S);
      const float two_s = 2.f * a.scale;
      g = {two_s * (q.rgb0 - a.gt[gr * 3 + 0]),
           two_s * (q.rgb1 - a.gt[gr * 3 + 1]),
           two_s * (q.rgb2 - a.gt[gr * 3 + 2]), 0.f, 0.f, nullptr};
      write_out8(a.out8 + gr * 8, q);
    }
    if (wg.lane == 0) {
      ex.grgb[r * 4 + 0] = g.g0;
      ex.grgb[r * 4 + 1] = g.g1;
      ex.grgb[r * 4 + 2] = g.g2;
    }
    quad_vjp<GIVEN>(a, sm, ex, r, dn, g);
  }
  named_sync(1, 256);

  for (int t = 0; t < blk.ntile; ++t) {   // backward, tile by tile
    const int t0 = t * AT, nv = min(AT, blk.npt - t0);
    const size_t row0 = prow0 + t0;
    // the rgb head's cotangent w_k g c (1 - c) and dL/dsigma of point lp
    backward_tile(wg, ring, held, a.p, scm, a.s, h, dzr_s, stage, bias,
                  a.bits + (row0 / AT) * MASK_LAYERS * 256, row0, nv,
                  [&](int row) {
                    const int lp = t0 + row;
                    const float w = ex.w[lp];
                    const float* c = sm.rgb + (size_t)lp * 3;
                    const float* g = ex.grgb + (lp / S) * 4;
                    return make_float4(w * g[0] * c[0] * (1.f - c[0]),
                                       w * g[1] * c[1] * (1.f - c[1]),
                                       w * g[2] * c[2] * (1.f - c[2]),
                                       ex.gsig[lp]);
                  });
  }
  if (wg.leader) bulk_wait_all();
}

// train_fwd: launch A's forward and quadrature alone, out8 and the
// weights.
__global__ void __launch_bounds__(A_THREADS, 1)
fwd_quad_kernel(const __grid_constant__ WeightMaps wm, TrainArgs a,
                int nst) {
  extern __shared__ __align__(1024) unsigned char araw[];
  unsigned char* base = align1024(araw);
  const FbLayout L(a.S, a.rpb, nst, FWD);
  unsigned char* xd = base + L.xd;
  unsigned char* h = base + L.h;
  float* eb = reinterpret_cast<float*>(base + L.bias);
  Ring ring = start_block(base + L.ring,
                          reinterpret_cast<uint64_t*>(base + L.bar), nst,
                          a.p, eb);
  RayBlock blk(base, L, a);
  blk.load(a, blockIdx.x, threadIdx.x, A_THREADS);
  const RaySmem& sm = blk.sm;
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid >= 256) {                       // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256)
      for (int t = 0; t < blk.ntile; ++t) produce_fwd(wm, ring);
    return;
  }
  regs_alloc<232>();

  const Wg wg = consumer_wg();
  float* pts = reinterpret_cast<float*>(base + L.stage) + wg.g * L.pts_wg;
  int held = -1;
  for (int t = 0; t < blk.ntile; ++t) {
    const int t0 = t * AT, nv = min(AT, blk.npt - t0);
    ray_points(wg, sm, a.S, t0, nv, pts);
    embed_tile<false>(wg, nv, pts, xd, nullptr, nullptr);
    forward_tile<false>(wg, ring, held, a.p, eb, nullptr, xd, h, nullptr, 0,
                        nv, sm.sig + t0, sm.rgb + (size_t)t0 * 3);
  }
  named_sync(1, 256);
  for (int r = tid >> 5; r < blk.nray; r += 8) {
    const size_t gr = (size_t)blk.ray0 + r;
    write_out8(a.out8 + gr * 8,
               quad_forward(a, sm, blk.ex, r, dir_norm(sm.rays + r * 8),
                            a.weights + gr * a.S));
  }
}

// ------------------------------------------------------------------ host --

inline TrainArgs train_args(const void* rays, const void* z,
                            const void* noise, int R, int S,
                            const MlpWeights& p, int white_back) {
  TrainArgs a{};
  a.rays = static_cast<const float*>(rays);
  a.z = static_cast<const float*>(z);
  a.noise = static_cast<const float*>(noise);
  a.R = R;
  a.S = S;
  a.rpb = AShape(R, S).rpb;
  a.white_back = white_back;
  a.p = p;
  return a;
}

cudaError_t launch_train_fwd(const TrainArgs& a, cudaStream_t st) {
  WeightMaps wm;
  if (!weight_maps(a.p, &wm)) return cudaErrorInvalidValue;
  const int nst = ring_stages(a.S, a.rpb, FWD);
  const size_t smem = FbLayout(a.S, a.rpb, nst, FWD).total;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_quad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fwd_quad_kernel<<<AShape(a.R, a.S).grid, A_THREADS, smem, st>>>(wm, a,
                                                                  nst);
  return cudaGetLastError();
}

// Launches A, B and C of a backward: the scratch and the bias partials in
// the workspace, the gradients into grad.
template <bool GIVEN>
int launch_backward(TrainArgs a, void* workspace, void* grad, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AShape sh(a.R, a.S);
  const Workspace wsp(sh.rows, 2 * sh.grid, sh.rows / AT * MASK_TILE_BYTES);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  a.s = scratch_at(base, wsp.P);
  a.bias_part = reinterpret_cast<float*>(base + wsp.bias);
  a.bits = reinterpret_cast<uint4*>(base + wsp.extra);
  WeightMaps wm;
  ScratchMaps scm;
  if (!weight_maps(a.p, &wm) || !scratch_maps(a.s, &scm))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nst = ring_stages(a.S, a.rpb, BWD);
  const size_t smem = FbLayout(a.S, a.rpb, nst, BWD).total;
  cudaError_t err = cudaFuncSetAttribute(
      fwdbwd_kernel<GIVEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fwdbwd_kernel<GIVEN><<<sh.grid, A_THREADS, smem, st>>>(wm, scm, a, nst);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(
      scm, wsp, base, a.bias_part, static_cast<float*>(grad), st));
}

}  // namespace nerf

using nerf::bf16;

extern "C" {

long long nerf_mse_workspace_bytes(int R, int S) {
  const nerf::AShape sh(R, S);
  return static_cast<long long>(
      nerf::Workspace(sh.rows, 2 * sh.grid,
                      sh.rows / nerf::AT * nerf::MASK_TILE_BYTES)
          .total);
}

// Tile rows that launch A runs over R rays of S samples (mse_render,
// train_bwd and train_fwd alike): R S of them are points, the rest padding.
long long nerf_ray_tile_rows(int R, int S) {
  return static_cast<long long>(nerf::AShape(R, S).rows);
}

// Floats of the gradient buffer of the training kernels (mse_render,
// train_bwd and mlp_bwd): the weight gradients, then the bias gradients.
int nerf_grad_floats() { return nerf::EW + nerf::NBIAS; }

int nerf_mse_render(const void* rays, const void* z, const void* noise,
                    const void* gt, int R, int S, const void* w0,
                    const void* wt, const void* wsk, const void* bt,
                    const void* ws, const void* bs, const void* wf,
                    const void* bf, const void* wdf, const void* wdd,
                    const void* bd, const void* wr, const void* br,
                    int white_back, float scale, void* out8, void* weights,
                    void* workspace, void* grad, void* stream) {
  using namespace nerf;
  if (R <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs a = train_args(
      rays, z, noise, R, S,
      weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br),
      white_back);
  a.gt = static_cast<const float*>(gt);
  a.scale = scale;
  a.out8 = static_cast<float*>(out8);
  a.weights = static_cast<float*>(weights);
  return launch_backward<false>(a, workspace, grad, stream);
}

int nerf_train_fwd(const void* rays, const void* z, const void* noise, int R,
                   int S, const void* w0, const void* wt, const void* wsk,
                   const void* bt, const void* ws, const void* bs,
                   const void* wf, const void* bf, const void* wdf,
                   const void* wdd, const void* bd, const void* wr,
                   const void* br, int white_back, void* out8, void* weights,
                   void* stream) {
  using namespace nerf;
  if (R <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs a = train_args(
      rays, z, noise, R, S,
      weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br),
      white_back);
  a.out8 = static_cast<float*>(out8);
  a.weights = static_cast<float*>(weights);
  return static_cast<int>(
      launch_train_fwd(a, static_cast<cudaStream_t>(stream)));
}

int nerf_train_bwd(const void* rays, const void* z, const void* noise,
                   const void* g8, const void* gw, int R, int S,
                   const void* w0, const void* wt, const void* wsk,
                   const void* bt, const void* ws, const void* bs,
                   const void* wf, const void* bf, const void* wdf,
                   const void* wdd, const void* bd, const void* wr,
                   const void* br, int white_back, void* workspace,
                   void* grad, void* stream) {
  using namespace nerf;
  if (R <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs a = train_args(
      rays, z, noise, R, S,
      weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br),
      white_back);
  a.g8 = static_cast<const float*>(g8);
  a.gw = static_cast<const float*>(gw);
  return launch_backward<true>(a, workspace, grad, stream);
}

}  // extern "C"
