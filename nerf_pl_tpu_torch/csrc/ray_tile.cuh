// Blocks of whole rays on mlp_wgmma.cuh's tile loops, shared by the kernels
// on rays (fused_train.cu's mse_render, train_bwd and train_fwd;
// fused_render.cu's render_eval and sigma_render): the rays' fields, a
// block's per-ray and per-point f32 data in shared memory, its points o + d
// z in tiles of AT = 128, and the quadrature of the TPU kernels'
// _quad_forward (nerf_pl_tpu/ops/fused_train.py, noise 0 in render_eval
// and sigma_render, where it is the same expressions as _quadrature_tile
// and _sigma_render_kernel of ops/fused_render.py). Its weights come from
// one function, quad_weights, so sigma_render's weights and opacity equal
// those of train_fwd on a zero noise tensor bit for bit.
//
// A block holds rpb whole rays: their points run through the MLP tile by
// tile (the last tile's rows past the block's points are zero rows whose
// outputs are never written), then a warp per ray integrates it, so each
// ray's sums stay inside one block. Which rows share a tile changes no
// point's sums: a row's products and epilogues read only that row.
//
// Everything here is inline or a template; each translation unit that
// includes it gets its own copy.
#pragma once

#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"

namespace nerf {

// The ray fields of a launch on rays.
struct RayArgs {
  const float* rays;        // (R, 8) [o, d, near, far]
  const float* z;           // (R, S) sample depths
  const float* noise;       // (R, S) sigma noise; null reads as zero
  int R, S, rpb, white_back;
};

// A block's per-ray and per-point f32 data in shared memory.
struct RaySmem {
  float* rays;    // rpb x 8
  float* z;       // rpb * S
  float* sig;     // rpb * S      raw sigma of each point
  float* rgb;     // rpb * S * 3  rgb of each point, after the sigmoid
};

// The per-point and per-ray f32 data of the training quadrature and its
// VJP (null where a pass keeps none).
struct Extra {
  float* noise;   // rpb * S
  float* w;       // rpb * S   quadrature weights
  float* trans;   // rpb * S   transmittance
  float* gsig;    // rpb * S   dL/dsigma (backward)
  float* grgb;    // rpb x 4   dL/drgb of each ray (backward)
};

__device__ __forceinline__ float dir_norm(const float* ray) {
  return sqrtf(__fadd_rn(
      __fadd_rn(__fmul_rn(ray[3], ray[3]), __fmul_rn(ray[4], ray[4])),
      __fmul_rn(ray[5], ray[5])));
}

// delta_k = (z_{k+1} - z_k) |d| (1e10 |d| for the last) and its optical
// depth delta_k relu(sigma_k + noise_k); rounded like the plain version.
__device__ __forceinline__ float sample_delta(const float* zr, int s, int S,
                                              float dn) {
  return __fmul_rn(s + 1 < S ? zr[s + 1] - zr[s] : 1e10f, dn);
}

struct RayQuad {
  float rgb0, rgb1, rgb2, dep, op;   // rgb with the white background
};

// Warp per ray: the quadrature weights of ray r of the block (raw sigma in
// sm.sig, the noise row nr, null reading as zero). o_k = delta_k relu(
// sigma_k + n_k), T_k = exp(-exclusive prefix sum of o_k), no +1e-10, and
// w_k = (1 - exp(-o_k)) T_k; each lane calls f(s, w_k, T_k) for its samples
// s < S, 32 apart, in order.
template <class F>
__device__ __forceinline__ void quad_weights(const RaySmem& sm,
                                             const float* nr, int S, int r,
                                             float dn, F&& f) {
  const int lane = threadIdx.x & 31;
  const float* zr = sm.z + r * S;
  const float* sr = sm.sig + r * S;
  float carry = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    float o = 0.f;
    if (s < S) {
      const float n = nr ? nr[s] : 0.f;
      o = __fmul_rn(sample_delta(zr, s, S, dn), fmaxf(sr[s] + n, 0.f));
    }
    float inc = o;                       // inclusive prefix scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += y;
    }
    float exc = __shfl_up_sync(0xffffffffu, inc, 1);
    exc = (lane == 0 ? 0.f : exc) + carry;
    carry += __shfl_sync(0xffffffffu, inc, 31);
    if (s < S) {
      const float t = expf(-exc);
      f(s, (1.f - expf(-o)) * t, t);
    }
  }
}

// Warp per ray: the quadrature of ray r of the block (the TPU kernels'
// _quad_forward) on quad_weights: w_k and T_k of each sample go to ex.w
// and ex.trans unless they are null, w_k also to wglob unless it is null.
// Every lane returns the ray's sums.
__device__ inline RayQuad quad_forward(const RayArgs& a,
                                       const RaySmem& sm, const Extra& ex,
                                       int r, float dn, float* wglob) {
  const int S = a.S;
  const float* zr = sm.z + r * S;
  const float* cr = sm.rgb + (size_t)r * S * 3;
  float op = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
  quad_weights(sm, ex.noise ? ex.noise + r * S : nullptr, S, r, dn,
               [&](int s, float w, float t) {
                 if (ex.w) {
                   ex.w[r * S + s] = w;
                   ex.trans[r * S + s] = t;
                 }
                 if (wglob) wglob[s] = w;
                 op += w;
                 c0 += w * cr[s * 3 + 0];
                 c1 += w * cr[s * 3 + 1];
                 c2 += w * cr[s * 3 + 2];
                 dep += w * zr[s];
               });
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    op += __shfl_xor_sync(0xffffffffu, op, m);
    c0 += __shfl_xor_sync(0xffffffffu, c0, m);
    c1 += __shfl_xor_sync(0xffffffffu, c1, m);
    c2 += __shfl_xor_sync(0xffffffffu, c2, m);
    dep += __shfl_xor_sync(0xffffffffu, dep, m);
  }
  const float bg = a.white_back ? 1.f - op : 0.f;
  return {c0 + bg, c1 + bg, c2 + bg, dep, op};
}

// What a launch on rays keeps in shared memory beside the tile loops'
// regions: TRUNK (sigma_render) the rays, z and sigma, and the trunk's
// biases alone; EVAL (render_eval) also rgb; FWD (train_fwd) also the
// noise, the quadrature weights and the transmittance; BWD (the backwards'
// launch A) also the column-sum stage, the heads' cotangents, dL/dsigma and
// each ray's dL/drgb.
struct FbLayout {
  size_t xd, h, ring, stage, dzr, bias, bar, rays, z, sig, noise, rgb, w,
      trans, gsig, grgb, total;
  int pts_wg;     // floats from one warpgroup's point rows to the other's
  Pass pass;
  __host__ __device__ FbLayout(int S, int rpb, int nst, Pass ps)
      : pass(ps) {
    const bool train = ps == FWD || ps == BWD, bwd = ps == BWD;
    const size_t n = sizeof(float) * rpb * S;
    size_t o = 0;
    xd = o;     o += 2 * ATILE;
    h = o;      o += 4 * ATILE;
    ring = o;   o += (size_t)nst * SLAB_BYTES;
    stage = o;  o += sizeof(float) * (bwd ? 8 * ST_LD : 2 * PTS_WG);
    dzr = o;    o += bwd ? sizeof(float) * AT * 4 : 0;
    bias = o;   o += sizeof(float) * (ps == TRUNK ? N_TRUNK_BIAS
                                                  : N_EPI_BIAS);
    bar = o;    o += align128(2 * 8 * nst);
    rays = o;   o += align128(sizeof(float) * rpb * 8);
    z = o;      o += align128(n);
    sig = o;    o += align128(n);
    noise = o;  o += train ? align128(n) : 0;
    rgb = o;    o += ps == TRUNK ? 0 : align128(3 * n);
    w = o;      o += train ? align128(n) : 0;
    trans = o;  o += train ? align128(n) : 0;
    gsig = o;   o += bwd ? align128(n) : 0;
    grgb = o;   o += bwd ? align128(sizeof(float) * rpb * 4) : 0;
    total = o + 1024;                     // room to align the base
    pts_wg = bwd ? 4 * ST_LD : PTS_WG;
  }
};

// Ring stages of a block: 3, or 2 where long rays would not fit 227 KB
// with 3.
inline int ring_stages(int S, int rpb, Pass pass) {
  return FbLayout(S, rpb, 3, pass).total <= MAX_SMEM ? 3 : 2;
}

// A block's rays in shared memory: the regions of layout L at `base`;
// load() brings in one group of rays.
struct RayBlock {
  RaySmem sm;
  Extra ex;
  int ray0, nray, npt, ntile;
  __device__ RayBlock(unsigned char* base, const FbLayout& L,
                      const RayArgs& a) : sm{}, ex{} {
    const bool train = L.pass == FWD || L.pass == BWD, bwd = L.pass == BWD;
    auto at = [&](size_t off) {
      return reinterpret_cast<float*>(base + off);
    };
    sm.rays = at(L.rays);
    sm.z = at(L.z);
    sm.sig = at(L.sig);
    sm.rgb = L.pass == TRUNK ? nullptr : at(L.rgb);
    ex.noise = train && a.noise ? at(L.noise) : nullptr;
    ex.w = train ? at(L.w) : nullptr;
    ex.trans = train ? at(L.trans) : nullptr;
    ex.gsig = bwd ? at(L.gsig) : nullptr;
    ex.grgb = bwd ? at(L.grgb) : nullptr;
    ray0 = nray = npt = 0;
    ntile = (a.rpb * a.S + AT - 1) / AT;
  }
  // Rays g rpb .. of the launch, by threads tid of n (rays past R are
  // zero rows); the caller syncs them before the data is read.
  __device__ void load(const RayArgs& a, int g, int tid, int n) {
    ray0 = g * a.rpb;
    nray = min(a.rpb, a.R - ray0);
    npt = nray * a.S;
    const size_t p0 = (size_t)ray0 * a.S;
    for (int i = tid; i < a.rpb * 8; i += n)
      sm.rays[i] = i < nray * 8 ? a.rays[(size_t)ray0 * 8 + i] : 0.f;
    for (int i = tid; i < npt; i += n) {
      sm.z[i] = a.z[p0 + i];
      if (ex.noise) ex.noise[i] = a.noise[p0 + i];
    }
  }
};

// The warpgroup's rows of tile t0 (block points t0 ..): each row's point
// o + d z and, DIRS, its direction into pts (6 floats a row), zero at or
// past nv.
template <bool DIRS = true>
__device__ __forceinline__ void ray_points(const Wg& wg, const RaySmem& sm,
                                           int S, int t0, int nv,
                                           float* pts) {
  if (wg.t < 64) {
    const int r = 64 * wg.g + wg.t;
    float* q = pts + wg.t * 6;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[c] = r < nv ? point_coord(sm, S, t0 + r, c) : 0.f;
      if (DIRS) q[3 + c] = r < nv ? sm.rays[((t0 + r) / S) * 8 + 3 + c] : 0.f;
    }
  }
}

}  // namespace nerf
