// The NeRF MLP's widths, its weights in the kernels' layout and the input
// embedding's columns, shared by every kernel: the tile loops on wgmma
// (mlp_wgmma.cuh), the blocks of rays (ray_tile.cuh) and the weight
// gradients (mlp_grad.cuh). No kernel or tile loop is defined here.
//
// The embedding is what `_trunk_body` of nerf_pl_tpu/ops/fused_mlp.py
// computes: gamma(x) as one sin() over an exact f32 phase block (cos
// columns = sin(t + pi/2)), laid out as one K dimension [raw (8) | zero
// (8) | sin/cos], the same for the x skip at layer 4 and, narrower, for
// gamma(d).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace nerf {

using bf16 = __nv_bfloat16;

constexpr int W = 256;          // trunk width
constexpr int WD = 128;         // view-branch width
constexpr int D = 8;            // trunk depth
constexpr int SKIP = 4;         // trunk layer receiving the x skip
constexpr int XS = 16;          // first sin/cos column of both inputs
constexpr int KX = XS + 64;     // xyz input: raw (8) | zero (8) | sin/cos (64)
constexpr int KD = XS + 32;     // dir input: raw (8) | zero (8) | sin/cos (32)
constexpr int NX = 60;          // real xyz sin/cos columns (10 freqs x 6)
constexpr int ND = 24;          // real dir sin/cos columns (4 freqs x 6)
constexpr float HALF_PI = 1.57079632679489662f;

// Weights in the kernel layout (see ops/fused_render.py kernel_layout).
struct MlpWeights {
  const bf16* w0;    // (KX, W)      layer 0, rows [raw xyz | 0 | sin/cos]
  const bf16* wt;    // (D-1, W, W)  layers 1..7 (h part of layer 4)
  const bf16* wsk;   // (KX, W)      x part of the layer-4 skip
  const float* bt;   // (D, W)
  const bf16* ws;    // (W,)         sigma head
  const float* bs;   // (1,)
  const bf16* wf;    // (W, W)       feature layer
  const float* bf;   // (W,)
  const bf16* wdf;   // (W, WD)      view layer, feature rows
  const bf16* wdd;   // (KD, WD)     view layer, [raw dir | 0 | sin/cos] rows
  const float* bd;   // (WD,)
  const bf16* wr;    // (WD, 4)      rgb head, cols 0..2
  const float* br;   // (4,)
};

// The weights from the C entry points' pointers (biases f32, the rest
// bf16); a pass that does not read a buffer may pass null for it.
inline MlpWeights weights_at(const void* w0, const void* wt, const void* wsk,
                             const void* bt, const void* ws, const void* bs,
                             const void* wf, const void* bf, const void* wdf,
                             const void* wdd, const void* bd, const void* wr,
                             const void* br) {
  MlpWeights p{};
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
  return p;
}

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

// Point gp of the block (rays and z in shared memory, sm.rays and sm.z):
// o + d * z, rounded like the plain version.
template <class M>
__device__ __forceinline__ float point_coord(const M& sm, int S, int gp,
                                             int c) {
  const float* ray = sm.rays + (gp / S) * 8;
  return __fadd_rn(ray[c], __fmul_rn(ray[3 + c], sm.z[gp]));
}

// Column j of the sin/cos block of value v: frequency 2^(j/6), channel
// (j % 3), cos (as sin(t + pi/2)) when j % 6 >= 3. sinf, not __sinf: the
// phase reaches 2^9 |x|, far outside the fast sine's accurate range.
__device__ __forceinline__ float sincos_col(float v, int j) {
  float t = v * static_cast<float>(1 << (j / 6));
  if (j % 6 >= 3) t = __fadd_rn(t, HALF_PI);
  return sinf(t);
}

}  // namespace nerf
