// Loss-fused training render: forward, MSE cotangent and the whole backward
// of one NeRF MLP over a ray batch, gradients as outputs.
//
// Replaces fused_mse_render (nerf_pl_tpu/ops/fused_train.py, body
// _mse_fwdbwd_kernel). Per tile of rays it computes the points o + d*z,
// gamma(x) and gamma(d), the MLP forward in bf16 with f32 sums, the
// training quadrature with sigma noise (rgb, depth, opacity and the (R, S)
// weights), the cotangent 2 * scale * (rgb - gt), the analytic quadrature
// VJP and the MLP's weight gradients: 3x the forward's FLOPs, no forward
// run twice.
//
// Why it is not carried over block by block: the TPU kernel keeps the
// weights, every activation of a tile and 2.4 MB of f32 gradient
// accumulators in VMEM across a sequential grid. Here blocks run
// concurrently, a block has at most 227 KB of shared memory, and a 64-point
// tile's activations alone are 2432 bf16 per point (~310 KB). So the work
// is split in three launches, none with float atomics (two launches on the
// same inputs give bit-identical gradients):
//
//   A  mse_fwdbwd   one block per rpb whole rays (nerf_mlp.cuh's tile and
//                   per-warp weight streaming). The forward stores every
//                   bf16 activation of its points to a global scratch; a
//                   warp per ray runs the quadrature and its VJP in f32
//                   (warp scans: the exclusive prefix sum for T and a true
//                   exclusive suffix sum for dL/do = a T exp(-o) - suffix,
//                   never a (T - w), which cancels for saturated samples);
//                   then, tile by tile, the data-gradient chain from the
//                   heads' cotangents (mlp_grad.cuh backward_from_heads).
//   B  wgrad        every dW = act^T dz (mlp_grad.cuh),
//   C  sum_slots    then the ordered sums of its slots and of the blocks'
//                   bias partials (mlp_grad.cuh).
//
// What bounds it: tensor-core work, ~3 x 1.21 MFLOP per point. Device
// memory sees ~10 KB of bf16 scratch per point (written by A, read by B),
// about 1.3 GB at the fine pass of a 1024-ray batch, and the partial slots.
// Weight gradients are summed over points in f32 (WMMA accumulators, then
// the slots); bias gradients sum the f32 cotangents.
//
// Launch contract: the caller's stream, no allocation (the caller passes a
// workspace of nerf_mse_workspace_bytes(R, S)), and the entry point returns
// the first CUDA error of its launches.
#include <cuda_runtime.h>

#include "mlp_grad.cuh"

namespace nerf {

struct TrainArgs : GradArgs {
  const float* rays;
  const float* z;
  const float* noise;
  const float* gt;          // (R, 3)
  int R, S, rpb, white_back;
  float scale;
  float* out8;
  float* weights;
  float* bias_part;         // (gridDim.x, NBIAS)
};

// The render kernels' shared memory plus the training quadrature's.
struct TrainLayout {
  SmemLayout base;
  size_t noise, w, trans, gsig, grgb, dzr, total;
  __host__ __device__ TrainLayout(int S, int rpb) : base(S, rpb, true) {
    const size_t n = sizeof(float) * rpb * S;
    size_t o = base.total;
    noise = o;  o += align128(n);
    w = o;      o += align128(n);
    trans = o;  o += align128(n);
    gsig = o;   o += align128(n);
    grgb = o;   o += align128(sizeof(float) * rpb * 4);
    dzr = o;    o += align128(sizeof(float) * TP * 4);
    total = o;
  }
};

struct Extra {
  float* noise;   // rpb * S
  float* w;       // rpb * S   quadrature weights
  float* trans;   // rpb * S   transmittance
  float* gsig;    // rpb * S   dL/dsigma
  float* grgb;    // rpb x 4   dL/drgb of each ray
  float* dzr;     // TP x 4    rgb-head and sigma cotangents of a tile
};

// delta_k = (z_{k+1} - z_k) |d| (1e10 |d| for the last) and its optical
// depth delta_k relu(sigma_k + noise_k); rounded like the plain version.
__device__ __forceinline__ float sample_delta(const float* zr, int s, int S,
                                              float dn) {
  return __fmul_rn(s + 1 < S ? zr[s + 1] - zr[s] : 1e10f, dn);
}

// Warp per ray: forward quadrature (weights, out8) and its VJP (dL/dsigma
// per sample, dL/drgb per ray).
__device__ void quad_train(const TrainArgs& a, const Smem& sm, const Extra& ex,
                           int nray, int ray0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = a.S;
  for (int r = warp; r < nray; r += NWARPS) {
    const float* ray = sm.rays + r * 8;
    const float dn = sqrtf(__fadd_rn(
        __fadd_rn(__fmul_rn(ray[3], ray[3]), __fmul_rn(ray[4], ray[4])),
        __fmul_rn(ray[5], ray[5])));
    const float* zr = sm.z + r * S;
    const float* sr = sm.sig + r * S;
    const float* nr = ex.noise + r * S;
    const float* cr = sm.rgb + (size_t)r * S * 3;
    float* wr = ex.w + r * S;
    float* tr = ex.trans + r * S;
    float carry = 0.f, op = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      float o = 0.f;
      if (s < S)
        o = __fmul_rn(sample_delta(zr, s, S, dn), fmaxf(sr[s] + nr[s], 0.f));
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
        const float w = (1.f - expf(-o)) * t;
        wr[s] = w;
        tr[s] = t;
        a.weights[(size_t)(ray0 + r) * S + s] = w;
        op += w;
        c0 += w * cr[s * 3 + 0];
        c1 += w * cr[s * 3 + 1];
        c2 += w * cr[s * 3 + 2];
        dep += w * zr[s];
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      op += __shfl_xor_sync(0xffffffffu, op, m);
      c0 += __shfl_xor_sync(0xffffffffu, c0, m);
      c1 += __shfl_xor_sync(0xffffffffu, c1, m);
      c2 += __shfl_xor_sync(0xffffffffu, c2, m);
      dep += __shfl_xor_sync(0xffffffffu, dep, m);
    }
    const size_t gr = (size_t)ray0 + r;
    const float bg = a.white_back ? 1.f - op : 0.f;
    const float rgb0 = c0 + bg, rgb1 = c1 + bg, rgb2 = c2 + bg;
    const float two_s = 2.f * a.scale;
    const float g0 = two_s * (rgb0 - a.gt[gr * 3 + 0]);
    const float g1 = two_s * (rgb1 - a.gt[gr * 3 + 1]);
    const float g2 = two_s * (rgb2 - a.gt[gr * 3 + 2]);
    const float gsum = (g0 + g1) + g2;
    if (lane < 8) {
      const float v[8] = {rgb0, rgb1, rgb2, dep, op, 0.f, 0.f, 0.f};
      a.out8[gr * 8 + lane] = v[lane];
    }
    if (lane == 0) {
      ex.grgb[r * 4 + 0] = g0;
      ex.grgb[r * 4 + 1] = g1;
      ex.grgb[r * 4 + 2] = g2;
    }

    // VJP, last chunk first: suffix_k = sum_{i > k} a_i w_i.
    float later = 0.f;                     // sum of a w over later chunks
    for (int s0 = ((S - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
      const int s = s0 + lane;
      float av = 0.f, aw = 0.f;
      if (s < S) {
        av = g0 * cr[s * 3 + 0];
        av = av + g1 * cr[s * 3 + 1];
        av = av + g2 * cr[s * 3 + 2];
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
        const float s_eff = sr[s] + nr[s];
        const float o = __fmul_rn(delta, fmaxf(s_eff, 0.f));
        const float d_o = av * tr[s] * expf(-o) - exc;
        ex.gsig[r * S + s] = s_eff > 0.f ? d_o * delta : 0.f;
      }
    }
  }
}

// The backward of points [t0, t0 + nv) of the block, whose first point is
// global point g0: the rgb-head cotangent g c (1 - c), g = w dL/drgb, and
// dL/dsigma per point, then the shared data-gradient chain.
__device__ void backward_tile(const TrainArgs& a, const Smem& sm,
                              const Extra& ex, int t0, int nv, size_t g0,
                              float* __restrict__ bias) {
  const int tid = threadIdx.x;
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, gs = 0.f;
  if (tid < nv) {
    const int gp = t0 + tid;
    const float w = ex.w[gp];
    const float* c = sm.rgb + (size_t)gp * 3;
    const float* g = ex.grgb + (gp / a.S) * 4;
    v0 = w * g[0] * c[0] * (1.f - c[0]);
    v1 = w * g[1] * c[1] * (1.f - c[1]);
    v2 = w * g[2] * c[2] * (1.f - c[2]);
    gs = ex.gsig[gp];
  }
  backward_from_heads(a, sm, ex.dzr, v0, v1, v2, gs, nv, g0, bias);
}

__global__ void __launch_bounds__(NTHREADS, 2)
mse_fwdbwd_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TrainLayout L(a.S, a.rpb);
  const Smem sm = smem_at(smem_raw, L.base);
  Extra ex;
  ex.noise = reinterpret_cast<float*>(smem_raw + L.noise);
  ex.w = reinterpret_cast<float*>(smem_raw + L.w);
  ex.trans = reinterpret_cast<float*>(smem_raw + L.trans);
  ex.gsig = reinterpret_cast<float*>(smem_raw + L.gsig);
  ex.grgb = reinterpret_cast<float*>(smem_raw + L.grgb);
  ex.dzr = reinterpret_cast<float*>(smem_raw + L.dzr);

  const int S = a.S;
  const int ray0 = blockIdx.x * a.rpb;
  const int nray = min(a.rpb, a.R - ray0);
  const int P = nray * S;                  // valid points of this block
  const size_t p0 = (size_t)ray0 * S;      // its first global point
  float* bias = a.bias_part + (size_t)blockIdx.x * NBIAS;
  for (int i = threadIdx.x; i < a.rpb * 8; i += NTHREADS)
    sm.rays[i] = i < nray * 8 ? a.rays[(size_t)ray0 * 8 + i] : 0.f;
  for (int i = threadIdx.x; i < P; i += NTHREADS) {
    sm.z[i] = a.z[p0 + i];
    ex.noise[i] = a.noise[p0 + i];
  }
  for (int i = threadIdx.x; i < NBIAS; i += NTHREADS) bias[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < P; t0 += TP) {     // forward, keeping activations
    const int nv = min(TP, P - t0);
    const size_t g0 = p0 + t0;
    build_inputs<true>(sm, S, t0, P);
    __syncthreads();
    copy_rows(sm.x, LDX, a.s.x + g0 * KX, KX, nv);
    copy_rows(sm.d, LDD, a.s.d + g0 * KD, KD, nv);
    const ActSink keep{a.s.act + g0 * W, a.s.P * W, a.s.feat + g0 * W,
                       a.s.hd + g0 * WD};
    mlp_tile<true, true>(a.p, sm, sm.sig + t0, sm.rgb + (size_t)t0 * 3, nv,
                         &keep);
    __syncthreads();
  }
  quad_train(a, sm, ex, nray, ray0);
  __syncthreads();
  for (int t0 = 0; t0 < P; t0 += TP) {     // backward, tile by tile
    backward_tile(a, sm, ex, t0, min(TP, P - t0), p0 + t0, bias);
    __syncthreads();
  }
}

}  // namespace nerf

using nerf::bf16;

extern "C" {

long long nerf_mse_workspace_bytes(int R, int S) {
  const int rpb = nerf::rays_per_block(S);
  return static_cast<long long>(
      nerf::Workspace((size_t)R * S, (R + rpb - 1) / rpb).total);
}

// Floats of the gradient buffer of both training kernels (mse_render and
// mlp_bwd): the weight gradients, then the bias gradients.
int nerf_grad_floats() { return nerf::EW + nerf::NBIAS; }

int nerf_mse_render(const void* rays, const void* z, const void* noise,
                    const void* gt, int R, int S, const void* w0,
                    const void* wt, const void* wsk, const void* bt,
                    const void* ws, const void* bs, const void* wf,
                    const void* bf, const void* wdf, const void* wdd,
                    const void* bd, const void* wr, const void* br,
                    const void* wdfT, const void* wfT, const void* wtT,
                    int white_back, float scale, void* out8, void* weights,
                    void* workspace, void* grad, void* stream) {
  using namespace nerf;
  if (R <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rpb = rays_per_block(S);
  const Workspace wsp((size_t)R * S, (R + rpb - 1) / rpb);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  TrainArgs a{};
  a.rays = static_cast<const float*>(rays);
  a.z = static_cast<const float*>(z);
  a.noise = static_cast<const float*>(noise);
  a.gt = static_cast<const float*>(gt);
  a.R = R;
  a.S = S;
  a.rpb = rpb;
  a.white_back = white_back;
  a.scale = scale;
  a.p = weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br);
  a.wdfT = static_cast<const bf16*>(wdfT);
  a.wfT = static_cast<const bf16*>(wfT);
  a.wtT = static_cast<const bf16*>(wtT);
  a.out8 = static_cast<float*>(out8);
  a.weights = static_cast<float*>(weights);
  a.s = scratch_at(base, wsp.P);
  a.bias_part = reinterpret_cast<float*>(base + wsp.bias);

  const TrainLayout L(S, rpb);
  cudaError_t err = cudaFuncSetAttribute(
      mse_fwdbwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  mse_fwdbwd_kernel<<<wsp.grid_a, NTHREADS, L.total, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(
      a.s, wsp, base, a.bias_part, static_cast<float*>(grad), st));
}

}  // extern "C"
