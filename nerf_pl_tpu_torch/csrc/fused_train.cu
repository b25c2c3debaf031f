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
// the MLP forward in bf16 with f32 sums and the training quadrature with
// sigma noise (quad_forward, shared by the three as the TPU kernels share
// _quad_forward). The two backwards then form a_k = dL/dw_k from their
// cotangent (a template policy: the MSE cotangent, or the given g8 and gw),
// run the analytic quadrature VJP (quad_vjp) and the weight gradients.
// train_bwd recomputes the forward, as the TPU backward does, so the
// two-kernel path does one forward more than mse_render.
//
// Why it is not carried over block by block: the TPU kernel keeps the
// weights, every activation of a tile and 2.4 MB of f32 gradient
// accumulators in VMEM across a sequential grid. Here blocks run
// concurrently, a block has at most 227 KB of shared memory, and a 64-point
// tile's activations alone are 2432 bf16 per point (~310 KB). So each
// backward is three launches, none with float atomics (two launches on the
// same inputs give bit-identical gradients):
//
//   A  fwdbwd       one block per rpb whole rays (nerf_mlp.cuh's tile and
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
// train_fwd is launch A's forward half without the activation sink.
//
// A ragged R is masked: a block's rays past R are zero rows whose outputs
// are never written and whose cotangents are zero. (The TPU wrapper refuses
// an R that is not a multiple of 8 instead; the train CLI keeps that rule.)
//
// What bounds them: tensor-core work, 1.19 MFLOP per point forward and
// 2.94x that for a backward (the forward, the data gradients down to layer
// 0's output, the weight gradients). Device memory sees ~10 KB of bf16
// scratch per point in a backward (written by A, read by B), about 1.3 GB
// at the fine pass of a 1024-ray batch, and the partial slots; train_fwd
// sees only per-ray and per-sample f32 data. Weight gradients are summed
// over points in f32 (WMMA accumulators, then the slots); bias gradients
// sum the f32 cotangents.
//
// Launch contract: the caller's stream, no allocation (a backward takes a
// workspace of nerf_mse_workspace_bytes(R, S)), and the entry points return
// the first CUDA error of their launches.
#include <cuda_runtime.h>

#include "mlp_grad.cuh"

namespace nerf {

struct TrainArgs : GradArgs {
  const float* rays;
  const float* z;
  const float* noise;
  const float* gt;          // (R, 3)  mse_render
  const float* g8;          // (R, 8)  train_bwd: [d rgb (3), d depth, d op]
  const float* gw;          // (R, S)  train_bwd, may be null
  int R, S, rpb, white_back;
  float scale;
  float* out8;
  float* weights;
  float* bias_part;         // (gridDim.x, NBIAS)
};

// The render kernels' shared memory plus the training quadrature's, and
// for a backward its VJP's (gsig, grgb, dzr; empty for train_fwd).
struct TrainLayout {
  SmemLayout base;
  size_t noise, w, trans, gsig, grgb, dzr, total;
  __host__ __device__ TrainLayout(int S, int rpb, bool backward)
      : base(S, rpb, true) {
    const size_t n = sizeof(float) * rpb * S;
    const size_t vjp = backward ? 1 : 0;
    size_t o = base.total;
    noise = o;  o += align128(n);
    w = o;      o += align128(n);
    trans = o;  o += align128(n);
    gsig = o;   o += vjp * align128(n);
    grgb = o;   o += vjp * align128(sizeof(float) * rpb * 4);
    dzr = o;    o += vjp * align128(sizeof(float) * TP * 4);
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

__device__ __forceinline__ Extra extra_at(unsigned char* raw,
                                          const TrainLayout& L) {
  Extra ex;
  ex.noise = reinterpret_cast<float*>(raw + L.noise);
  ex.w = reinterpret_cast<float*>(raw + L.w);
  ex.trans = reinterpret_cast<float*>(raw + L.trans);
  ex.gsig = reinterpret_cast<float*>(raw + L.gsig);
  ex.grgb = reinterpret_cast<float*>(raw + L.grgb);
  ex.dzr = reinterpret_cast<float*>(raw + L.dzr);
  return ex;
}

// The block's rays, depths and noise into shared memory; rays past R are
// zero rows. Returns the block's valid points.
__device__ int load_rays(const TrainArgs& a, const Smem& sm, const Extra& ex,
                         int ray0, int nray) {
  const int P = nray * a.S;
  const size_t p0 = (size_t)ray0 * a.S;
  for (int i = threadIdx.x; i < a.rpb * 8; i += NTHREADS)
    sm.rays[i] = i < nray * 8 ? a.rays[(size_t)ray0 * 8 + i] : 0.f;
  for (int i = threadIdx.x; i < P; i += NTHREADS) {
    sm.z[i] = a.z[p0 + i];
    ex.noise[i] = a.noise[p0 + i];
  }
  return P;
}

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

// Warp per ray: the training quadrature of ray r of the block (the TPU
// kernels' _quad_forward). T_k = exp(-exclusive prefix sum of o_k), no
// +1e-10; w_k and T_k of each sample go to ex.w and ex.trans, w_k also to
// wglob unless it is null. Every lane returns the ray's sums.
__device__ RayQuad quad_forward(const TrainArgs& a, const Smem& sm,
                                const Extra& ex, int r, float dn,
                                float* wglob) {
  const int lane = threadIdx.x & 31;
  const int S = a.S;
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
      if (wglob) wglob[s] = w;
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
  const float bg = a.white_back ? 1.f - op : 0.f;
  return {c0 + bg, c1 + bg, c2 + bg, dep, op};
}

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
__device__ void quad_vjp(const TrainArgs& a, const Smem& sm, const Extra& ex,
                         int r, float dn, const RayCot& g) {
  const int lane = threadIdx.x & 31;
  const int S = a.S;
  const float* zr = sm.z + r * S;
  const float* sr = sm.sig + r * S;
  const float* nr = ex.noise + r * S;
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
      const float s_eff = sr[s] + nr[s];
      const float o = __fmul_rn(delta, fmaxf(s_eff, 0.f));
      const float d_o = av * tr[s] * expf(-o) - exc;
      ex.gsig[r * S + s] = s_eff > 0.f ? d_o * delta : 0.f;
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

// train_fwd: the forward and the quadrature, out8 and the weights.
__global__ void __launch_bounds__(NTHREADS, 2)
train_fwd_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TrainLayout L(a.S, a.rpb, false);
  const Smem sm = smem_at(smem_raw, L.base);
  const Extra ex = extra_at(smem_raw, L);
  const int S = a.S;
  const int ray0 = blockIdx.x * a.rpb;
  const int nray = min(a.rpb, a.R - ray0);
  const int P = load_rays(a, sm, ex, ray0, nray);
  __syncthreads();

  for (int t0 = 0; t0 < P; t0 += TP) {
    build_inputs<true>(sm, S, t0, P);
    __syncthreads();
    mlp_tile<true>(a.p, sm, sm.sig + t0, sm.rgb + (size_t)t0 * 3,
                   min(TP, P - t0));
    __syncthreads();
  }
  for (int r = threadIdx.x >> 5; r < nray; r += NWARPS) {
    const size_t gr = (size_t)ray0 + r;
    const RayQuad q = quad_forward(a, sm, ex, r, dir_norm(sm.rays + r * 8),
                                   a.weights + gr * S);
    write_out8(a.out8 + gr * 8, q);
  }
}

// Launch A of both backwards. !GIVEN (mse_render): writes out8 and the
// weights and forms the MSE cotangent; GIVEN (train_bwd): takes g8 and gw.
template <bool GIVEN>
__global__ void __launch_bounds__(NTHREADS, 2)
fwdbwd_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TrainLayout L(a.S, a.rpb, true);
  const Smem sm = smem_at(smem_raw, L.base);
  const Extra ex = extra_at(smem_raw, L);
  const int S = a.S;
  const int ray0 = blockIdx.x * a.rpb;
  const int nray = min(a.rpb, a.R - ray0);
  const size_t p0 = (size_t)ray0 * S;      // the block's first global point
  float* bias = a.bias_part + (size_t)blockIdx.x * NBIAS;
  const int P = load_rays(a, sm, ex, ray0, nray);
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

  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nray; r += NWARPS) {
    const size_t gr = (size_t)ray0 + r;
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
    if (lane == 0) {
      ex.grgb[r * 4 + 0] = g.g0;
      ex.grgb[r * 4 + 1] = g.g1;
      ex.grgb[r * 4 + 2] = g.g2;
    }
    quad_vjp<GIVEN>(a, sm, ex, r, dn, g);
  }
  __syncthreads();
  for (int t0 = 0; t0 < P; t0 += TP) {     // backward, tile by tile
    backward_tile(a, sm, ex, t0, min(TP, P - t0), p0 + t0, bias);
    __syncthreads();
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
  a.rpb = rays_per_block(S);
  a.white_back = white_back;
  a.p = p;
  return a;
}

inline int grid_of(const TrainArgs& a) { return (a.R + a.rpb - 1) / a.rpb; }

template <typename Kernel>
cudaError_t launch_a(Kernel kernel, const TrainArgs& a, bool backward,
                     cudaStream_t st) {
  const TrainLayout L(a.S, a.rpb, backward);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(a), NTHREADS, L.total, st>>>(a);
  return cudaGetLastError();
}

// Launches A, B and C of a backward: the scratch and the bias partials in
// the workspace, the gradients into grad.
template <bool GIVEN>
int launch_backward(TrainArgs a, const void* wdfT, const void* wfT,
                    const void* wtT, void* workspace, void* grad,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace wsp((size_t)a.R * a.S, grid_of(a));
  unsigned char* base = static_cast<unsigned char*>(workspace);
  a.wdfT = static_cast<const bf16*>(wdfT);
  a.wfT = static_cast<const bf16*>(wfT);
  a.wtT = static_cast<const bf16*>(wtT);
  a.s = scratch_at(base, wsp.P);
  a.bias_part = reinterpret_cast<float*>(base + wsp.bias);
  cudaError_t err = launch_a(fwdbwd_kernel<GIVEN>, a, true, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(
      a.s, wsp, base, a.bias_part, static_cast<float*>(grad), st));
}

}  // namespace nerf

using nerf::bf16;

extern "C" {

long long nerf_mse_workspace_bytes(int R, int S) {
  const int rpb = nerf::rays_per_block(S);
  return static_cast<long long>(
      nerf::Workspace((size_t)R * S, (R + rpb - 1) / rpb).total);
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
                    const void* wdfT, const void* wfT, const void* wtT,
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
  return launch_backward<false>(a, wdfT, wfT, wtT, workspace, grad, stream);
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
      launch_a(train_fwd_kernel, a, false,
               static_cast<cudaStream_t>(stream)));
}

int nerf_train_bwd(const void* rays, const void* z, const void* noise,
                   const void* g8, const void* gw, int R, int S,
                   const void* w0, const void* wt, const void* wsk,
                   const void* bt, const void* ws, const void* bs,
                   const void* wf, const void* bf, const void* wdf,
                   const void* wdd, const void* bd, const void* wr,
                   const void* br, const void* wdfT, const void* wfT,
                   const void* wtT, int white_back, void* workspace,
                   void* grad, void* stream) {
  using namespace nerf;
  if (R <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs a = train_args(
      rays, z, noise, R, S,
      weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br),
      white_back);
  a.g8 = static_cast<const float*>(g8);
  a.gw = static_cast<const float*>(gw);
  return launch_backward<true>(a, wdfT, wfT, wtT, workspace, grad, stream);
}

}  // extern "C"
