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
//   A  fwdbwd       one block per rpb whole rays, tiles of 128 points on
//                   wgmma (see "launch A on Hopper" below). The forward
//                   stores every bf16 activation of its points to a global
//                   scratch; a warp per ray runs the quadrature and its VJP
//                   in f32 (warp scans: the exclusive prefix sum for T and
//                   a true exclusive suffix sum for dL/do = a T exp(-o) -
//                   suffix, never a (T - w), which cancels for saturated
//                   samples); then, tile by tile, the data-gradient chain
//                   from the heads' cotangents.
//   B  wgrad        every dW = act^T dz (mlp_grad.cuh, wgmma),
//   C  sum_slots    then the ordered sums of its slots and of the bias
//      sum_rows     partials, one row per consumer warpgroup of A.
// train_fwd is nerf_mlp.cuh's WMMA forward with the training quadrature;
// its redesign is later work.
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
  float* bias_part;         // (rows, NBIAS)
  uint4* bits;              // launch A's ReLU masks (MASK_TILE_BYTES a tile)
};

// train_fwd's shared memory: the render kernels' plus the training
// quadrature's.
struct TrainLayout {
  SmemLayout base;
  size_t noise, w, trans, total;
  __host__ __device__ TrainLayout(int S, int rpb) : base(S, rpb, true) {
    const size_t n = sizeof(float) * rpb * S;
    size_t o = base.total;
    noise = o;  o += align128(n);
    w = o;      o += align128(n);
    trans = o;  o += align128(n);
    total = o;
  }
};

// The per-point and per-ray f32 data of the quadrature and its VJP.
struct Extra {
  float* noise;   // rpb * S
  float* w;       // rpb * S   quadrature weights
  float* trans;   // rpb * S   transmittance
  float* gsig;    // rpb * S   dL/dsigma (backward)
  float* grgb;    // rpb x 4   dL/drgb of each ray (backward)
};

__device__ __forceinline__ Extra extra_at(unsigned char* raw,
                                          const TrainLayout& L) {
  Extra ex{};
  ex.noise = reinterpret_cast<float*>(raw + L.noise);
  ex.w = reinterpret_cast<float*>(raw + L.w);
  ex.trans = reinterpret_cast<float*>(raw + L.trans);
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

// train_fwd: the forward and the quadrature, out8 and the weights.
__global__ void __launch_bounds__(NTHREADS, 2)
train_fwd_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TrainLayout L(a.S, a.rpb);
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

// ------------------------------------------------- launch A on Hopper --
//
// Replaces the TPU's _mse_fwdbwd_kernel and _train_bwd_kernel
// (nerf_pl_tpu/ops/fused_train.py) up to their weight gradients, which are
// launch B's. Bound: see the note at the top (0.305 ms of tensor-core work
// and 0.39 ms of scratch writes at P = 131,072).
//
// One block per rpb whole rays: their points in tiles of AT = 128, two
// consumer warpgroups (warpgroup g owns rows 64 g .. 64 g + 63 of a tile,
// 232 registers a thread) and a producer warpgroup (40 registers; one
// thread issues the TMA loads). Shared memory (bytes, FbLayout):
//   xd    32,768   the tile's inputs as two 64-column swizzled tiles:
//                  gamma(x) cols 0..63, then [gamma(x) 64..79 | gamma(d)]
//   h     65,536   the tile's activations / cotangents, 4 swizzled tiles,
//                  the A operand of every product (K-major)
//   ring  nst x 32,768   weight slabs, TMA-filled by the producer
//   stage 8,448    per-warp column sums (the bias gradients)
//   dzr   2,048    the tile's head cotangents, f32
//   bias  9,728    bt, bf and bd for the forward's epilogues
//   + per ray and per point f32 (rays, z, sigma, noise, rgb, quadrature
//     weights, transmittance, dL/dsigma: 36 bytes a point) and barriers.
// nst = 3 (2 for a ray of more than ~390 samples, which would not fit in
// 227 KB). At S = 128: rpb = 1, 222,848 bytes with the alignment slack,
// so one block per SM, and a batch of R = 1024 is 1024 blocks, 7.8 waves
// of 132 SMs; at S = 64: rpb = 2, 512 blocks, 3.9 waves.
//
// The producer streams the same sequence of 32 KB weight slabs (64 rows
// of K) for every tile: forward (W read MN-major, no copy) then backward
// (dz W^T: the same W read K-major, so the host builds no transposed
// weights). Each layer is a chain of m64n256k16 (view layer n128) wgmma
// per warpgroup over the slabs, one group in flight, the slab released to
// the producer as soon as its group has completed. The epilogue works on
// the accumulators in registers: bias and ReLU (forward), the sigma-head
// term, the ReLU mask and the column sums (backward); it writes bf16 once
// into h (the next layer's operand) and the warpgroup's leader copies the
// rows to the global scratch with one TMA store per 64 columns. The two
// warpgroups meet only at the quadrature; within a tile they depend on no
// one's rows but their own, so one's epilogue overlaps the other's
// products.
//
// The backward's ReLU masks are bits that the forward's epilogue writes
// (16 bytes a thread and layer, a global area of 36 KB a tile) and the
// backward reads 16 bytes before each layer's products, in the same
// fragment layout: 1/16 of the bytes of reading the stored bf16
// activations back, 4 registers instead of 64 in flight, and no room in
// shared memory needed (a tile's masks, 34 KB, do not fit beside the
// ring).

constexpr int AT = 128;                   // points per tile
constexpr int A_THREADS = 384;            // 2 consumer + 1 producer WG
constexpr uint32_t SLAB_BYTES = 4 * BOX_BYTES;
constexpr uint32_t ATILE = AT * SWZ_ROW;  // one 64-column tile of AT rows
constexpr size_t MAX_SMEM = 232448;       // a block's shared memory
constexpr int N_EPI_BIAS = D * W + W + WD;   // bt, bf, bd: the epilogues'
// A row of the column-sum stage: 256 columns, one padding float per 32 so
// that the 8 lane groups of warp_colsums write 8 different banks.
constexpr int ST_LD = 256 + 8;
__device__ __forceinline__ int st_col(int c) { return c + (c >> 5); }

inline int a_rays_per_block(int S) { return S >= AT ? 1 : AT / S; }

// The block grid of launch A over R rays of S samples and its scratch
// rows (whole tiles per block; rows of the last tile past the block's
// points are zero cotangents).
struct AShape {
  int rpb, ntile, grid;
  size_t rows;
  AShape(int R, int S)
      : rpb(a_rays_per_block(S)),
        ntile((a_rays_per_block(S) * S + AT - 1) / AT),
        grid((R + a_rays_per_block(S) - 1) / a_rays_per_block(S)),
        rows((size_t)grid * ntile * AT) {}
};

struct FbLayout {
  size_t xd, h, ring, stage, dzr, bias, bar, rays, z, sig, noise, rgb, w,
      trans, gsig, grgb, total;
  __host__ __device__ FbLayout(int S, int rpb, int nst) {
    const size_t n = sizeof(float) * rpb * S;
    size_t o = 0;
    xd = o;     o += 2 * ATILE;
    h = o;      o += 4 * ATILE;
    ring = o;   o += (size_t)nst * SLAB_BYTES;
    stage = o;  o += sizeof(float) * 8 * ST_LD;
    dzr = o;    o += sizeof(float) * AT * 4;
    bias = o;   o += sizeof(float) * N_EPI_BIAS;
    bar = o;    o += align128(2 * 8 * nst);
    rays = o;   o += align128(sizeof(float) * rpb * 8);
    z = o;      o += align128(n);
    sig = o;    o += align128(n);
    noise = o;  o += align128(n);
    rgb = o;    o += align128(3 * n);
    w = o;      o += align128(n);
    trans = o;  o += align128(n);
    gsig = o;   o += align128(n);
    grgb = o;   o += align128(sizeof(float) * rpb * 4);
    total = o + 1024;                     // room to align the base
  }
};

// The weights as TMA maps: boxes of 64 rows for the forward's MN-major
// slabs (4 x 64 columns), of 256 rows for the backward's K-major ones.
struct WeightMaps {
  CUtensorMap w0, wt, wsk, wf, wdf, wdd, wt_b, wf_b, wdf_b;
};

inline bool weight_maps(const MlpWeights& p, WeightMaps* m) {
  return make_map(&m->w0, p.w0, W, KX, 1, 64) &&
         make_map(&m->wt, p.wt, W, W, D - 1, 64) &&
         make_map(&m->wsk, p.wsk, W, KX, 1, 64) &&
         make_map(&m->wf, p.wf, W, W, 1, 64) &&
         make_map(&m->wdf, p.wdf, WD, W, 1, 64) &&
         make_map(&m->wdd, p.wdd, WD, KD, 1, 64) &&
         make_map(&m->wt_b, p.wt, W, W, D - 1, 256) &&
         make_map(&m->wf_b, p.wf, W, W, 1, 256) &&
         make_map(&m->wdf_b, p.wdf, WD, W, 1, 256);
}

// The slab ring as one side sees it: the next slab's stage and phase.
struct Ring {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  int nst, stage;
  uint32_t phase;
  __device__ __forceinline__ void next() {
    if (++stage == nst) {
      stage = 0;
      phase ^= 1;
    }
  }
  __device__ __forceinline__ unsigned char* slab() const {
    return buf + (size_t)stage * SLAB_BYTES;
  }
};

// Producer: one slab of `nbox` boxes (forward: 64 x 64 at columns c0 +
// 64 b, row r0; backward: one 256 x 64 box at column c0).
__device__ __forceinline__ void put_slab(Ring& r, const CUtensorMap* map,
                                         int nbox, int c0, int r0,
                                         int layer, uint32_t box_bytes) {
  mbar_wait(&r.empty[r.stage], r.phase ^ 1);
  mbar_expect_tx(&r.full[r.stage], nbox * box_bytes);
  for (int b = 0; b < nbox; ++b)
    tma_load(r.slab() + b * box_bytes, map, &r.full[r.stage], c0 + 64 * b,
             r0, layer);
  r.next();
}

// The producer's sequence for ntile tiles; the consumers take the same.
__device__ void produce(const WeightMaps& wm, Ring r, int ntile) {
  for (int t = 0; t < ntile; ++t) {
    put_slab(r, &wm.w0, 4, 0, 0, 0, BOX_BYTES);
    put_slab(r, &wm.w0, 4, 0, 64, 0, BOX_BYTES);
    for (int i = 1; i < D; ++i) {
      for (int k = 0; k < W; k += 64)
        put_slab(r, &wm.wt, 4, 0, k, i - 1, BOX_BYTES);
      if (i == SKIP) {
        put_slab(r, &wm.wsk, 4, 0, 0, 0, BOX_BYTES);
        put_slab(r, &wm.wsk, 4, 0, 64, 0, BOX_BYTES);
      }
    }
    for (int k = 0; k < W; k += 64) put_slab(r, &wm.wf, 4, 0, k, 0, BOX_BYTES);
    for (int k = 0; k < W; k += 64)
      put_slab(r, &wm.wdf, 2, 0, k, 0, BOX_BYTES);
    put_slab(r, &wm.wdd, 2, 0, 0, 0, BOX_BYTES);
  }
  for (int t = 0; t < ntile; ++t) {
    for (int k = 0; k < WD; k += 64)
      put_slab(r, &wm.wdf_b, 1, k, 0, 0, SLAB_BYTES);
    for (int k = 0; k < W; k += 64)
      put_slab(r, &wm.wf_b, 1, k, 0, 0, SLAB_BYTES);
    for (int i = D - 1; i >= 1; --i)
      for (int k = 0; k < W; k += 64)
        put_slab(r, &wm.wt_b, 1, k, 0, i - 1, SLAB_BYTES);
  }
}

// Consumer: the products of one slab, nk steps of 16 of K, A from the
// K-major tile at `a`, B the slab (TB: MN-major forward, else K-major)
// from step bk0 on. scale: 0 for a layer's first product. One group stays
// in flight; the previous slab goes back to the producer.
template <int NN, int TB>
__device__ __forceinline__ void slab_mma(float (&acc)[NN / 2], Ring& r,
                                         const unsigned char* a, int nk,
                                         int bk0, int& scale, int& held) {
  mbar_wait(&r.full[r.stage], r.phase);
  const uint64_t da = desc_k(a);
  const uint64_t db = TB ? desc_mn(r.slab(), BOX_BYTES) : desc_k(r.slab());
  const uint32_t bstep = TB ? (16 * SWZ_ROW) >> 4 : 32 >> 4;
  wgmma_fence();
  acc_fence(acc);
  for (int kk = 0; kk < nk; ++kk) {
    if constexpr (NN == 256)
      wgmma_n256<0, TB>(acc, da + kk * 2, db + (bk0 + kk) * bstep, scale);
    else
      wgmma_n128<0, TB>(acc, da + kk * 2, db + (bk0 + kk) * bstep, scale);
    scale = 1;
  }
  wgmma_commit();
  acc_fence(acc);
  wgmma_wait<1>();
  if (held >= 0 && (threadIdx.x & 31) == 0) mbar_arrive(&r.empty[held]);
  held = r.stage;
  r.next();
}

// The end of a layer's products: all complete, the last slab released.
template <int R_>
__device__ __forceinline__ void slabs_done(float (&acc)[R_], Ring& r,
                                           int& held) {
  wgmma_wait<0>();
  acc_fence(acc);
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[held]);
  held = -1;
}

// What a consumer warpgroup knows of itself.
struct Wg {
  int g;             // 0 or 1
  int t;             // thread in the warpgroup
  int warp, lane;    // warp in the warpgroup, lane
  bool leader;       // t == 0: issues its bulk stores
  __device__ __forceinline__ void sync() const { named_sync(2 + g, 128); }
  // Row (in the tile) of accumulator element q of this thread.
  __device__ __forceinline__ int row(int q) const {
    return 64 * g + 16 * warp + (lane >> 2) + 8 * (q >> 1);
  }
};

// Before an epilogue rewrites h: this warpgroup's bulk stores have read
// it and every warp's products are complete.
__device__ __forceinline__ void before_epilogue(const Wg& wg) {
  if (wg.leader) bulk_wait_read();
  wg.sync();
}

// After an epilogue: h is visible to wgmma and TMA; the leader stores the
// warpgroup's rows of the first `ntile64` column tiles to layer `layer` of
// `map` at scratch row `row0` (the tile's first).
__device__ __forceinline__ void after_epilogue(const Wg& wg,
                                               const CUtensorMap* map,
                                               const unsigned char* h,
                                               int ntile64, size_t row0,
                                               int layer) {
  fence_async_smem();
  wg.sync();
  if (wg.leader) {
    for (int c = 0; c < ntile64; ++c)
      tma_store(map, h + c * ATILE + wg.g * 64 * SWZ_ROW, 64 * c,
                static_cast<int>(row0) + 64 * wg.g, layer);
    bulk_commit();
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// Read-only data of the whole launch (weights, biases).
__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The ReLU masks that a backward epilogue needs: one bit per accumulator
// element of its thread (bit 4 j + q of the 128, as acc[4 j + q]: set
// where the forward's stored bf16 activation is > 0), written by the
// forward's epilogue for trunk layers 0..D-1 and the view layer (slot D),
// 16 bytes a thread and layer, and read back 16 bytes before the backward
// layer's products: 1/16 of the activations' bytes, 4 registers.
constexpr int MASK_LAYERS = D + 1;
constexpr size_t MASK_TILE_BYTES = sizeof(uint4) * MASK_LAYERS * 256;

template <int J>
__device__ __forceinline__ uint32_t word(const uint4& m) {
  return J == 0 ? m.x : J == 1 ? m.y : J == 2 ? m.z : m.w;
}

// This thread's element (row, col) of the tile in h, at a0 (its row 0,
// column 2 (lane % 4)) plus the column block's offset: rows 0 and 8 of a
// thread share the swizzle key row % 8.
__device__ __forceinline__ uint32_t frag_off(int j, int key) {
  return (j >> 3) * ATILE + ((((j & 7) ^ key)) << 4);
}

// Mask bits of two bf16 values packed in v (low half first): set where
// the value is > 0 (a positive 16-bit integer).
__device__ __forceinline__ uint32_t pos2(uint32_t v) {
  return (static_cast<int16_t>(v & 0xFFFFu) > 0 ? 1u : 0u) |
         (static_cast<int16_t>(v >> 16) > 0 ? 2u : 0u);
}

// Forward epilogue of an n256 layer: h = bf16(act(acc + bias)) (the bias
// in shared memory), the ReLU mask bits to `bits` (RELU). SIGMA: also the
// sigma head of the rows, raw sigma = h . ws + bs, for tile rows below
// nv, to sig_out[row]. ws is loaded 8 column blocks at a time before it
// is used.
template <bool RELU, bool SIGMA>
__device__ void epi_fwd256(float (&acc)[128], const Wg& wg,
                           const float* bias, uint32_t hs,
                           const MlpWeights& p, float* sig_out, int nv,
                           uint4* bits) {
  const int c0 = 2 * (wg.lane & 3), key = wg.row(0) & 7;
  const uint32_t a0 = hs + wg.row(0) * SWZ_ROW + c0 * 2;
  uint32_t mw[4] = {0u, 0u, 0u, 0u};
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j8 = 0; j8 < 32; j8 += 8) {
    float2 b[8];
    uint32_t w[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      b[jj] = *reinterpret_cast<const float2*>(bias + 8 * (j8 + jj) + c0);
      if (SIGMA) w[jj] = ld_u32(p.ws + 8 * (j8 + jj) + c0);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j8 + jj;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[4 * j + q] + (q & 1 ? b[jj].y : b[jj].x);
        if (RELU) v[q] = fmaxf(v[q], 0.f);
      }
      const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
      const uint32_t a = a0 + frag_off(j, key);
      sts32(a, lo);
      sts32(a + 8 * SWZ_ROW, hi);
      if (RELU) mw[j >> 3] |= (pos2(lo) | pos2(hi) << 2) << ((4 * j) & 31);
      if (SIGMA) {
        const float2 ww = bf2(w[jj]), l = bf2(lo), u = bf2(hi);
        s0 += l.x * ww.x + l.y * ww.y;
        s1 += u.x * ww.x + u.y * ww.y;
      }
    }
  }
  if (RELU) bits[wg.g * 128 + wg.t] = make_uint4(mw[0], mw[1], mw[2], mw[3]);
  if (SIGMA) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    }
    if ((wg.lane & 3) == 0) {
      if (wg.row(0) < nv) sig_out[wg.row(0)] = s0 + p.bs[0];
      if (wg.row(2) < nv) sig_out[wg.row(2)] = s1 + p.bs[0];
    }
  }
}

// Forward epilogue of the view layer (n128): h[:, :WD] = bf16(relu(acc +
// bd)), its mask bits (words 0, 1) to `bits`, and the rgb head of the rows
// below nv: sigmoid(hd . wr + br).
__device__ void epi_view(float (&acc)[64], const Wg& wg, const MlpWeights& p,
                         const float* bd, uint32_t hs, float* rgb_out, int nv,
                         uint4* bits) {
  const int c0 = 2 * (wg.lane & 3), key = wg.row(0) & 7;
  const uint32_t a0 = hs + wg.row(0) * SWZ_ROW + c0 * 2;
  uint32_t mw[2] = {0u, 0u};
  float c[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int j8 = 0; j8 < 16; j8 += 8) {
    float2 b[8];
    uint2 w[8][2];                        // wr rows col, col + 1 (4 bf16)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * (j8 + jj) + c0;
      b[jj] = *reinterpret_cast<const float2*>(bd + col);
      w[jj][0] = __ldg(reinterpret_cast<const uint2*>(p.wr + col * 4));
      w[jj][1] = __ldg(reinterpret_cast<const uint2*>(p.wr + col * 4 + 4));
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j8 + jj;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = fmaxf(acc[4 * j + q] + (q & 1 ? b[jj].y : b[jj].x), 0.f);
      const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
      const uint32_t a = a0 + frag_off(j, key);
      sts32(a, lo);
      sts32(a + 8 * SWZ_ROW, hi);
      const float2 l = bf2(lo), u = bf2(hi);
      mw[j >> 3] |= (pos2(lo) | pos2(hi) << 2) << ((4 * j) & 31);
      const float2 a01 = bf2(w[jj][0].x), a23 = bf2(w[jj][0].y);
      const float2 b01 = bf2(w[jj][1].x), b23 = bf2(w[jj][1].y);
      const float w0[3] = {a01.x, a01.y, a23.x};
      const float w1[3] = {b01.x, b01.y, b23.x};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        c[0][ch] += l.x * w0[ch] + l.y * w1[ch];
        c[1][ch] += u.x * w0[ch] + u.y * w1[ch];
      }
    }
  }
  bits[wg.g * 128 + wg.t] = make_uint4(mw[0], mw[1], 0u, 0u);
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      c[0][ch] += __shfl_xor_sync(0xffffffffu, c[0][ch], m);
      c[1][ch] += __shfl_xor_sync(0xffffffffu, c[1][ch], m);
    }
  if ((wg.lane & 3) == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wg.row(2 * hf);
      if (row < nv)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          rgb_out[row * 3 + ch] = 1.f / (1.f + expf(-(c[hf][ch] + p.br[ch])));
    }
  }
}

// Column sums of the warp's 16 rows, reduced and scattered over the 8
// lanes that share columns (cs[2 j + q]: column 8 j + 2 (lane % 4) + q of
// NJ column blocks, already summed over the thread's two rows), into the
// warp's row of `stage`. Fixed order: deterministic.
template <int NJ>
__device__ __forceinline__ void warp_colsums(float (&cs)[2 * NJ], int lane,
                                             float* stage) {
  constexpr int H = NJ / 2, Q = NJ / 4, E = NJ / 8;
  float a[2 * H], b[2 * Q], c[2 * E];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 2 * H; ++i) {
    const int jj = i >> 1, q = i & 1;
    const float mine = h16 ? cs[2 * (jj + H) + q] : cs[2 * jj + q];
    const float give = h16 ? cs[2 * jj + q] : cs[2 * (jj + H) + q];
    a[i] = mine + __shfl_xor_sync(0xffffffffu, give, 16);
  }
#pragma unroll
  for (int i = 0; i < 2 * Q; ++i) {
    const int jj = i >> 1, q = i & 1;
    const float mine = h8 ? a[2 * (jj + Q) + q] : a[2 * jj + q];
    const float give = h8 ? a[2 * jj + q] : a[2 * (jj + Q) + q];
    b[i] = mine + __shfl_xor_sync(0xffffffffu, give, 8);
  }
#pragma unroll
  for (int i = 0; i < 2 * E; ++i) {
    const int jj = i >> 1, q = i & 1;
    const float mine = h4 ? b[2 * (jj + E) + q] : b[2 * jj + q];
    const float give = h4 ? b[2 * jj + q] : b[2 * (jj + E) + q];
    c[i] = mine + __shfl_xor_sync(0xffffffffu, give, 4);
  }
  const int j0 = (h16 ? H : 0) + (h8 ? Q : 0) + (h4 ? E : 0);
#pragma unroll
  for (int i = 0; i < 2 * E; ++i)
    stage[st_col(8 * (j0 + (i >> 1)) + 2 * (lane & 3) + (i & 1))] = c[i];
}

// Backward epilogue (n256): v = acc (+ bf16(dL/dsigma) ws when SIG),
// zeroed on tile rows at or past nv and where the layer's mask bit in mb
// is clear (MASK); bf16(v) into h, the column sums of v to the warp's row
// of `stage`.
template <bool MASK, bool SIG>
__device__ void epi_bwd256(float (&acc)[128], const Wg& wg, const uint4& mb,
                           const float* dzr_s, const bf16* __restrict__ ws,
                           uint32_t hs, float* stage, int nv) {
  const int c0 = 2 * (wg.lane & 3), key = wg.row(0) & 7;
  const uint32_t a0 = hs + wg.row(0) * SWZ_ROW + c0 * 2;
  const bool ok0 = wg.row(0) < nv, ok1 = wg.row(2) < nv;
  float gs[2] = {0.f, 0.f};
  if (SIG) {
    gs[0] = bf16_round(dzr_s[wg.row(0) * 4 + 3]);
    gs[1] = bf16_round(dzr_s[wg.row(2) * 4 + 3]);
  }
#pragma unroll
  for (int j8 = 0; j8 < 32; j8 += 8) {
    uint32_t w[8];
    if (SIG) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) w[jj] = ld_u32(ws + 8 * (j8 + jj) + c0);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j8 + jj;
      uint32_t m4 = 15u;
      if (MASK) {
        if (j < 8) m4 = word<0>(mb) >> ((4 * j) & 31);
        else if (j < 16) m4 = word<1>(mb) >> ((4 * j) & 31);
        else if (j < 24) m4 = word<2>(mb) >> ((4 * j) & 31);
        else m4 = word<3>(mb) >> ((4 * j) & 31);
      }
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[4 * j + q];
        if (SIG) {
          const float2 ww = bf2(w[jj]);
          v[q] += gs[q >> 1] * (q & 1 ? ww.y : ww.x);
        }
        const bool keep = ((m4 >> q) & 1u) && (q < 2 ? ok0 : ok1);
        v[q] = keep ? v[q] : 0.f;
        acc[4 * j + q] = v[q];
      }
      const uint32_t a = a0 + frag_off(j, key);
      sts32(a, pack_bf16(v[0], v[1]));
      sts32(a + 8 * SWZ_ROW, pack_bf16(v[2], v[3]));
    }
  }
  float cs[64];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    cs[2 * j] = acc[4 * j] + acc[4 * j + 2];
    cs[2 * j + 1] = acc[4 * j + 1] + acc[4 * j + 3];
  }
  warp_colsums<32>(cs, wg.lane, stage + (wg.g * 4 + wg.warp) * ST_LD);
}

// After an epilogue's barrier: the sums of the warpgroup's 4 warp rows of
// `stage` over columns [0, ncol), in order, added to the warpgroup's bias
// row.
__device__ __forceinline__ void add_colsums(const Wg& wg, const float* stage,
                                            float* bias, int ncol) {
  const float* st = stage + wg.g * 4 * ST_LD;
  for (int c = wg.t; c < ncol; c += 128) {
    const int k = st_col(c);
    bias[c] += ((st[k] + st[ST_LD + k]) + st[2 * ST_LD + k]) +
               st[3 * ST_LD + k];
  }
}

// The view layer's backward on the warpgroup's rows, in the n128
// fragment layout: dz_d = [hd > 0] (bf16(dz_r) @ wr^T), bf16 into h[:, :WD]
// and the scratch rows dzd (row0: the tile's first), column sums to the
// warp's row of `stage`.
__device__ void view_backward(const Wg& wg, const uint4& mb,
                              const float* dzr_s, const MlpWeights& p,
                              uint32_t hs, bf16* __restrict__ dzd,
                              float* stage, int nv) {
  const int c0 = 2 * (wg.lane & 3), key = wg.row(0) & 7;
  const uint32_t a0 = hs + wg.row(0) * SWZ_ROW + c0 * 2;
  float d[2][3];
  bool ok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = wg.row(2 * hf);
    ok[hf] = row < nv;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) d[hf][ch] = bf16_round(dzr_s[row * 4 + ch]);
  }
  float cs[32];
#pragma unroll
  for (int j8 = 0; j8 < 16; j8 += 8) {
    uint2 w[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * (j8 + jj) + c0;
      w[jj][0] = __ldg(reinterpret_cast<const uint2*>(p.wr + col * 4));
      w[jj][1] = __ldg(reinterpret_cast<const uint2*>(p.wr + col * 4 + 4));
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j8 + jj, col = 8 * j + c0;
      const uint32_t m4 = (j < 8 ? word<0>(mb) : word<1>(mb)) >> ((4 * j) & 31);
      const float2 a01 = bf2(w[jj][0].x), a23 = bf2(w[jj][0].y);
      const float2 b01 = bf2(w[jj][1].x), b23 = bf2(w[jj][1].y);
      float v[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* r = d[hf];
        v[2 * hf] = r[0] * a01.x + r[1] * a01.y + r[2] * a23.x;
        v[2 * hf + 1] = r[0] * b01.x + r[1] * b01.y + r[2] * b23.x;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = (((m4 >> q) & 1u) && ok[q >> 1]) ? v[q] : 0.f;
      const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
      const uint32_t a = a0 + frag_off(j, key);
      sts32(a, lo);
      sts32(a + 8 * SWZ_ROW, hi);
      *reinterpret_cast<uint32_t*>(dzd + (size_t)wg.row(0) * WD + col) = lo;
      *reinterpret_cast<uint32_t*>(dzd + (size_t)wg.row(2) * WD + col) = hi;
      cs[2 * j] = v[0] + v[2];
      cs[2 * j + 1] = v[1] + v[3];
    }
  }
  warp_colsums<16>(cs, wg.lane, stage + (wg.g * 4 + wg.warp) * ST_LD);
}

// The warpgroup's rows of tile t: gamma(x) and gamma(d) into xd (swizzled)
// and the scratch rows x and d; rows at or past nv are zero. Each row's
// point o + d z and direction are formed once, into `pts` (6 floats a
// tile row).
__device__ void build_tile(const Wg& wg, const Smem& sm, int S, int t0,
                           int nv, unsigned char* xd, bf16* __restrict__ gx,
                           bf16* __restrict__ gd, float* pts) {
  if (wg.t < 64) {
    const int r = 64 * wg.g + wg.t;
    float* q = pts + r * 6;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[c] = r < nv ? point_coord(sm, S, t0 + r, c) : 0.f;
      q[3 + c] = r < nv ? sm.rays[((t0 + r) / S) * 8 + 3 + c] : 0.f;
    }
  }
  wg.sync();
  for (int i = wg.t; i < 64 * (KX / 2); i += 128) {
    const int r = 64 * wg.g + i / (KX / 2), col = 2 * (i % (KX / 2));
    const float* q = pts + r * 6;
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = col + e;
      if (cc < 3) {
        v[e] = q[cc];
      } else if (cc >= XS && cc < XS + NX && r < nv) {
        const int j = cc - XS;
        v[e] = sincos_col(q[j % 3], j);
      }
    }
    const uint32_t b = pack_bf16(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(xd + swz(r, col, AT)) = b;
    *reinterpret_cast<uint32_t*>(gx + (size_t)r * KX + col) = b;
  }
  for (int i = wg.t; i < 64 * (KD / 2); i += 128) {
    const int r = 64 * wg.g + i / (KD / 2), col = 2 * (i % (KD / 2));
    const float* q = pts + r * 6 + 3;
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = col + e;
      if (cc < 3) {
        v[e] = q[cc];
      } else if (cc >= XS && cc < XS + ND && r < nv) {
        const int j = cc - XS;
        v[e] = sincos_col(q[j % 3], j);
      }
    }
    const uint32_t b = pack_bf16(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(xd + swz(r, KX + col, AT)) = b;
    *reinterpret_cast<uint32_t*>(gd + (size_t)r * KD + col) = b;
  }
}

// Launch A of both backwards. !GIVEN (mse_render): writes out8 and the
// weights and forms the MSE cotangent; GIVEN (train_bwd): takes g8 and gw.
template <bool GIVEN>
__global__ void __launch_bounds__(A_THREADS, 1)
fwdbwd_kernel(const __grid_constant__ WeightMaps wm,
              const __grid_constant__ ScratchMaps scm, TrainArgs a,
              int nst) {
  extern __shared__ __align__(1024) unsigned char araw[];
  unsigned char* base = align1024(araw);
  const FbLayout L(a.S, a.rpb, nst);
  unsigned char* xd = base + L.xd;
  unsigned char* h = base + L.h;
  float* stage = reinterpret_cast<float*>(base + L.stage);
  float* dzr_s = reinterpret_cast<float*>(base + L.dzr);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bar);
  Smem sm{};
  sm.rays = reinterpret_cast<float*>(base + L.rays);
  sm.z = reinterpret_cast<float*>(base + L.z);
  sm.sig = reinterpret_cast<float*>(base + L.sig);
  sm.rgb = reinterpret_cast<float*>(base + L.rgb);
  Extra ex{};
  ex.noise = reinterpret_cast<float*>(base + L.noise);
  ex.w = reinterpret_cast<float*>(base + L.w);
  ex.trans = reinterpret_cast<float*>(base + L.trans);
  ex.gsig = reinterpret_cast<float*>(base + L.gsig);
  ex.grgb = reinterpret_cast<float*>(base + L.grgb);

  const int tid = threadIdx.x;
  const int S = a.S;
  const int ray0 = blockIdx.x * a.rpb;
  const int nray = min(a.rpb, a.R - ray0);
  const int npt = nray * S;
  const int ntile = (a.rpb * S + AT - 1) / AT;
  const size_t prow0 = (size_t)blockIdx.x * ntile * AT;
  const size_t p0 = (size_t)ray0 * S;
  Ring ring{base + L.ring, bars, bars + nst, nst, 0, 0};
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 8);       // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  for (int i = tid; i < a.rpb * 8; i += A_THREADS)
    sm.rays[i] = i < nray * 8 ? a.rays[(size_t)ray0 * 8 + i] : 0.f;
  for (int i = tid; i < npt; i += A_THREADS) {
    sm.z[i] = a.z[p0 + i];
    ex.noise[i] = a.noise[p0 + i];
  }
  float* eb = reinterpret_cast<float*>(base + L.bias);
  for (int i = tid; i < N_EPI_BIAS; i += A_THREADS)
    eb[i] = i < D * W       ? a.p.bt[i]
            : i < D * W + W ? a.p.bf[i - D * W]
                            : a.p.bd[i - D * W - W];
  __syncthreads();
  if (tid >= 256) {                       // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256) produce(wm, ring, ntile);
    return;
  }
  regs_alloc<232>();

  Wg wg;
  wg.g = tid >> 7;
  wg.t = tid & 127;
  wg.warp = (tid >> 5) & 3;
  wg.lane = tid & 31;
  wg.leader = wg.t == 0;
  float* bias = a.bias_part + (size_t)(2 * blockIdx.x + wg.g) * NBIAS;
  for (int i = wg.t; i < NBIAS; i += 128) bias[i] = 0.f;
  const unsigned char* hA = h + wg.g * 64 * SWZ_ROW;    // this WG's rows
  const unsigned char* xA = xd + wg.g * 64 * SWZ_ROW;
  const uint32_t hs = smem_u32(h);
  int held = -1;

  for (int t = 0; t < ntile; ++t) {       // forward, keeping activations
    const int t0 = t * AT, nv = min(AT, npt - t0);
    const size_t row0 = prow0 + t0;
    uint4* bits = a.bits + (row0 / AT) * MASK_LAYERS * 256;
    build_tile(wg, sm, S, t0, nv, xd, a.s.x + row0 * KX, a.s.d + row0 * KD,
               stage);
    fence_async_smem();
    wg.sync();
    float acc[128];
    int scale = 0;
    slab_mma<256, 1>(acc, ring, xA, 4, 0, scale, held);       // layer 0
    slab_mma<256, 1>(acc, ring, xA + ATILE, 1, 0, scale, held);
    slabs_done(acc, ring, held);
    before_epilogue(wg);
    epi_fwd256<true, false>(acc, wg, eb, hs, a.p, nullptr, nv, bits);
    after_epilogue(wg, &scm.m[MAP_ACT], h, 4, row0, 0);
    for (int i = 1; i < D; ++i) {
      scale = 0;
      for (int k = 0; k < 4; ++k)
        slab_mma<256, 1>(acc, ring, hA + k * ATILE, 4, 0, scale, held);
      if (i == SKIP) {
        slab_mma<256, 1>(acc, ring, xA, 4, 0, scale, held);
        slab_mma<256, 1>(acc, ring, xA + ATILE, 1, 0, scale, held);
      }
      slabs_done(acc, ring, held);
      before_epilogue(wg);
      if (i == D - 1)                     // + the sigma head
        epi_fwd256<true, true>(acc, wg, eb + i * W, hs, a.p, sm.sig + t0,
                               nv, bits + i * 256);
      else
        epi_fwd256<true, false>(acc, wg, eb + i * W, hs, a.p, nullptr, nv,
                                bits + i * 256);
      after_epilogue(wg, &scm.m[MAP_ACT], h, 4, row0, i);
    }
    scale = 0;                            // feature layer (linear)
    for (int k = 0; k < 4; ++k)
      slab_mma<256, 1>(acc, ring, hA + k * ATILE, 4, 0, scale, held);
    slabs_done(acc, ring, held);
    before_epilogue(wg);
    epi_fwd256<false, false>(acc, wg, eb + D * W, hs, a.p, nullptr, nv,
                             nullptr);
    after_epilogue(wg, &scm.m[MAP_ACT], h, 4, row0, D);
    {                                     // view layer and rgb head
      float av[64];
      scale = 0;
      for (int k = 0; k < 4; ++k)
        slab_mma<128, 1>(av, ring, hA + k * ATILE, 4, 0, scale, held);
      slab_mma<128, 1>(av, ring, xA + ATILE + 32, 3, 0, scale, held);
      slabs_done(av, ring, held);
      before_epilogue(wg);
      epi_view(av, wg, a.p, eb + D * W + W, hs, sm.rgb + (size_t)t0 * 3, nv,
               bits + D * 256);
      after_epilogue(wg, &scm.m[MAP_HD], h, 2, row0, 0);
    }
  }
  if (wg.leader) {                        // the stores are in the scratch
    bulk_wait_all();
    fence_async_all();
  }
  named_sync(1, 256);

  for (int r = tid >> 5; r < nray; r += 8) {   // quadrature and its VJP
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
    if (wg.lane == 0) {
      ex.grgb[r * 4 + 0] = g.g0;
      ex.grgb[r * 4 + 1] = g.g1;
      ex.grgb[r * 4 + 2] = g.g2;
    }
    quad_vjp<GIVEN>(a, sm, ex, r, dn, g);
  }
  named_sync(1, 256);

  for (int t = 0; t < ntile; ++t) {       // backward, tile by tile
    const int t0 = t * AT, nv = min(AT, npt - t0);
    const size_t row0 = prow0 + t0;
    const uint4* bits = a.bits + (row0 / AT) * MASK_LAYERS * 256 + tid;
    uint4 mb = __ldcg(bits + D * 256);
    before_epilogue(wg);
    if (wg.t < 64) {                      // the heads' cotangents
      const int row = 64 * wg.g + wg.t, lp = t0 + row;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, gs = 0.f;
      if (row < nv) {
        const float w = ex.w[lp];
        const float* c = sm.rgb + (size_t)lp * 3;
        const float* g = ex.grgb + (lp / S) * 4;
        v0 = w * g[0] * c[0] * (1.f - c[0]);
        v1 = w * g[1] * c[1] * (1.f - c[1]);
        v2 = w * g[2] * c[2] * (1.f - c[2]);
        gs = ex.gsig[lp];
      }
      float* d4 = dzr_s + row * 4;
      d4[0] = v0;
      d4[1] = v1;
      d4[2] = v2;
      d4[3] = gs;
      uint4* out = reinterpret_cast<uint4*>(a.s.dzr + (row0 + row) * DZR_W);
      out[0] = make_uint4(pack_bf16(v0, v1), pack_bf16(v2, gs), 0u, 0u);
      out[1] = make_uint4(0u, 0u, 0u, 0u);
    }
    wg.sync();
    if (wg.t < 4) {                       // br (cols 0..2) and bs (col 3)
      float s = 0.f;
      for (int r = 0; r < 64; ++r) s += dzr_s[(64 * wg.g + r) * 4 + wg.t];
      bias[wg.t < 3 ? BR + wg.t : BS] += s;
    }
    view_backward(wg, mb, dzr_s, a.p, hs, a.s.dzd + row0 * WD, stage, nv);
    fence_async_smem();
    wg.sync();
    add_colsums(wg, stage, bias + BD, WD);

    float acc[128];
    int scale = 0;                        // feature layer (linear)
    for (int k = 0; k < 2; ++k)
      slab_mma<256, 0>(acc, ring, hA + k * ATILE, 4, 0, scale, held);
    slabs_done(acc, ring, held);
    before_epilogue(wg);
    epi_bwd256<false, false>(acc, wg, mb, dzr_s, a.p.ws, hs, stage, nv);
    after_epilogue(wg, &scm.m[MAP_DZ], h, 4, row0, D);
    add_colsums(wg, stage, bias + BF, W);
    for (int i = D - 1; i >= 0; --i) {    // + sigma head -> trunk 7 .. 0
      mb = __ldcg(bits + i * 256);
      scale = 0;
      for (int k = 0; k < 4; ++k)
        slab_mma<256, 0>(acc, ring, hA + k * ATILE, 4, 0, scale, held);
      slabs_done(acc, ring, held);
      before_epilogue(wg);
      if (i == D - 1)
        epi_bwd256<true, true>(acc, wg, mb, dzr_s, a.p.ws, hs, stage, nv);
      else
        epi_bwd256<true, false>(acc, wg, mb, dzr_s, a.p.ws, hs, stage, nv);
      after_epilogue(wg, &scm.m[MAP_DZ], h, 4, row0, i);
      add_colsums(wg, stage, bias + BT + i * W, W);
    }
  }
  if (wg.leader) bulk_wait_all();
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

cudaError_t launch_train_fwd(const TrainArgs& a, cudaStream_t st) {
  const TrainLayout L(a.S, a.rpb);
  cudaError_t err = cudaFuncSetAttribute(
      train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  train_fwd_kernel<<<grid_of(a), NTHREADS, L.total, st>>>(a);
  return cudaGetLastError();
}

// Launches A, B and C of a backward: the scratch and the bias partials in
// the workspace, the gradients into grad.
template <bool GIVEN>
int launch_backward(TrainArgs a, void* workspace, void* grad, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AShape sh(a.R, a.S);
  a.rpb = sh.rpb;
  const Workspace wsp(sh.rows, 2 * sh.grid, sh.rows / AT * MASK_TILE_BYTES);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  a.s = scratch_at(base, wsp.P);
  a.bias_part = reinterpret_cast<float*>(base + wsp.bias);
  a.bits = reinterpret_cast<uint4*>(base + wsp.extra);
  WeightMaps wm;
  ScratchMaps scm;
  if (!weight_maps(a.p, &wm) || !scratch_maps(a.s, &scm))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nst = FbLayout(a.S, a.rpb, 3).total <= MAX_SMEM ? 3 : 2;
  const size_t smem = FbLayout(a.S, a.rpb, nst).total;
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
