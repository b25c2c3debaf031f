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
//                   then, tile by tile, the data-gradient chain
//                   dz_i = mask_i (dz_{i+1} @ W_i^T) on the tensor cores
//                   (transposed weights streamed like the forward's), each
//                   dz_i stored as bf16 (exactly what the TPU's _dot_t
//                   casts) and its f32 column sums added to the block's own
//                   row of bias partials.
//   B  wgrad        every dW = act^T dz, K = points (up to 1024 x 192), as
//                   a split-K WMMA product: 64 x 64 output tiles, the points
//                   in fixed chunks, each chunk into its own partial slot.
//   C  sum_slots    the slots, then the blocks' bias partials, summed in a
//                   fixed order.
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

#include "nerf_mlp.cuh"

namespace nerf {

// Bias gradients: [bt (D x W) | bf (W) | bd (WD) | br (3) | bs (1)].
constexpr int BT = 0, BF = D * W, BD = BF + W, BR = BD + WD, BS = BR + 3;
constexpr int NBIAS = BS + 1;

// Weight-gradient products act^T @ dz, in the kernels' weight layout
// (ops/fused_render.py kernel_layout). The sigma and rgb heads share one
// 16-wide dz block (cols 0..2 rgb, col 3 sigma).
constexpr int DZR_W = 16;
constexpr int NJOBS = 14;
constexpr int EW = KX * W + (D - 1) * W * W + KX * W + W * W + W * WD +
                   KD * WD + W * DZR_W + WD * DZR_W;

// Per-point bf16 scratch, P = R * S points, one dense matrix per kind.
struct Scratch {
  bf16 *x, *d, *act, *feat, *hd, *dz, *dfeat, *dzd, *dzr;
  size_t P;
};
constexpr int SCRATCH_W = KX + KD + D * W + W + WD + D * W + W + WD + DZR_W;

struct TrainArgs {
  const float* rays;
  const float* z;
  const float* noise;
  const float* gt;          // (R, 3)
  int R, S, rpb, white_back;
  float scale;
  MlpWeights p;
  const bf16* wdfT;         // (WD, W)
  const bf16* wfT;          // (W, W)
  const bf16* wtT;          // (D - 1, W, W)
  float* out8;
  float* weights;
  Scratch s;
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// Epilogue of a backward product: v = acc (+ bf16(dL/dsigma) * ws when
// SIG), zeroed where the layer's bf16 activation is not > 0 (MASK) and on
// rows past nv; bf16(v) goes to h (the next product's operand) and to the
// scratch `out`, and the f32 column sums of v are added to `bias`.
template <bool MASK, bool SIG>
__device__ __forceinline__ void store_grad(FragC (&acc)[8],
                                           const bf16* __restrict__ act,
                                           const Extra& ex,
                                           const bf16* __restrict__ ws,
                                           const Smem& sm,
                                           bf16* __restrict__ out,
                                           float* __restrict__ bias, int nv) {
  constexpr int NCB = 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = warp * 16 * NCB;
  float* st = sm.stage + warp * 256;
  float cs[NCB] = {0.f, 0.f};
#pragma unroll
  for (int f = 0; f < 4 * NCB; ++f) {
    const int rb = f / NCB, j = f - rb * NCB;
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    const int col = col0 + j * 16 + (lane & 15);
    float part = 0.f;
    for (int e = lane; e < 256; e += 32) {
      const int row = rb * 16 + (e >> 4);
      float v = st[e];
      if (SIG)
        v += bf16_round(ex.dzr[row * 4 + 3]) * __bfloat162float(ws[col]);
      bool keep = row < nv;
      if (MASK && keep)
        keep = __bfloat162float(act[(size_t)row * W + col]) > 0.f;
      if (!keep) v = 0.f;
      part += v;
      const bf16 b = __float2bfloat16_rn(v);
      sm.h[row * LDH + col] = b;
      if (row < nv) out[(size_t)row * W + col] = b;
    }
    part += __shfl_xor_sync(0xffffffffu, part, 16);  // lanes l, l^16: col
    cs[j] += part;
    __syncwarp();
  }
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < NCB; ++j) bias[col0 + j * 16 + lane] += cs[j];
  }
}

// The data-gradient chain of points [t0, t0 + nv) of the block, whose
// first point is global point g0.
__device__ void backward_tile(const TrainArgs& a, const Smem& sm,
                              const Extra& ex, int t0, int nv, size_t g0,
                              float* __restrict__ bias) {
  const int tid = threadIdx.x;
  const int S = a.S;
  const size_t PW = a.s.P * W;

  // rgb-head cotangent g c (1 - c), g = w dL/drgb, and dL/dsigma per point
  if (tid < TP) {
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, gs = 0.f;
    if (tid < nv) {
      const int gp = t0 + tid;
      const float w = ex.w[gp];
      const float* c = sm.rgb + (size_t)gp * 3;
      const float* g = ex.grgb + (gp / S) * 4;
      v0 = w * g[0] * c[0] * (1.f - c[0]);
      v1 = w * g[1] * c[1] * (1.f - c[1]);
      v2 = w * g[2] * c[2] * (1.f - c[2]);
      gs = ex.gsig[gp];
      bf16* row = a.s.dzr + (g0 + tid) * DZR_W;
      row[0] = __float2bfloat16_rn(v0);
      row[1] = __float2bfloat16_rn(v1);
      row[2] = __float2bfloat16_rn(v2);
      row[3] = __float2bfloat16_rn(gs);
      for (int c2 = 4; c2 < DZR_W; ++c2) row[c2] = __float2bfloat16_rn(0.f);
    }
    ex.dzr[tid * 4 + 0] = v0;
    ex.dzr[tid * 4 + 1] = v1;
    ex.dzr[tid * 4 + 2] = v2;
    ex.dzr[tid * 4 + 3] = gs;
  }
  __syncthreads();
  if (tid < 4) {                       // br (cols 0..2) and bs (col 3)
    float s = 0.f;
    for (int pt = 0; pt < TP; ++pt) s += ex.dzr[pt * 4 + tid];
    bias[tid < 3 ? BR + tid : BS] += s;
  }

  {  // view layer: dz_d = [hd > 0] (bf16(dz_r) @ wr^T), into h[:, :WD]
    const int j = tid & (WD - 1);
    const float w0 = __bfloat162float(a.p.wr[j * 4 + 0]);
    const float w1 = __bfloat162float(a.p.wr[j * 4 + 1]);
    const float w2 = __bfloat162float(a.p.wr[j * 4 + 2]);
    float cs = 0.f;
    for (int pt = tid / WD; pt < TP; pt += NTHREADS / WD) {
      float v = 0.f;
      if (pt < nv) {
        const float* r4 = ex.dzr + pt * 4;
        const float dh = bf16_round(r4[0]) * w0 + bf16_round(r4[1]) * w1 +
                         bf16_round(r4[2]) * w2;
        if (__bfloat162float(a.s.hd[(g0 + pt) * WD + j]) > 0.f) v = dh;
        a.s.dzd[(g0 + pt) * WD + j] = __float2bfloat16_rn(v);
      }
      cs += v;
      sm.h[pt * LDH + j] = __float2bfloat16_rn(v);
    }
    sm.stage[tid] = cs;
  }
  __syncthreads();
  if (tid < WD) bias[BD + tid] += sm.stage[tid] + sm.stage[tid + WD];

  FragC acc[8];
  zero(acc);                           // feature layer (linear)
  gemm_acc<2>(acc, sm.h, LDH, a.wdfT, WD, sm.slab);
  __syncthreads();
  store_grad<false, false>(acc, nullptr, ex, a.p.ws, sm, a.s.dfeat + g0 * W,
                           bias + BF, nv);
  __syncthreads();
  zero(acc);                           // + sigma head -> last trunk layer
  gemm_acc<2>(acc, sm.h, LDH, a.wfT, W, sm.slab);
  __syncthreads();
  store_grad<true, true>(acc, a.s.act + (D - 1) * PW + g0 * W, ex, a.p.ws,
                         sm, a.s.dz + (D - 1) * PW + g0 * W,
                         bias + BT + (D - 1) * W, nv);
  for (int i = D - 1; i >= 1; --i) {   // trunk layers 6 .. 0
    __syncthreads();
    zero(acc);
    gemm_acc<2>(acc, sm.h, LDH, a.wtT + (size_t)(i - 1) * W * W, W, sm.slab);
    __syncthreads();
    store_grad<true, false>(acc, a.s.act + (i - 1) * PW + g0 * W, ex, a.p.ws,
                            sm, a.s.dz + (i - 1) * PW + g0 * W,
                            bias + BT + (i - 1) * W, nv);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
mse_fwdbwd_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TrainLayout L(a.S, a.rpb);
  Smem sm;
  sm.h = reinterpret_cast<bf16*>(smem_raw + L.base.h);
  sm.x = reinterpret_cast<bf16*>(smem_raw + L.base.x);
  sm.d = reinterpret_cast<bf16*>(smem_raw + L.base.d);
  sm.slab = reinterpret_cast<bf16*>(smem_raw + L.base.slab);
  sm.stage = reinterpret_cast<float*>(smem_raw + L.base.stage);
  sm.rays = reinterpret_cast<float*>(smem_raw + L.base.rays);
  sm.z = reinterpret_cast<float*>(smem_raw + L.base.z);
  sm.sig = reinterpret_cast<float*>(smem_raw + L.base.sig);
  sm.rgb = reinterpret_cast<float*>(smem_raw + L.base.rgb);
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

// ------------------------------------------------------ weight gradients --

struct GJob {
  const bf16* A;    // (P, M) activations
  const bf16* B;    // (P, N) cotangents
  int M, N, off;    // out block (M, N) at `off` of a slot
  int tiles_n, tile0;
};
struct GJobs {
  GJob j[NJOBS];
};

constexpr int GT = 64;          // output tile
constexpr int GK = 32;          // points per shared-memory stage
constexpr int GLD = GT + 8;

using FragAc =
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

// One 16-byte vector of the A and the B stage per thread; rows past k_end
// and columns past M / N are zero.
__device__ __forceinline__ void load_stage(bf16* As, bf16* Bs, const GJob& jb,
                                           int m0, int n0, int k, int k_end) {
  const int lr = threadIdx.x >> 3, lc = (threadIdx.x & 7) * 8;
  const int kr = k + lr;
  bf16* da = As + lr * GLD + lc;
  bf16* db = Bs + lr * GLD + lc;
  if (kr < k_end && m0 + lc < jb.M)
    cp_async16(da, jb.A + (size_t)kr * jb.M + m0 + lc);
  else
    *reinterpret_cast<uint4*>(da) = make_uint4(0, 0, 0, 0);
  if (kr < k_end && n0 + lc < jb.N)
    cp_async16(db, jb.B + (size_t)kr * jb.N + n0 + lc);
  else
    *reinterpret_cast<uint4*>(db) = make_uint4(0, 0, 0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Block (tile, chunk): out tile of one job over points [k_begin, k_end),
// into slot blockIdx.y. Warp w owns rows (w / 2) * 16 and 32 columns.
__global__ void __launch_bounds__(256) wgrad_kernel(GJobs jobs, int P,
                                                    int kchunk,
                                                    float* __restrict__ part) {
  constexpr int STAGE = GK * GLD;
  __shared__ __align__(128) unsigned char raw[4 * STAGE * sizeof(bf16)];
  bf16* As = reinterpret_cast<bf16*>(raw);           // 2 stages
  bf16* Bs = As + 2 * STAGE;                          // 2 stages
  const int t = blockIdx.x;
  int ji = 0;
  while (ji + 1 < NJOBS && t >= jobs.j[ji + 1].tile0) ++ji;
  const GJob& jb = jobs.j[ji];
  const int local = t - jb.tile0;
  const int m0 = (local / jb.tiles_n) * GT, n0 = (local % jb.tiles_n) * GT;
  const int k_begin = blockIdx.y * kchunk;
  const int k_end = min(P, k_begin + kchunk);
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;

  FragC acc[2];
  zero(acc);
  const int nstage = (k_end - k_begin + GK - 1) / GK;
  if (nstage > 0) load_stage(As, Bs, jb, m0, n0, k_begin, k_end);
  for (int s = 0; s < nstage; ++s) {
    if (s + 1 < nstage) {
      const int nb = ((s + 1) & 1) * STAGE;
      load_stage(As + nb, Bs + nb, jb, m0, n0, k_begin + (s + 1) * GK,
                 k_end);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const bf16* as = As + (s & 1) * STAGE;
    const bf16* bs = Bs + (s & 1) * STAGE;
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      FragAc fa;
      wmma::load_matrix_sync(fa, as + kk * GLD + wm, GLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, bs + kk * GLD + wn + j * 16, GLD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * EW + jb.off;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + wm, n = n0 + wn + j * 16;
    if (m < jb.M && n < jb.N)
      wmma::store_matrix_sync(out + (size_t)m * jb.N + n, acc[j], jb.N,
                              wmma::mem_row_major);
  }
}

// out[e] = sum over slots k = 0, 1, ... of part[k * ld + e], in that order.
__global__ void sum_slots(const float* __restrict__ part, int nslot,
                          size_t n, size_t ld, float* __restrict__ out) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nslot; ++k) s += part[(size_t)k * ld + e];
    out[e] = s;
  }
}

// ------------------------------------------------------------------ host --

inline size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// Workspace: bf16 scratch, weight-gradient slots, bias partials.
struct Workspace {
  size_t P;
  int rpb, grid_a, kchunk, nchunk;
  size_t part, bias, total;   // byte offsets
  Workspace(int R, int S) {
    P = (size_t)R * S;
    rpb = rays_per_block(S);
    grid_a = (R + rpb - 1) / rpb;
    // >= 2048 points per chunk and at most 64 slots
    const size_t per = (P + 63) / 64;
    kchunk = static_cast<int>(per > 2048 ? (per + GK - 1) / GK * GK : 2048);
    nchunk = static_cast<int>((P + kchunk - 1) / kchunk);
    part = align256(sizeof(bf16) * P * SCRATCH_W);
    bias = part + align256(sizeof(float) * (size_t)nchunk * EW);
    total = bias + align256(sizeof(float) * (size_t)grid_a * NBIAS);
  }
};

inline Scratch scratch_at(void* base, size_t P) {
  Scratch s;
  bf16* o = static_cast<bf16*>(base);
  s.P = P;
  s.x = o;      o += P * KX;
  s.d = o;      o += P * KD;
  s.act = o;    o += P * D * W;
  s.feat = o;   o += P * W;
  s.hd = o;     o += P * WD;
  s.dz = o;     o += P * D * W;
  s.dfeat = o;  o += P * W;
  s.dzd = o;    o += P * WD;
  s.dzr = o;
  return s;
}

inline GJobs make_jobs(const Scratch& s) {
  const size_t PW = s.P * W;
  const GJob spec[NJOBS] = {
      {s.x, s.dz, KX, W},                           // w0
      {s.act + 0 * PW, s.dz + 1 * PW, W, W},        // wt[0..6]
      {s.act + 1 * PW, s.dz + 2 * PW, W, W},
      {s.act + 2 * PW, s.dz + 3 * PW, W, W},
      {s.act + 3 * PW, s.dz + 4 * PW, W, W},
      {s.act + 4 * PW, s.dz + 5 * PW, W, W},
      {s.act + 5 * PW, s.dz + 6 * PW, W, W},
      {s.act + 6 * PW, s.dz + 7 * PW, W, W},
      {s.x, s.dz + SKIP * PW, KX, W},               // wsk
      {s.act + 7 * PW, s.dfeat, W, W},              // wf
      {s.feat, s.dzd, W, WD},                       // wdf
      {s.d, s.dzd, KD, WD},                         // wdd
      {s.act + 7 * PW, s.dzr, W, DZR_W},            // ws (col 3)
      {s.hd, s.dzr, WD, DZR_W},                     // wr (cols 0..2)
  };
  GJobs jobs;
  int off = 0, tile = 0;
  for (int i = 0; i < NJOBS; ++i) {
    GJob j = spec[i];
    j.off = off;
    j.tiles_n = (j.N + GT - 1) / GT;
    j.tile0 = tile;
    off += j.M * j.N;
    tile += ((j.M + GT - 1) / GT) * j.tiles_n;
    jobs.j[i] = j;
  }
  return jobs;
}

inline int n_tiles(const GJobs& jobs) {
  const GJob& l = jobs.j[NJOBS - 1];
  return l.tile0 + ((l.M + GT - 1) / GT) * l.tiles_n;
}

}  // namespace nerf

using nerf::bf16;

extern "C" {

long long nerf_mse_workspace_bytes(int R, int S) {
  return static_cast<long long>(nerf::Workspace(R, S).total);
}

int nerf_mse_grad_floats() { return nerf::EW + nerf::NBIAS; }

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
  const Workspace wsp(R, S);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  TrainArgs a{};
  a.rays = static_cast<const float*>(rays);
  a.z = static_cast<const float*>(z);
  a.noise = static_cast<const float*>(noise);
  a.gt = static_cast<const float*>(gt);
  a.R = R;
  a.S = S;
  a.rpb = wsp.rpb;
  a.white_back = white_back;
  a.scale = scale;
  a.p.w0 = static_cast<const bf16*>(w0);
  a.p.wt = static_cast<const bf16*>(wt);
  a.p.wsk = static_cast<const bf16*>(wsk);
  a.p.bt = static_cast<const float*>(bt);
  a.p.ws = static_cast<const bf16*>(ws);
  a.p.bs = static_cast<const float*>(bs);
  a.p.wf = static_cast<const bf16*>(wf);
  a.p.bf = static_cast<const float*>(bf);
  a.p.wdf = static_cast<const bf16*>(wdf);
  a.p.wdd = static_cast<const bf16*>(wdd);
  a.p.bd = static_cast<const float*>(bd);
  a.p.wr = static_cast<const bf16*>(wr);
  a.p.br = static_cast<const float*>(br);
  a.wdfT = static_cast<const bf16*>(wdfT);
  a.wfT = static_cast<const bf16*>(wfT);
  a.wtT = static_cast<const bf16*>(wtT);
  a.out8 = static_cast<float*>(out8);
  a.weights = static_cast<float*>(weights);
  a.s = scratch_at(base, wsp.P);
  a.bias_part = reinterpret_cast<float*>(base + wsp.bias);
  float* part = reinterpret_cast<float*>(base + wsp.part);
  float* g = static_cast<float*>(grad);

  const TrainLayout L(S, wsp.rpb);
  cudaError_t err = cudaFuncSetAttribute(
      mse_fwdbwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  mse_fwdbwd_kernel<<<wsp.grid_a, NTHREADS, L.total, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const GJobs jobs = make_jobs(a.s);
  wgrad_kernel<<<dim3(n_tiles(jobs), wsp.nchunk), 256, 0, st>>>(
      jobs, static_cast<int>(wsp.P), wsp.kchunk, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  sum_slots<<<(EW + 255) / 256, 256, 0, st>>>(part, wsp.nchunk, EW, EW, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sum_slots<<<(NBIAS + 255) / 256, 256, 0, st>>>(
      a.bias_part, wsp.grid_a, NBIAS, NBIAS, g + EW);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
