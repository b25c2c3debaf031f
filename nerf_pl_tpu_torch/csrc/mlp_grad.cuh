// The weight-gradient backward of the NeRF point MLP, shared by the two
// training kernels (fused_train.cu's mse_render and fused_mlp.cu's mlp_bwd).
//
// Both start from per-point cotangents of the MLP's heads (the rgb head's
// pre-activation and raw sigma) and a forward that kept every bf16
// activation of its points in a global scratch (nerf_mlp.cuh's KEEP sink).
// What they share:
//
//   backward_from_heads  per tile of TP points, the data-gradient chain
//                        dz_i = mask_i (dz_{i+1} @ W_i^T) on the tensor cores
//                        (transposed weights streamed like the forward's),
//                        each dz_i stored as bf16 (exactly what the TPU's
//                        _dot_t casts) and its f32 column sums added to the
//                        block's own row of bias partials;
//   launch B  wgrad      every dW = act^T dz, K = points, as a split-K WMMA
//                        product: 64 x 64 output tiles, the points in fixed
//                        chunks, each chunk into its own partial slot;
//   launch C  sum_slots  the slots, then the blocks' bias partials, summed in
//                        a fixed order.
//
// No float atomics: two launches on the same inputs give bit-identical
// gradients. The gradient buffer is the weight gradients in the kernels'
// layout (ops/fused_mlp.py kernel_layout), then the bias gradients.
//
// The kernels here have internal linkage: each translation unit that
// includes this header gets its own copy.
#pragma once

#include <cuda_runtime.h>

#include "nerf_mlp.cuh"

namespace nerf {

// Bias gradients: [bt (D x W) | bf (W) | bd (WD) | br (3) | bs (1)].
constexpr int BT = 0, BF = D * W, BD = BF + W, BR = BD + WD, BS = BR + 3;
constexpr int NBIAS = BS + 1;

// Weight-gradient products act^T @ dz, in the kernels' weight layout
// (ops/fused_mlp.py kernel_layout). The sigma and rgb heads share one
// 16-wide dz block (cols 0..2 rgb, col 3 sigma).
constexpr int DZR_W = 16;
constexpr int NJOBS = 14;
constexpr int EW = KX * W + (D - 1) * W * W + KX * W + W * W + W * WD +
                   KD * WD + W * DZR_W + WD * DZR_W;

// Per-point bf16 scratch, P points, one dense matrix per kind.
struct Scratch {
  bf16 *x, *d, *act, *feat, *hd, *dz, *dfeat, *dzd, *dzr;
  size_t P;
};
constexpr int SCRATCH_W = KX + KD + D * W + W + WD + D * W + W + WD + DZR_W;

// What the data-gradient chain reads: the forward's weights, the
// transposed matrices its products stream (dz @ W^T), and the scratch.
struct GradArgs {
  MlpWeights p;
  const bf16* wdfT;         // (WD, W)
  const bf16* wfT;          // (W, W)
  const bf16* wtT;          // (D - 1, W, W)
  Scratch s;
};

inline __device__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Epilogue of a backward product: v = acc (+ bf16(dL/dsigma) * ws when
// SIG, dL/dsigma in column 3 of the TP x 4 dzr), zeroed where the layer's
// bf16 activation is not > 0 (MASK) and on rows past nv; bf16(v) goes to h
// (the next product's operand) and to the scratch `out`, and the f32
// column sums of v are added to `bias`.
template <bool MASK, bool SIG>
__device__ __forceinline__ void store_grad(FragC (&acc)[8],
                                           const bf16* __restrict__ act,
                                           const float* dzr,
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
        v += bf16_round(dzr[row * 4 + 3]) * __bfloat162float(ws[col]);
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

// The backward of the points [g0, g0 + nv) of the scratch, one tile, from
// the cotangents of their heads: thread tid < TP holds those of point tid
// (v0..v2 on the rgb head's pre-activation, gs on raw sigma; zero at or
// past nv). Stores them as bf16 (scratch dzr) and in f32 in dzr_s (TP x 4,
// shared memory), then every data gradient of the tile (dzd, dfeat, dz),
// and adds the f32 column sums to the block's bias partials.
inline __device__ void backward_from_heads(const GradArgs& a, const Smem& sm,
                                           float* dzr_s, float v0, float v1,
                                           float v2, float gs, int nv,
                                           size_t g0,
                                           float* __restrict__ bias) {
  const int tid = threadIdx.x;
  const size_t PW = a.s.P * W;
  if (tid < TP) {
    if (tid < nv) {
      bf16* row = a.s.dzr + (g0 + tid) * DZR_W;
      row[0] = __float2bfloat16_rn(v0);
      row[1] = __float2bfloat16_rn(v1);
      row[2] = __float2bfloat16_rn(v2);
      row[3] = __float2bfloat16_rn(gs);
      for (int c2 = 4; c2 < DZR_W; ++c2) row[c2] = __float2bfloat16_rn(0.f);
    }
    dzr_s[tid * 4 + 0] = v0;
    dzr_s[tid * 4 + 1] = v1;
    dzr_s[tid * 4 + 2] = v2;
    dzr_s[tid * 4 + 3] = gs;
  }
  __syncthreads();
  if (tid < 4) {                       // br (cols 0..2) and bs (col 3)
    float s = 0.f;
    for (int pt = 0; pt < TP; ++pt) s += dzr_s[pt * 4 + tid];
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
        const float* r4 = dzr_s + pt * 4;
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
  store_grad<false, false>(acc, nullptr, dzr_s, a.p.ws, sm,
                           a.s.dfeat + g0 * W, bias + BF, nv);
  __syncthreads();
  zero(acc);                           // + sigma head -> last trunk layer
  gemm_acc<2>(acc, sm.h, LDH, a.wfT, W, sm.slab);
  __syncthreads();
  store_grad<true, true>(acc, a.s.act + (D - 1) * PW + g0 * W, dzr_s,
                         a.p.ws, sm, a.s.dz + (D - 1) * PW + g0 * W,
                         bias + BT + (D - 1) * W, nv);
  for (int i = D - 1; i >= 1; --i) {   // trunk layers 6 .. 0
    __syncthreads();
    zero(acc);
    gemm_acc<2>(acc, sm.h, LDH, a.wtT + (size_t)(i - 1) * W * W, W, sm.slab);
    __syncthreads();
    store_grad<true, false>(acc, a.s.act + (i - 1) * PW + g0 * W, dzr_s,
                            a.p.ws, sm, a.s.dz + (i - 1) * PW + g0 * W,
                            bias + BT + (i - 1) * W, nv);
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
static __global__ void __launch_bounds__(256)
wgrad_kernel(GJobs jobs, int P, int kchunk, float* __restrict__ part) {
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
static __global__ void sum_slots(const float* __restrict__ part, int nslot,
                                 size_t n, size_t ld,
                                 float* __restrict__ out) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nslot; ++k) s += part[(size_t)k * ld + e];
    out[e] = s;
  }
}

// ------------------------------------------------------------------ host --

inline size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// Workspace of P points whose launch A runs grid_a blocks: bf16 scratch,
// weight-gradient slots, bias partials (one row per block of launch A).
struct Workspace {
  size_t P;
  int grid_a, kchunk, nchunk;
  size_t part, bias, total;   // byte offsets
  Workspace(size_t P_, int grid_a_) : P(P_), grid_a(grid_a_) {
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

// Launches B and C after a launch A over the scratch `s`: the weight
// gradients into grad[0, EW), the bias partials' sums into grad[EW, EW +
// NBIAS). Returns the first CUDA error.
static cudaError_t launch_weight_grads(const Scratch& s, const Workspace& wsp,
                                       unsigned char* base,
                                       const float* bias_part, float* grad,
                                       cudaStream_t st) {
  float* part = reinterpret_cast<float*>(base + wsp.part);
  const GJobs jobs = make_jobs(s);
  wgrad_kernel<<<dim3(n_tiles(jobs), wsp.nchunk), 256, 0, st>>>(
      jobs, static_cast<int>(wsp.P), wsp.kchunk, part);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_slots<<<(EW + 255) / 256, 256, 0, st>>>(part, wsp.nchunk, EW, EW, grad);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_slots<<<(NBIAS + 255) / 256, 256, 0, st>>>(bias_part, wsp.grid_a, NBIAS,
                                                 NBIAS, grad + EW);
  return cudaGetLastError();
}

}  // namespace nerf
