// The weight-gradient backward of the NeRF point MLP, shared by the
// training kernels (fused_train.cu's mse_render and train_bwd, fused_mlp.cu's
// mlp_bwd).
//
// All start from a launch A on wgmma (mlp_wgmma.cuh's forward_tile and
// backward_tile) that keeps every bf16 activation of its points and every
// data gradient (each dz_i stored as bf16, exactly what the TPU's _dot_t
// casts) in a global scratch, and the f32 column sums of the cotangents in
// rows of bias partials. What they share here:
//
//   the scratch layout and its TMA maps;
//   launch B  wgrad      every dW = act^T dz, K = points, as a split-K
//                        wgmma product (see "weight gradients" below);
//   launch C  sum_slots  the slots, then the rows of bias partials, each
//             sum_rows   summed in a fixed order.
//
// No float atomics: two launches on the same inputs give bit-identical
// gradients. The gradient buffer is the weight gradients in the kernels'
// layout (ops/fused_mlp.py kernel_layout), then the bias gradients.
//
// The kernels here have internal linkage: each translation unit that
// includes this header gets its own copy.
#pragma once

#include <cuda_runtime.h>

#include <initializer_list>

#include "hopper.cuh"
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

// What a training backward's launch A reads and fills: the forward's
// weights and the scratch.
struct GradArgs {
  MlpWeights p;
  Scratch s;
};

inline __device__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------------ weight gradients --
//
// Launch B replaces the weight-gradient half of _mlp_grads
// (nerf_pl_tpu/ops/fused_mlp.py), reached from _mse_fwdbwd_kernel and
// _train_bwd_kernel (ops/fused_train.py) and _bwd_kernel (fused_mlp.py),
// which keep 2.4 MB of f32 gradients in VMEM across a sequential grid.
// Here every dW = act^T dz (K = points) is a split-K product into fixed
// slots, summed in order by launch C.
//
// What bounds it: it reads the whole scratch once (~10 KB a point, 1.3 GB
// at P = 131,072: 0.39 ms at 3.35 TB/s) and does 1.19 MFLOP a point (0.16
// ms at 989 TFLOP/s), so bytes. The design keeps the tensor cores fed and
// the scratch read once from device memory:
//   - an output tile of 128 x 256 (two consumer warpgroups of m64n256, the
//     accumulators in registers); the 14 products make 24 tiles;
//   - points in stages of GK = 64 through a ring of GSTAGES TMA stages
//     filled by one producer warp, with full / empty mbarriers;
//   - both operands are point-major in the scratch, so A = act^T and B =
//     dz are read MN-major through wgmma's transpose flags, not copied;
//   - ragged P and the narrow products (M = 80 and 48 for the embeddings,
//     N = 16 for the heads' dzr block, N = 128 for the view layer) rely on
//     TMA's zero fill out of bounds: a tile computes zeros there and
//     stores only the job's block;
//   - nchunk = WAVE / 24 = 5 slots of at least 1024 points, so that the
//     grid is one wave of at most WAVE = 132 blocks (the H100's SMs);
//     blocks of one chunk run side by side and share each dz and act
//     stage through L2.

// The scratch matrices as TMA maps (boxes of 64 points x 64 columns).
enum ScratchMap { MAP_X, MAP_D, MAP_ACT, MAP_HD, MAP_DZ, MAP_DZD, MAP_DZR,
                  N_SCRATCH_MAPS };
struct ScratchMaps {
  CUtensorMap m[N_SCRATCH_MAPS];
};

struct GJob {
  int amap, alayer;   // act side: map and layer (point-major, M wide)
  int bmap, blayer;   // cotangent side (point-major, N wide)
  int M, N, off;      // out block (M, N) at `off` of a slot
  int tile0;          // first tile of this job
};
struct GJobs {
  GJob j[NJOBS];
  int ntiles;
};

constexpr int GT_M = 128;                 // output rows of a tile
constexpr int GK = 64;                    // points per stage
constexpr int GSTAGES = 4;
constexpr int G_THREADS = 288;            // 2 consumer warpgroups + 1 warp
constexpr int WAVE = 132;                 // SMs of an H100 SXM
constexpr uint32_t BOX_BYTES = 64 * SWZ_ROW;             // 64 x 64 bf16
constexpr uint32_t GSTAGE_BYTES = 6 * BOX_BYTES;         // A 2, B 4 boxes
constexpr size_t G_SMEM = GSTAGES * GSTAGE_BYTES + 2 * GSTAGES * 8 + 1024;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// Block (tile, chunk): the out tile of one job over points [k_begin,
// k_end), into slot blockIdx.y. Warpgroup g owns out rows 64 g .. 64 g + 63
// of the tile and all 256 columns.
static __global__ void __launch_bounds__(G_THREADS, 1)
wgrad_kernel(const __grid_constant__ ScratchMaps maps, GJobs jobs, int P,
             int kchunk, float* __restrict__ part) {
  extern __shared__ __align__(1024) unsigned char graw[];
  unsigned char* base = align1024(graw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + GSTAGES * GSTAGE_BYTES);
  uint64_t* empty = full + GSTAGES;
  const int tid = threadIdx.x;
  int ji = 0;
  const int t = blockIdx.x;
  while (ji + 1 < NJOBS && t >= jobs.j[ji + 1].tile0) ++ji;
  const GJob& jb = jobs.j[ji];
  const int m0 = (t - jb.tile0) * GT_M;
  const int k_begin = blockIdx.y * kchunk;
  const int nk = (min(P, k_begin + kchunk) - k_begin + GK - 1) / GK;
  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);               // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {                          // producer warp
    if (tid == 256) {
      const CUtensorMap* am = &maps.m[jb.amap];
      const CUtensorMap* bm = &maps.m[jb.bmap];
      for (int k = 0; k < nk; ++k) {
        const int s = k % GSTAGES;
        mbar_wait(&empty[s], ((k / GSTAGES) & 1) ^ 1);
        unsigned char* st = base + s * GSTAGE_BYTES;
        const int row = k_begin + k * GK;
        mbar_expect_tx(&full[s], GSTAGE_BYTES);
        tma_load(st, am, &full[s], m0, row, jb.alayer);
        tma_load(st + BOX_BYTES, am, &full[s], m0 + 64, row, jb.alayer);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          tma_load(st + (2 + b) * BOX_BYTES, bm, &full[s], 64 * b, row,
                   jb.blayer);
      }
    }
    return;
  }

  const int g = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int s = k % GSTAGES;
    mbar_wait(&full[s], (k / GSTAGES) & 1);
    const unsigned char* st = base + s * GSTAGE_BYTES;
    const uint64_t da = desc_mn(st + g * BOX_BYTES, BOX_BYTES);
    const uint64_t db = desc_mn(st + 2 * BOX_BYTES, BOX_BYTES);
    wgmma_fence();
    acc_fence(acc);
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)
      wgmma_n256<1, 1>(acc, da + kk * (16 * SWZ_ROW >> 4),
                       db + kk * (16 * SWZ_ROW >> 4), 1);
    wgmma_commit();
    acc_fence(acc);
    wgmma_wait<1>();                         // stage k - 1 is read
    if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % GSTAGES]);
  }
  wgmma_wait<0>();
  acc_fence(acc);

  float* out = part + (size_t)blockIdx.y * EW + jb.off;
  const int m = m0 + g * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int n = 8 * j + 2 * (lane & 3);
    if (n < jb.N) {
      if (m < jb.M)
        *reinterpret_cast<float2*>(out + (size_t)m * jb.N + n) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (m + 8 < jb.M)
        *reinterpret_cast<float2*>(out + (size_t)(m + 8) * jb.N + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
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

// out[c] = the sum over rows r of part[r * ld + c], in a fixed order: 32
// row groups (rows g, g + 32, ...) summed by one thread each, then the
// groups in order. For the many rows of bias partials.
static __global__ void __launch_bounds__(1024)
sum_rows(const float* __restrict__ part, int nrow, int ncol, size_t ld,
         float* __restrict__ out) {
  __shared__ float s[32][33];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (c < ncol)
    for (int r = g; r < nrow; r += 32) v += part[(size_t)r * ld + c];
  s[g][lane] = v;
  __syncthreads();
  if (g == 0 && c < ncol) {
    float t = 0.f;
    for (int k = 0; k < 32; ++k) t += s[k][lane];
    out[c] = t;
  }
}

// ------------------------------------------------------------------ host --

inline size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// The 14 products and their tiles, in the gradient buffer's order.
inline GJobs make_jobs() {
  const GJob spec[NJOBS] = {
      {MAP_X, 0, MAP_DZ, 0, KX, W},            // w0
      {MAP_ACT, 0, MAP_DZ, 1, W, W},           // wt[0..6]
      {MAP_ACT, 1, MAP_DZ, 2, W, W},
      {MAP_ACT, 2, MAP_DZ, 3, W, W},
      {MAP_ACT, 3, MAP_DZ, 4, W, W},
      {MAP_ACT, 4, MAP_DZ, 5, W, W},
      {MAP_ACT, 5, MAP_DZ, 6, W, W},
      {MAP_ACT, 6, MAP_DZ, 7, W, W},
      {MAP_X, 0, MAP_DZ, SKIP, KX, W},         // wsk
      {MAP_ACT, D - 1, MAP_DZ, D, W, W},       // wf (dfeat is dz layer D)
      {MAP_ACT, D, MAP_DZD, 0, W, WD},         // wdf (feat is act layer D)
      {MAP_D, 0, MAP_DZD, 0, KD, WD},          // wdd
      {MAP_ACT, D - 1, MAP_DZR, 0, W, DZR_W},  // ws (col 3)
      {MAP_HD, 0, MAP_DZR, 0, WD, DZR_W},      // wr (cols 0..2)
  };
  GJobs jobs;
  int off = 0, tile = 0;
  for (int i = 0; i < NJOBS; ++i) {
    GJob j = spec[i];
    j.off = off;
    j.tile0 = tile;
    off += j.M * j.N;
    tile += (j.M + GT_M - 1) / GT_M;
    jobs.j[i] = j;
  }
  jobs.ntiles = tile;
  return jobs;
}

// Workspace of P scratch points, `bias_rows` rows of bias partials and
// `extra` bytes for the launch A that fills them: bf16 scratch,
// weight-gradient slots, bias partials, the extra bytes.
struct Workspace {
  size_t P;
  int bias_rows, kchunk, nchunk;
  size_t part, bias, extra, total;   // byte offsets
  Workspace(size_t P_, int bias_rows_, size_t extra_bytes = 0)
      : P(P_), bias_rows(bias_rows_) {
    const size_t nslot = WAVE / make_jobs().ntiles;
    const size_t per = (P + nslot - 1) / nslot;
    kchunk = static_cast<int>(per > 1024 ? (per + GK - 1) / GK * GK : 1024);
    nchunk = static_cast<int>((P + kchunk - 1) / kchunk);
    size_t o = 0;
    for (int w : {KX, KD, (D + 1) * W, WD, (D + 1) * W, WD, DZR_W})
      o += align256(sizeof(bf16) * P * w);
    part = o;
    bias = part + align256(sizeof(float) * (size_t)nchunk * EW);
    extra = bias + align256(sizeof(float) * (size_t)bias_rows * NBIAS);
    total = extra + align256(extra_bytes);
  }
};

inline Scratch scratch_at(void* base, size_t P) {
  Scratch s;
  unsigned char* o = static_cast<unsigned char*>(base);
  auto take = [&](int w) {
    bf16* p = reinterpret_cast<bf16*>(o);
    o += align256(sizeof(bf16) * P * w);
    return p;
  };
  s.P = P;
  s.x = take(KX);
  s.d = take(KD);
  s.act = take((D + 1) * W);     // trunk layers 0..D-1, then feat
  s.feat = s.act + (size_t)D * P * W;
  s.hd = take(WD);
  s.dz = take((D + 1) * W);      // trunk layers 0..D-1, then dfeat
  s.dfeat = s.dz + (size_t)D * P * W;
  s.dzd = take(WD);
  s.dzr = take(DZR_W);
  return s;
}

// TMA maps of the scratch, boxes of 64 points. False if the driver's
// encoder is missing or refuses one.
inline bool scratch_maps(const Scratch& s, ScratchMaps* maps) {
  const size_t P = s.P;
  return make_map(&maps->m[MAP_X], s.x, KX, P, 1, GK) &&
         make_map(&maps->m[MAP_D], s.d, KD, P, 1, GK) &&
         make_map(&maps->m[MAP_ACT], s.act, W, P, D + 1, GK) &&
         make_map(&maps->m[MAP_HD], s.hd, WD, P, 1, GK) &&
         make_map(&maps->m[MAP_DZ], s.dz, W, P, D + 1, GK) &&
         make_map(&maps->m[MAP_DZD], s.dzd, WD, P, 1, GK) &&
         make_map(&maps->m[MAP_DZR], s.dzr, DZR_W, P, 1, GK);
}

// Launches B and C after a launch A over the scratch: the weight gradients
// into grad[0, EW), the sums of the bias partials' rows into grad[EW, EW +
// NBIAS). Returns the first CUDA error.
static cudaError_t launch_weight_grads(const ScratchMaps& maps,
                                       const Workspace& wsp,
                                       unsigned char* base,
                                       const float* bias_part, float* grad,
                                       cudaStream_t st) {
  float* part = reinterpret_cast<float*>(base + wsp.part);
  const GJobs jobs = make_jobs();
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G_SMEM));
  if (err != cudaSuccess) return err;
  wgrad_kernel<<<dim3(jobs.ntiles, wsp.nchunk), G_THREADS, G_SMEM, st>>>(
      maps, jobs, static_cast<int>(wsp.P), wsp.kchunk, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_slots<<<(EW + 255) / 256, 256, 0, st>>>(part, wsp.nchunk, EW, EW, grad);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_rows<<<(NBIAS + 31) / 32, 1024, 0, st>>>(bias_part, wsp.bias_rows,
                                               NBIAS, NBIAS, grad + EW);
  return cudaGetLastError();
}

}  // namespace nerf
