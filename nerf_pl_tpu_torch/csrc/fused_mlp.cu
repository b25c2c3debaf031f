// The fused NeRF point MLP on raw points: forward, sigma-only forward and
// the weight-gradient backward.
//
//   mlp_fwd    replaces the forward of fused_nerf_mlp
//              (nerf_pl_tpu/ops/fused_mlp.py, _fused_fwd_call, body
//              _fwd_kernel): (P, 8) raw points and directions -> (P, 8)
//              [rgb (3) after the sigmoid, raw sigma, 0, 0, 0, 0].
//   sigma_fwd  replaces nerf_sigma_fused (same file, body _sigma_kernel):
//              (P, 8) raw points -> raw sigma (P,).
//   mlp_bwd    replaces the backward of fused_nerf_mlp (_fused_bwd, body
//              _bwd_kernel): the weight gradients for a per-point cotangent
//              g (P, 8) = [d rgb (3), d raw sigma, ...], in three launches:
//                A'  point_fwdbwd  per tile of 128 points on wgmma
//                                  (mlp_wgmma.cuh), the forward again,
//                                  keeping every bf16 activation in the
//                                  scratch; the rgb head's cotangent
//                                  g c (1 - c) from the f32 recomputed rgb
//                                  c and g[3] on raw sigma; then the tile's
//                                  data-gradient chain;
//                B, C              mlp_grad.cuh's wgrad and ordered sums.
//              The points get no gradients (the TPU kernel returns zeros).
//
// mlp_fwd is launch A' without its backward: per tile of 128 consecutive
// points, row_points -> embed_tile -> forward_tile (mlp_wgmma.cuh: wgmma
// m64n256k16, 32 KB weight slabs that one TMA producer warpgroup streams
// to two consumer warpgroups) into the tile's f32 sigma and rgb in shared
// memory, then one 16-byte store per half row of out8. Its layout is that
// of A' without the backward's regions (212,608 bytes with 3 ring
// stages, not 220,032); a fourth stage (245,376) or a second block an SM
// (two blocks' 384 threads at 232 and 40 registers need 129,024 of
// 65,536) does not fit.
//
// sigma_fwd is mlp_fwd on the trunk alone: per tile, row_points without
// directions -> embed_tile of gamma(x) alone -> trunk_tile (mlp_wgmma.cuh;
// the sigma head in layer D-1's epilogue) -> one store of raw sigma per
// row straight from the epilogue. Its producer streams produce_trunk's 32
// slabs a tile (the forward's 38.5 slab-equivalents less the feature and
// view layers'), its C entry takes the trunk's weights alone (TMA maps of
// w0, wt and wsk; a bias copy of bt, 8,192 bytes), and its sigma is
// mlp_fwd's out8[:, 3] bit for bit (the same trunk_tile on the same
// gamma(x)). Its layout is mlp_fwd's without the sigma and rgb rows and
// with the trunk's biases alone: 209,024 bytes with 3 ring stages; a
// fourth stage (241,792) does not fit.
//
// Launches A', mlp_fwd and sigma_fwd: a point needs only its own tile, not
// a whole ray, so each tile's backward runs right after its forward, and a
// block walks tiles t = blockIdx.x, + gridDim.x, ... of a persistent grid
// of at most WAVE = 132 blocks (one a SM: A' takes 220,032 bytes of shared
// memory). The producer streams each tile's forward slabs (then its
// backward's) without a pause between tiles; a block initialises its
// barriers and bias copy once, and A' zeroes its two rows of bias
// partials once (264 rows for launch C to sum, not one pair a tile). The
// mask bits of a tile are read back right after they were written, while
// they are still in L2.
//
// A ragged P is masked: rows past P are zero inputs whose outputs are
// never written and whose cotangents are zero, so they add exactly nothing
// to any gradient sum. (The JAX wrapper pads P to its tile with zero
// points instead and slices them off, so their cotangents are zero there
// too.)
//
// What bounds them: tensor-core work, 1.19 MFLOP per point forward (0.157
// ms at P = 131,072 on an H100 SXM's 989 TFLOP/s; 0.98 MFLOP for sigma
// only, 2.083 ms at P = 2,097,152) and 2.94x that for the backward (0.4624
// ms). Device memory sees the points and outputs (~32 bytes a point each
// way) and, for mlp_bwd, ~10 KB of bf16 scratch per point, written by A'
// and read by B, as in mse_render: 0.39 ms each way at 3.35 TB/s, this
// design's floor.
//
// Launch contract: the caller's stream, no allocation (mlp_bwd takes a
// workspace of nerf_mlp_workspace_bytes(P)), and the entry points return
// the first CUDA error of their launches.
#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"

namespace nerf {

struct PointArgs : GradArgs {
  const float* p8;
  const float* d8;
  const float* g8;          // (P, 8): d rgb in cols 0..2, d raw sigma col 3
  int P;
  float* bias_part;         // (2 gridDim.x, NBIAS)
  uint4* bits;              // the ReLU masks, MASK_TILE_BYTES a tile
  float* out8;              // (P, 8)  mlp_fwd
  float* sigma;             // (P,)    sigma_fwd
};

// Shared memory of launch A' (BWD), mlp_fwd (FWD) or sigma_fwd (TRUNK):
// the tile loops' regions (A': the warpgroups' point rows in the
// column-sum stage; mlp_fwd and sigma_fwd: a region of their own), the
// epilogues' biases (sigma_fwd: bt alone) and, but for sigma_fwd, the
// tile's raw sigma and f32 rgb.
struct PtLayout {
  size_t xd, h, ring, stage, dzr, bias, bar, sig, rgb, total;
  int pts_wg;     // floats from one warpgroup's point rows to the other's
  __host__ __device__ PtLayout(int nst, Pass ps) {
    const bool bwd = ps == BWD, rows = ps != TRUNK;
    size_t o = 0;
    xd = o;     o += 2 * ATILE;
    h = o;      o += 4 * ATILE;
    ring = o;   o += (size_t)nst * SLAB_BYTES;
    stage = o;  o += sizeof(float) * (bwd ? 8 * ST_LD : 2 * PTS_WG);
    dzr = o;    o += bwd ? sizeof(float) * AT * 4 : 0;
    bias = o;   o += sizeof(float) * (rows ? N_EPI_BIAS : N_TRUNK_BIAS);
    bar = o;    o += align128(2 * 8 * nst);
    sig = o;    o += rows ? align128(sizeof(float) * AT) : 0;
    rgb = o;    o += rows ? align128(sizeof(float) * AT * 3) : 0;
    total = o + 1024;                     // room to align the base
    pts_wg = bwd ? 4 * ST_LD : PTS_WG;
  }
};
constexpr int PT_STAGES = 3;

// The tiles of P points and the persistent grid over them.
struct PShape {
  int ntile, grid;
  size_t rows;
  __host__ __device__ explicit PShape(int P)
      : ntile(static_cast<int>(((long long)P + AT - 1) / AT)),
        grid(ntile < WAVE ? ntile : WAVE),
        rows((size_t)ntile * AT) {}
};

inline Workspace point_workspace(int P) {
  const PShape sh(P);
  return Workspace(sh.rows, 2 * sh.grid, (size_t)sh.ntile * MASK_TILE_BYTES);
}

// The warpgroup's rows of the tile at point row0: each row's raw point
// and, DIRS, its direction (p8, d8 columns 0..2) into pts, zero at or past
// nv.
template <bool DIRS = true>
__device__ __forceinline__ void row_points(const Wg& wg,
                                           const float* __restrict__ p8,
                                           const float* __restrict__ d8,
                                           size_t row0, int nv, float* pts) {
  if (wg.t < 64) {
    const int r = 64 * wg.g + wg.t;
    const size_t gp = row0 + r;
    float* q = pts + wg.t * 6;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[c] = r < nv ? p8[gp * 8 + c] : 0.f;
      if (DIRS) q[3 + c] = r < nv ? d8[gp * 8 + c] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(A_THREADS, 1)
point_fwdbwd_kernel(const __grid_constant__ WeightMaps wm,
                    const __grid_constant__ ScratchMaps scm, PointArgs a,
                    int nst) {
  extern __shared__ __align__(1024) unsigned char araw[];
  unsigned char* base = align1024(araw);
  const PtLayout L(nst, BWD);
  unsigned char* xd = base + L.xd;
  unsigned char* h = base + L.h;
  float* stage = reinterpret_cast<float*>(base + L.stage);
  float* dzr_s = reinterpret_cast<float*>(base + L.dzr);
  float* eb = reinterpret_cast<float*>(base + L.bias);
  float* sig = reinterpret_cast<float*>(base + L.sig);
  float* rgb = reinterpret_cast<float*>(base + L.rgb);
  Ring ring = start_block(base + L.ring,
                          reinterpret_cast<uint64_t*>(base + L.bar), nst,
                          a.p, eb);
  const int tid = threadIdx.x;
  const int ntile = PShape(a.P).ntile;
  __syncthreads();
  if (tid >= 256) {                       // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256)
      for (int t = blockIdx.x; t < ntile; t += gridDim.x) {
        produce_fwd(wm, ring);
        produce_bwd(wm, ring);
      }
    return;
  }
  regs_alloc<232>();

  const Wg wg = consumer_wg();
  float* bias = a.bias_part + (size_t)(2 * blockIdx.x + wg.g) * NBIAS;
  for (int i = wg.t; i < NBIAS; i += 128) bias[i] = 0.f;
  float* pts = stage + wg.g * L.pts_wg;
  int held = -1;
  for (int t = blockIdx.x; t < ntile; t += gridDim.x) {
    const size_t row0 = (size_t)t * AT;
    const long long left = a.P - (long long)row0;
    const int nv = left < AT ? static_cast<int>(left) : AT;
    uint4* bits = a.bits + (size_t)t * MASK_LAYERS * 256;
    wg.sync();                            // the stage's last column sums
    row_points(wg, a.p8, a.d8, row0, nv, pts);
    embed_tile<true>(wg, nv, pts, xd, a.s.x + row0 * KX, a.s.d + row0 * KD);
    forward_tile<true>(wg, ring, held, a.p, eb, &scm, xd, h, bits, row0, nv,
                       sig, rgb);
    // the rgb head's cotangent g c (1 - c), and g[3] on raw sigma
    backward_tile(wg, ring, held, a.p, scm, a.s, h, dzr_s, stage, bias,
                  bits, row0, nv, [&](int row) {
                    const float* g = a.g8 + (row0 + row) * 8;
                    const float* c = rgb + row * 3;
                    return make_float4(g[0] * c[0] * (1.f - c[0]),
                                       g[1] * c[1] * (1.f - c[1]),
                                       g[2] * c[2] * (1.f - c[2]), g[3]);
                  });
  }
  if (wg.leader) bulk_wait_all();
}

// mlp_fwd: launch A' without its backward; rows [rgb, raw sigma, 0, 0,
// 0, 0] of out8.
__global__ void __launch_bounds__(A_THREADS, 1)
mlp_fwd_kernel(const __grid_constant__ WeightMaps wm, PointArgs a, int nst) {
  extern __shared__ __align__(1024) unsigned char araw[];
  unsigned char* base = align1024(araw);
  const PtLayout L(nst, FWD);
  unsigned char* xd = base + L.xd;
  unsigned char* h = base + L.h;
  float* eb = reinterpret_cast<float*>(base + L.bias);
  float* sig = reinterpret_cast<float*>(base + L.sig);
  float* rgb = reinterpret_cast<float*>(base + L.rgb);
  Ring ring = start_block(base + L.ring,
                          reinterpret_cast<uint64_t*>(base + L.bar), nst,
                          a.p, eb);
  const int tid = threadIdx.x;
  const int ntile = PShape(a.P).ntile;
  __syncthreads();
  if (tid >= 256) {                       // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256)
      for (int t = blockIdx.x; t < ntile; t += gridDim.x)
        produce_fwd(wm, ring);
    return;
  }
  regs_alloc<232>();

  const Wg wg = consumer_wg();
  float* pts = reinterpret_cast<float*>(base + L.stage) + wg.g * L.pts_wg;
  int held = -1;
  for (int t = blockIdx.x; t < ntile; t += gridDim.x) {
    const size_t row0 = (size_t)t * AT;
    const long long left = a.P - (long long)row0;
    const int nv = left < AT ? static_cast<int>(left) : AT;
    row_points(wg, a.p8, a.d8, row0, nv, pts);
    embed_tile<false>(wg, nv, pts, xd, nullptr, nullptr);
    forward_tile<false>(wg, ring, held, a.p, eb, nullptr, xd, h, nullptr, 0,
                        nv, sig, rgb);
    wg.sync();                            // the warpgroup's sig and rgb rows
    // two threads a row of the warpgroup's 64: [rgb, sigma], then zeros
    const int r = 64 * wg.g + (wg.t >> 1);
    if (r < nv) {
      const float4 v = wg.t & 1 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                : make_float4(rgb[3 * r], rgb[3 * r + 1],
                                              rgb[3 * r + 2], sig[r]);
      reinterpret_cast<float4*>(a.out8 + (row0 + r) * 8)[wg.t & 1] = v;
    }
  }
}

// sigma_fwd: mlp_fwd on the trunk alone; raw sigma of each row to
// a.sigma, straight from trunk_tile's last epilogue.
__global__ void __launch_bounds__(A_THREADS, 1)
sigma_fwd_kernel(const __grid_constant__ TrunkMaps wm, PointArgs a,
                 int nst) {
  extern __shared__ __align__(1024) unsigned char araw[];
  unsigned char* base = align1024(araw);
  const PtLayout L(nst, TRUNK);
  unsigned char* xd = base + L.xd;
  unsigned char* h = base + L.h;
  float* eb = reinterpret_cast<float*>(base + L.bias);
  Ring ring = start_block(base + L.ring,
                          reinterpret_cast<uint64_t*>(base + L.bar), nst,
                          a.p, eb, N_TRUNK_BIAS);
  const int tid = threadIdx.x;
  const int ntile = PShape(a.P).ntile;
  __syncthreads();
  if (tid >= 256) {                       // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256)
      for (int t = blockIdx.x; t < ntile; t += gridDim.x)
        produce_trunk(wm, ring);
    return;
  }
  regs_alloc<232>();

  const Wg wg = consumer_wg();
  float* pts = reinterpret_cast<float*>(base + L.stage) + wg.g * L.pts_wg;
  int held = -1;
  for (int t = blockIdx.x; t < ntile; t += gridDim.x) {
    const size_t row0 = (size_t)t * AT;
    const long long left = a.P - (long long)row0;
    const int nv = left < AT ? static_cast<int>(left) : AT;
    row_points<false>(wg, a.p8, nullptr, row0, nv, pts);
    embed_tile<false, false>(wg, nv, pts, xd, nullptr, nullptr);
    float acc[128];
    trunk_tile<false>(acc, wg, ring, held, a.p, eb, nullptr, xd, h, nullptr,
                      0, nv, a.sigma + row0);
  }
}

}  // namespace nerf

extern "C" {

int nerf_mlp_fwd(const void* p8, const void* d8, int P, const void* w0,
                 const void* wt, const void* wsk, const void* bt,
                 const void* ws, const void* bs, const void* wf,
                 const void* bf, const void* wdf, const void* wdd,
                 const void* bd, const void* wr, const void* br, void* out8,
                 void* stream) {
  using namespace nerf;
  if (P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  PointArgs a{};
  a.p = weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br);
  a.p8 = static_cast<const float*>(p8);
  a.d8 = static_cast<const float*>(d8);
  a.P = P;
  a.out8 = static_cast<float*>(out8);
  WeightMaps wm;
  if (!weight_maps(a.p, &wm)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = PtLayout(PT_STAGES, FWD).total;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_fwd_kernel<<<PShape(P).grid, A_THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(wm, a, PT_STAGES);
  return static_cast<int>(cudaGetLastError());
}

int nerf_sigma_fwd(const void* p8, int P, const void* w0, const void* wt,
                   const void* wsk, const void* bt, const void* ws,
                   const void* bs, void* sigma, void* stream) {
  using namespace nerf;
  if (P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  PointArgs a{};
  a.p = weights_at(w0, wt, wsk, bt, ws, bs, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr);
  a.p8 = static_cast<const float*>(p8);
  a.P = P;
  a.sigma = static_cast<float*>(sigma);
  TrunkMaps wm;
  if (!trunk_maps(a.p, &wm)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = PtLayout(PT_STAGES, TRUNK).total;
  cudaError_t err = cudaFuncSetAttribute(
      sigma_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sigma_fwd_kernel<<<PShape(P).grid, A_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(wm, a, PT_STAGES);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of mlp_bwd's workspace: the scratch of whole tiles, launch B's
// slots, two rows of bias partials a block of A' and the mask bits
// (MASK_TILE_BYTES = 36 KB a tile).
long long nerf_mlp_workspace_bytes(int P) {
  return static_cast<long long>(nerf::point_workspace(P).total);
}

int nerf_mlp_bwd(const void* p8, const void* d8, const void* g8, int P,
                 const void* w0, const void* wt, const void* wsk,
                 const void* bt, const void* ws, const void* bs,
                 const void* wf, const void* bf, const void* wdf,
                 const void* wdd, const void* bd, const void* wr,
                 const void* br, void* workspace, void* grad,
                 void* stream) {
  using namespace nerf;
  if (P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace wsp = point_workspace(P);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  PointArgs a{};
  a.p = weights_at(w0, wt, wsk, bt, ws, bs, wf, bf, wdf, wdd, bd, wr, br);
  a.s = scratch_at(base, wsp.P);
  a.p8 = static_cast<const float*>(p8);
  a.d8 = static_cast<const float*>(d8);
  a.g8 = static_cast<const float*>(g8);
  a.P = P;
  a.bias_part = reinterpret_cast<float*>(base + wsp.bias);
  a.bits = reinterpret_cast<uint4*>(base + wsp.extra);
  WeightMaps wm;
  ScratchMaps scm;
  if (!weight_maps(a.p, &wm) || !scratch_maps(a.s, &scm))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = PtLayout(PT_STAGES, BWD).total;
  cudaError_t err = cudaFuncSetAttribute(
      point_fwdbwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  point_fwdbwd_kernel<<<PShape(P).grid, A_THREADS, smem, st>>>(wm, scm, a,
                                                               PT_STAGES);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(
      scm, wsp, base, a.bias_part, static_cast<float*>(grad), st));
}

}  // extern "C"
