// The NeRF MLP's weights, widths and input embedding, shared by every
// kernel, and the sigma-only WMMA tile of sigma_render and sigma_fwd (the
// trunk and the sigma head on one tile of points). The tile's inputs come
// from rays and depths (build_inputs: o + d z, sigma_render) or from rows
// of raw points (build_point_inputs: sigma_fwd). Every kernel that runs the
// full MLP (mlp_fwd, render_eval and the training kernels) runs it on
// wgmma instead (mlp_wgmma.cuh); the weights' layout, the embedding's
// columns and sincos_col are shared with them.
//
// The tile computes what `_trunk_body` of nerf_pl_tpu/ops/fused_mlp.py
// computes: in-kernel gamma(x) as one sin() over an exact f32 phase block
// (cos columns = sin(t + pi/2)), an 8x256 trunk with the x skip at layer 4
// and the sigma head. Products take bf16 operands and sum in f32 on the
// tensor cores (WMMA 16x16x16, i.e. mma.sync); activations are stored as
// bf16 after each layer.
//
// What bounds it on Hopper: the TPU kernel keeps all its bf16 weights
// resident in VMEM; a block here has at most 227 KB of shared memory. So
// one tile of TP points keeps its activations (TP x 256 bf16) in shared
// memory for the whole trunk, and each layer's weights stream from the 50
// MB L2, which serves them to every block. Each warp owns a band of output
// columns for all TP rows and streams only its own weight columns, KS rows
// at a time, through a private double buffer (cp.async fills one while the
// tensor cores read the other): the K loop waits on no other warp, and the
// block meets at a barrier only between layers. Weight traffic from L2 is
// ~1.0 MB per tile of 64 points.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace nerf {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int W = 256;          // trunk width
constexpr int WD = 128;         // view-branch width
constexpr int D = 8;            // trunk depth
constexpr int SKIP = 4;         // trunk layer receiving the x skip
constexpr int TP = 64;          // points per MLP tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int XS = 16;          // first sin/cos column of both inputs
constexpr int KX = XS + 64;     // xyz input: raw (8) | zero (8) | sin/cos (64)
constexpr int KD = XS + 32;     // dir input: raw (8) | zero (8) | sin/cos (32)
constexpr int NX = 60;          // real xyz sin/cos columns (10 freqs x 6)
constexpr int ND = 24;          // real dir sin/cos columns (4 freqs x 6)
constexpr int KS = 32;          // weight rows per shared-memory slab
constexpr int PAD = 8;          // bf16 row padding against bank conflicts
constexpr int LDH = W + PAD;
constexpr int LDX = KX + PAD;
constexpr int LDW = 32 + PAD;   // a warp's slab: its 32 columns
constexpr float HALF_PI = 1.57079632679489662f;

static_assert(NTHREADS == 4 * TP, "the sigma head uses 4 threads per point");
static_assert(TP == 64, "4 row blocks per warp");

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

// Whole rays per block: enough for four tiles of points, at least one.
inline int rays_per_block(int S) { return S >= 4 * TP ? 1 : (4 * TP) / S; }

// Byte offsets of a block's shared-memory regions (host and device agree).
struct SmemLayout {
  size_t h, x, slab, stage, rays, z, sig, total;
  __host__ __device__ SmemLayout(int S, int rpb) {
    size_t o = 0;
    h = o;     o += align128(sizeof(bf16) * TP * LDH);
    x = o;     o += align128(sizeof(bf16) * TP * LDX);
    slab = o;  o += align128(sizeof(bf16) * NWARPS * 2 * KS * LDW);
    stage = o; o += align128(sizeof(float) * NWARPS * 256);
    rays = o;  o += align128(sizeof(float) * rpb * 8);
    z = o;     o += align128(sizeof(float) * rpb * S);
    sig = o;   o += align128(sizeof(float) * rpb * S);
    total = o;
  }
};

struct Smem {
  bf16* h;       // TP x LDH   activations, updated in place layer by layer
  bf16* x;       // TP x LDX   xyz input
  bf16* slab;    // NWARPS x 2 x KS x LDW   per-warp weight slabs
  float* stage;  // NWARPS x 256 accumulator staging
  float* rays;   // rpb x 8
  float* z;      // rpb * S
  float* sig;    // rpb * S    raw sigma per point
};

// The regions of a block's dynamic shared memory.
__device__ __forceinline__ Smem smem_at(unsigned char* raw,
                                        const SmemLayout& L) {
  Smem sm;
  sm.h = reinterpret_cast<bf16*>(raw + L.h);
  sm.x = reinterpret_cast<bf16*>(raw + L.x);
  sm.slab = reinterpret_cast<bf16*>(raw + L.slab);
  sm.stage = reinterpret_cast<float*>(raw + L.stage);
  sm.rays = reinterpret_cast<float*>(raw + L.rays);
  sm.z = reinterpret_cast<float*>(raw + L.z);
  sm.sig = reinterpret_cast<float*>(raw + L.sig);
  return sm;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int NB>
__device__ __forceinline__ void zero(FragC (&acc)[NB]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) wmma::fill_fragment(acc[j], 0.f);
}

// 16 bytes global -> shared without staging in registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Issue the copy of weight rows [k0, k0 + ks), columns [col0, col0 + NCW)
// of Wg (N wide) into this warp's slab.
template <int N, int NCW>
__device__ __forceinline__ void load_slab(bf16* dst,
                                          const bf16* __restrict__ Wg, int col0,
                                          int k0, int ks, int lane) {
  constexpr int VPR = NCW / 8;      // 16-byte vectors per slab row
  for (int i = lane; i < ks * VPR; i += 32) {
    const int r = i / VPR, c = i - r * VPR;
    cp_async16(dst + r * LDW + c * 8,
               Wg + (size_t)(k0 + r) * N + col0 + c * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc += A (TP x K, shared) @ Wg (K x N, global row-major), N = 16 * NCB *
// NWARPS. Warp w owns all TP rows and the NCB column blocks of 16 starting
// at column w * 16 * NCB; acc[rb * NCB + j] is row block rb, column block
// j. Each warp streams its own columns of Wg through a private double
// buffer of KS rows, so the K loop needs no block-wide barrier. A must be
// complete (the caller syncs the block before).
template <int NCB>
__device__ __forceinline__ void gemm_acc(FragC (&acc)[4 * NCB], const bf16* A,
                                         int lda, const bf16* __restrict__ Wg,
                                         int K, bf16* slab) {
  constexpr int NCW = 16 * NCB;
  constexpr int N = NCW * NWARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = warp * NCW;
  bf16* mine = slab + warp * 2 * KS * LDW;
  const int nslab = (K + KS - 1) / KS;
  load_slab<N, NCW>(mine, Wg, col0, 0, min(KS, K), lane);
  for (int s = 0; s < nslab; ++s) {
    const int k0 = s * KS, ks = min(KS, K - k0);
    if (s + 1 < nslab) {
      load_slab<N, NCW>(mine + ((s + 1) & 1) * KS * LDW, Wg, col0, k0 + KS,
                        min(KS, K - k0 - KS), lane);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();                   // slab s has landed for every lane
    const bf16* sl = mine + (s & 1) * KS * LDW;
    for (int kk = 0; kk < ks; kk += 16) {
      FragB b[NCB];
#pragma unroll
      for (int j = 0; j < NCB; ++j)
        wmma::load_matrix_sync(b[j], sl + kk * LDW + j * 16, LDW);
#pragma unroll
      for (int rb = 0; rb < 4; ++rb) {
        FragA a;
        wmma::load_matrix_sync(a, A + rb * 16 * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < NCB; ++j)
          wmma::mma_sync(acc[rb * NCB + j], a, b[j], acc[rb * NCB + j]);
      }
    }
    __syncwarp();                   // every lane is done with slab s
  }
}

// h[:, columns of this warp] = bf16(relu(acc + bias)). The caller has
// synced the block after the last read of h.
template <int NCB>
__device__ __forceinline__ void store_relu(FragC (&acc)[4 * NCB],
                                          const float* __restrict__ bias,
                                          bf16* h, float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = warp * 16 * NCB;
  float* st = stage + warp * 256;
#pragma unroll
  for (int f = 0; f < 4 * NCB; ++f) {
    const int rb = f / NCB, j = f - rb * NCB;
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int col = col0 + j * 16 + (e & 15);
      const float v = fmaxf(st[e] + __ldg(bias + col), 0.f);
      h[(rb * 16 + (e >> 4)) * LDH + col] = __float2bfloat16_rn(v);
    }
    __syncwarp();
  }
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

// Fill the trunk's input gamma(x) for points [t0, t0 + TP) of the block;
// points at or past P (the block's valid points) get zero rows.
__device__ inline void build_inputs(const Smem& sm, int S, int t0, int P) {
  for (int i = threadIdx.x; i < TP * KX; i += NTHREADS) {
    const int pt = i / KX, col = i - pt * KX;
    const int gp = t0 + pt;
    float v = 0.f;
    if (gp < P) {
      if (col < 3) {
        v = point_coord(sm, S, gp, col);
      } else if (col >= XS && col < XS + NX) {
        const int j = col - XS;
        v = sincos_col(point_coord(sm, S, gp, j % 3), j);
      }
    }
    sm.x[pt * LDX + col] = __float2bfloat16_rn(v);
  }
}

// Fill the trunk's input for points [t0, t0 + TP) from rows of the (P, 8)
// raw points p8: the raw value in columns 0..2, the same sin/cos columns
// as build_inputs; rows at or past `end` are zero.
__device__ inline void build_point_inputs(const Smem& sm,
                                          const float* __restrict__ p8,
                                          int t0, int end) {
  for (int i = threadIdx.x; i < TP * KX; i += NTHREADS) {
    const int pt = i / KX, col = i - pt * KX;
    const size_t gp = (size_t)t0 + pt;
    float v = 0.f;
    if (t0 + pt < end) {
      if (col < 3) {
        v = p8[gp * 8 + col];
      } else if (col >= XS && col < XS + NX) {
        const int j = col - XS;
        v = sincos_col(p8[gp * 8 + j % 3], j);
      }
    }
    sm.x[pt * LDX + col] = __float2bfloat16_rn(v);
  }
}

// The trunk on the tile in sm.x: raw sigma of the first n_valid points to
// sig_out.
__device__ inline void mlp_tile(const MlpWeights& p, const Smem& sm,
                                float* sig_out, int n_valid) {
  FragC acc[8];
  zero(acc);
  gemm_acc<2>(acc, sm.x, LDX, p.w0, KX, sm.slab);
  store_relu<2>(acc, p.bt, sm.h, sm.stage);
  for (int i = 1; i < D; ++i) {
    __syncthreads();              // h of layer i - 1 is complete
    zero(acc);
    gemm_acc<2>(acc, sm.h, LDH, p.wt + (size_t)(i - 1) * W * W, W, sm.slab);
    if (i == SKIP) gemm_acc<2>(acc, sm.x, LDX, p.wsk, KX, sm.slab);
    __syncthreads();              // every warp has read h
    store_relu<2>(acc, p.bt + i * W, sm.h, sm.stage);
  }
  __syncthreads();

  // sigma head: 4 threads per point, 64 products each
  const int pt = threadIdx.x >> 2, q = threadIdx.x & 3;
  const bf16* hr = sm.h + pt * LDH + q * 64;
  const bf16* wq = p.ws + q * 64;
  float s = 0.f;
  for (int k = 0; k < 64; ++k)
    s += __bfloat162float(hr[k]) * __bfloat162float(wq[k]);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (q == 0 && pt < n_valid) sig_out[pt] = s + p.bs[0];
}

}  // namespace nerf
