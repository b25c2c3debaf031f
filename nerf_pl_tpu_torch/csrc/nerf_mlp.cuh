// The NeRF point MLP on one tile of points, for the fused render kernels.
//
// Computes what `_forward_body` of nerf_pl_tpu/ops/fused_mlp.py computes:
// in-kernel gamma(x) / gamma(d) as one sin() over an exact f32 phase block
// (cos columns = sin(t + pi/2)), an 8x256 trunk with the x skip at layer 4,
// the sigma head, the linear feature layer, the 128-wide view layer and the
// sigmoid rgb head. Products take bf16 operands and sum in f32 on the
// tensor cores (WMMA 16x16x16, i.e. mma.sync); activations are stored as
// bf16 after each layer.
//
// What bounds it on Hopper: the TPU kernel keeps all ~1.2 MB of bf16
// weights resident in VMEM; a block here has at most 227 KB of shared
// memory. So one tile of TP points keeps its activations (TP x 256 bf16)
// in shared memory for the whole MLP, and each layer's weights stream
// from the 50 MB L2, which serves them to every block. Each warp owns a
// band of output columns for all TP rows and streams only its own weight
// columns, KS rows at a time, through a private double buffer (cp.async
// fills one while the tensor cores read the other): the K loop waits on
// no other warp, and the block meets at a barrier only between layers.
// Weight traffic from L2 is ~1.2 MB per tile of 64 points; TMA, wgmma
// and an epilogue in registers are later work.
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
constexpr int LDD = KD + PAD;
constexpr int LDW = 32 + PAD;   // a warp's slab: its 32 (or 16) columns
constexpr float HALF_PI = 1.57079632679489662f;

static_assert(NTHREADS == 4 * TP, "the heads use 4 threads per point");
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

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

// Byte offsets of a block's shared-memory regions (host and device agree).
struct SmemLayout {
  size_t h, x, d, slab, stage, rays, z, sig, rgb, total;
  __host__ __device__ SmemLayout(int S, int rpb, bool full) {
    size_t o = 0;
    h = o;     o += align128(sizeof(bf16) * TP * LDH);
    x = o;     o += align128(sizeof(bf16) * TP * LDX);
    d = o;     o += full ? align128(sizeof(bf16) * TP * LDD) : 0;
    slab = o;  o += align128(sizeof(bf16) * NWARPS * 2 * KS * LDW);
    stage = o; o += align128(sizeof(float) * NWARPS * 256);
    rays = o;  o += align128(sizeof(float) * rpb * 8);
    z = o;     o += align128(sizeof(float) * rpb * S);
    sig = o;   o += align128(sizeof(float) * rpb * S);
    rgb = o;   o += full ? align128(sizeof(float) * rpb * S * 3) : 0;
    total = o;
  }
};

struct Smem {
  bf16* h;       // TP x LDH   activations, updated in place layer by layer
  bf16* x;       // TP x LDX   xyz input
  bf16* d;       // TP x LDD   dir input (full MLP only)
  bf16* slab;    // NWARPS x 2 x KS x LDW   per-warp weight slabs
  float* stage;  // NWARPS x 256 accumulator staging
  float* rays;   // rpb x 8
  float* z;      // rpb * S
  float* sig;    // rpb * S    raw sigma per point
  float* rgb;    // rpb * S * 3 (full MLP only)
};

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

// h[:, columns of this warp] = bf16(act(acc + bias)). The caller has
// synced the block after the last read of h.
template <int NCB, bool RELU>
__device__ __forceinline__ void store_act(FragC (&acc)[4 * NCB],
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
      float v = st[e] + __ldg(bias + col);
      if (RELU) v = fmaxf(v, 0.f);
      h[(rb * 16 + (e >> 4)) * LDH + col] = __float2bfloat16_rn(v);
    }
    __syncwarp();
  }
}

// Point gp of the block: o + d * z, rounded like the plain version.
__device__ __forceinline__ float point_coord(const Smem& sm, int S, int gp,
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

// Fill the MLP inputs for points [t0, t0 + TP) of the block; points at or
// past P (the block's valid points) get zero rows.
template <bool FULL>
__device__ void build_inputs(const Smem& sm, int S, int t0, int P) {
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
  if constexpr (FULL) {
    for (int i = threadIdx.x; i < TP * KD; i += NTHREADS) {
      const int pt = i / KD, col = i - pt * KD;
      const int gp = t0 + pt;
      float v = 0.f;
      if (gp < P) {
        const float* ray = sm.rays + (gp / S) * 8;
        if (col < 3) {
          v = ray[3 + col];
        } else if (col >= XS && col < XS + ND) {
          const int j = col - XS;
          v = sincos_col(ray[3 + j % 3], j);
        }
      }
      sm.d[pt * LDD + col] = __float2bfloat16_rn(v);
    }
  }
}

// The MLP on the tile in sm.x (and sm.d): raw sigma of the first n_valid
// points to sig_out, and (FULL) their sigmoid rgb to rgb_out.
template <bool FULL>
__device__ void mlp_tile(const MlpWeights& p, const Smem& sm, float* sig_out,
                         float* rgb_out, int n_valid) {
  FragC acc[8];
  zero(acc);
  gemm_acc<2>(acc, sm.x, LDX, p.w0, KX, sm.slab);
  store_act<2, true>(acc, p.bt, sm.h, sm.stage);
  for (int i = 1; i < D; ++i) {
    __syncthreads();              // h of layer i - 1 is complete
    zero(acc);
    gemm_acc<2>(acc, sm.h, LDH, p.wt + (size_t)(i - 1) * W * W, W, sm.slab);
    if (i == SKIP) gemm_acc<2>(acc, sm.x, LDX, p.wsk, KX, sm.slab);
    __syncthreads();              // every warp has read h
    store_act<2, true>(acc, p.bt + i * W, sm.h, sm.stage);
  }
  __syncthreads();

  const int pt = threadIdx.x >> 2, q = threadIdx.x & 3;
  {  // sigma head: 4 threads per point, 64 products each
    const bf16* hr = sm.h + pt * LDH + q * 64;
    const bf16* wr = p.ws + q * 64;
    float s = 0.f;
    for (int k = 0; k < 64; ++k)
      s += __bfloat162float(hr[k]) * __bfloat162float(wr[k]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0 && pt < n_valid) sig_out[pt] = s + p.bs[0];
  }
  if constexpr (!FULL) return;

  zero(acc);
  gemm_acc<2>(acc, sm.h, LDH, p.wf, W, sm.slab);
  __syncthreads();
  store_act<2, false>(acc, p.bf, sm.h, sm.stage);   // feature layer: linear
  __syncthreads();
  FragC acc4[4];
  zero(acc4);
  gemm_acc<1>(acc4, sm.h, LDH, p.wdf, W, sm.slab);
  gemm_acc<1>(acc4, sm.d, LDD, p.wdd, KD, sm.slab);
  __syncthreads();
  store_act<1, true>(acc4, p.bd, sm.h, sm.stage);   // h[:, :WD] = view act
  __syncthreads();

  {  // rgb head: 4 threads per point, 32 rows each, 3 channels
    const bf16* hr = sm.h + pt * LDH + q * 32;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < 32; ++k) {
      const float hv = __bfloat162float(hr[k]);
      const bf16* w = p.wr + (q * 32 + k) * 4;
      a0 += hv * __bfloat162float(w[0]);
      a1 += hv * __bfloat162float(w[1]);
      a2 += hv * __bfloat162float(w[2]);
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, m);
      a1 += __shfl_xor_sync(0xffffffffu, a1, m);
      a2 += __shfl_xor_sync(0xffffffffu, a2, m);
    }
    if (q == 0 && pt < n_valid) {
      rgb_out[pt * 3 + 0] = 1.f / (1.f + expf(-(a0 + p.br[0])));
      rgb_out[pt * 3 + 1] = 1.f / (1.f + expf(-(a1 + p.br[1])));
      rgb_out[pt * 3 + 2] = 1.f / (1.f + expf(-(a2 + p.br[2])));
    }
  }
}

}  // namespace nerf
