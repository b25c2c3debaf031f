// The NeRF point MLP on tiles of 128 points with wgmma: its trunk, its
// forward and its backward as tile loops, shared by every kernel on Hopper
// (fused_train.cu's mse_render, train_bwd and train_fwd; fused_mlp.cu's
// mlp_fwd, mlp_bwd and sigma_fwd; fused_render.cu's render_eval and
// sigma_render). A kernel forms a tile's inputs (gamma(x), and gamma(d)
// unless it needs sigma alone) from its own points (o + d z of rays, or
// rows of raw points) and runs trunk_tile on it (layers 0 .. D-1 and the
// sigma head: the sigma-only kernels) or forward_tile (trunk_tile, then
// the feature and view layers and the rgb head) and, for a backward,
// backward_tile from the heads' cotangents that it computes (the training
// quadrature's VJP, or a per-point cotangent). Every sigma of the port
// comes from trunk_tile's epilogue, so a sigma-only kernel's sigma equals
// the full forward's bit for bit.
//
// Block shape: two consumer warpgroups (warpgroup g owns rows 64 g .. 64 g
// + 63 of a tile, 232 registers a thread) and a producer warpgroup (40
// registers; one thread issues the TMA loads of the weights). Shared
// memory (bytes): the tile's inputs xd (32,768: gamma(x) cols 0..63, then
// [gamma(x) 64..79 | gamma(d)], two 64-column swizzled tiles), its
// activations / cotangents h (65,536, 4 swizzled tiles, the A operand of
// every product, K-major), a ring of nst 32 KB weight slabs, the
// epilogues' biases (9,728; 8,192 for the trunk alone) and, for a
// backward, a column-sum stage (8,448) and the heads' f32 cotangents
// (2,048).
//
// The producer streams one fixed sequence of 32 KB slabs (64 rows of K)
// per tile: the trunk's 32 (produce_trunk), then for the full forward the
// feature and view layers' (produce_fwd; W read MN-major, no copy) and,
// for a backward, the backward's (dz W^T: the same W read K-major, so the
// host builds no transposed weights). Each layer is a chain of m64n256k16
// (view layer n128) wgmma per warpgroup over the slabs, one group in
// flight, each slab released to the producer as soon as its group has
// completed. The
// epilogues work on the accumulators in registers: bias and ReLU
// (forward), the sigma-head term, the ReLU mask and the column sums
// (backward); each writes bf16 once into h (the next layer's operand) and,
// where a backward follows, the warpgroup's leader copies the rows to the
// global scratch with one TMA store per 64 columns. Within a tile the two
// warpgroups depend on no one's rows but their own, so one's epilogue
// overlaps the other's products.
//
// A backward's ReLU masks are bits that the forward's epilogue writes (16
// bytes a thread and layer, a global area of MASK_TILE_BYTES = 36 KB a
// tile) and the backward reads 16 bytes before each layer's products, in
// the same fragment layout: 1/16 of the bytes of reading the stored bf16
// activations back, 4 registers instead of 64 in flight, and no room in
// shared memory needed (a tile's masks do not fit beside the ring). A
// forward with no backward after it (train_fwd) stores neither activations
// nor masks.
//
// Everything here has internal linkage or is inline; each translation unit
// that includes it gets its own copy.
#pragma once

#include <cuda_runtime.h>

#include "mlp_grad.cuh"

namespace nerf {

constexpr int AT = 128;                   // points per tile
constexpr int A_THREADS = 384;            // 2 consumer + 1 producer WG
constexpr uint32_t SLAB_BYTES = 4 * BOX_BYTES;
constexpr uint32_t ATILE = AT * SWZ_ROW;  // one 64-column tile of AT rows
constexpr size_t MAX_SMEM = 232448;       // a block's shared memory
constexpr int N_EPI_BIAS = D * W + W + WD;   // bt, bf, bd: the epilogues'
constexpr int N_TRUNK_BIAS = D * W;          // bt alone: the trunk's
// A row of the column-sum stage: 256 columns, one padding float per 32 so
// that the 8 lane groups of warp_colsums write 8 different banks.
constexpr int ST_LD = 256 + 8;
// Floats of a warpgroup's point rows (point and direction of its 64 rows).
constexpr int PTS_WG = 64 * 6;
constexpr int MASK_LAYERS = D + 1;        // trunk layers 0..D-1, view (D)
constexpr size_t MASK_TILE_BYTES = sizeof(uint4) * MASK_LAYERS * 256;

// What a launch runs of the tile loops: the trunk alone (TRUNK: the
// sigma-only kernels), the forward (EVAL: render_eval; FWD: train_fwd and
// mlp_fwd) or the forward and the backward (BWD); the kernels' shared-memory
// layouts follow from it.
enum Pass { TRUNK, EVAL, FWD, BWD };

__device__ __forceinline__ int st_col(int c) { return c + (c >> 5); }

// The weights as TMA maps: boxes of 64 rows for the forward's MN-major
// slabs (4 x 64 columns), of 256 rows for the backward's K-major ones. The
// trunk's alone (TrunkMaps) are all that a sigma-only kernel reads; its C
// entry is given no other weight.
struct TrunkMaps {
  CUtensorMap w0, wt, wsk;
};

struct WeightMaps : TrunkMaps {
  CUtensorMap wf, wdf, wdd, wt_b, wf_b, wdf_b;
};

inline bool trunk_maps(const MlpWeights& p, TrunkMaps* m) {
  return make_map(&m->w0, p.w0, W, KX, 1, 64) &&
         make_map(&m->wt, p.wt, W, W, D - 1, 64) &&
         make_map(&m->wsk, p.wsk, W, KX, 1, 64);
}

inline bool weight_maps(const MlpWeights& p, WeightMaps* m) {
  return trunk_maps(p, m) &&
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

// A block's start: thread 0 initialises the ring's barriers (2 nst at
// `bars`), every thread copies the first nbias floats of [bt | bf | bd] to
// `eb` for the forward's epilogues (N_TRUNK_BIAS: bt alone, the trunk's).
// The caller syncs the block before either is used.
__device__ __forceinline__ Ring start_block(unsigned char* ring_buf,
                                            uint64_t* bars, int nst,
                                            const MlpWeights& p, float* eb,
                                            int nbias = N_EPI_BIAS) {
  Ring ring{ring_buf, bars, bars + nst, nst, 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 8);       // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < nbias; i += A_THREADS)
    eb[i] = i < D * W       ? p.bt[i]
            : i < D * W + W ? p.bf[i - D * W]
                            : p.bd[i - D * W - W];
  return ring;
}

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

// The producer's 32 slabs of one tile's trunk_tile (w0 2, wt 7 x 4, wsk
// 2); the consumers take the same sequence.
__device__ __forceinline__ void produce_trunk(const TrunkMaps& wm, Ring& r) {
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
}

// The producer's slabs of one tile's forward_tile: the trunk's, then the
// feature and view layers'; the consumers take the same sequence.
__device__ __forceinline__ void produce_fwd(const WeightMaps& wm, Ring& r) {
  produce_trunk(wm, r);
  for (int k = 0; k < W; k += 64) put_slab(r, &wm.wf, 4, 0, k, 0, BOX_BYTES);
  for (int k = 0; k < W; k += 64) put_slab(r, &wm.wdf, 2, 0, k, 0, BOX_BYTES);
  put_slab(r, &wm.wdd, 2, 0, 0, 0, BOX_BYTES);
}

// The producer's slabs of one tile's backward_tile.
__device__ __forceinline__ void produce_bwd(const WeightMaps& wm, Ring& r) {
  for (int k = 0; k < WD; k += 64)
    put_slab(r, &wm.wdf_b, 1, k, 0, 0, SLAB_BYTES);
  for (int k = 0; k < W; k += 64)
    put_slab(r, &wm.wf_b, 1, k, 0, 0, SLAB_BYTES);
  for (int i = D - 1; i >= 1; --i)
    for (int k = 0; k < W; k += 64)
      put_slab(r, &wm.wt_b, 1, k, 0, i - 1, SLAB_BYTES);
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

// The consumer warpgroup of this thread (threads 0..255 of the block).
__device__ __forceinline__ Wg consumer_wg() {
  const int tid = threadIdx.x;
  Wg wg;
  wg.g = tid >> 7;
  wg.t = tid & 127;
  wg.warp = (tid >> 5) & 3;
  wg.lane = tid & 31;
  wg.leader = wg.t == 0;
  return wg;
}

// Before an epilogue rewrites h: this warpgroup's bulk stores have read
// it and every warp's products are complete.
__device__ __forceinline__ void before_epilogue(const Wg& wg) {
  if (wg.leader) bulk_wait_read();
  wg.sync();
}

// After an epilogue: h is visible to wgmma and TMA; unless `map` is null,
// the leader stores the warpgroup's rows of the first `ntile64` column
// tiles to layer `layer` of `map` at scratch row `row0` (the tile's first).
__device__ __forceinline__ void after_epilogue(const Wg& wg,
                                               const CUtensorMap* map,
                                               const unsigned char* h,
                                               int ntile64, size_t row0,
                                               int layer) {
  fence_async_smem();
  wg.sync();
  if (map && wg.leader) {
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

// The ReLU masks of a backward epilogue: one bit per accumulator element
// of its thread (bit 4 j + q of the 128, as acc[4 j + q]: set where the
// forward's stored bf16 activation is > 0), slot i for trunk layer i and
// slot D for the view layer, 256 uint4 a slot.
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
// in shared memory); BITS: the ReLU mask bits to `bits`. SIGMA: also the
// sigma head of the rows, raw sigma = h . ws + bs, for tile rows below
// nv, to sig_out[row]. ws is loaded 8 column blocks at a time before it
// is used.
template <bool RELU, bool SIGMA, bool BITS>
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
      if (RELU && BITS)
        mw[j >> 3] |= (pos2(lo) | pos2(hi) << 2) << ((4 * j) & 31);
      if (SIGMA) {
        const float2 ww = bf2(w[jj]), l = bf2(lo), u = bf2(hi);
        s0 += l.x * ww.x + l.y * ww.y;
        s1 += u.x * ww.x + u.y * ww.y;
      }
    }
  }
  if (RELU && BITS)
    bits[wg.g * 128 + wg.t] = make_uint4(mw[0], mw[1], mw[2], mw[3]);
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
// bd)); BITS: its mask bits (words 0, 1) to `bits`; and the rgb head of
// the rows below nv: sigmoid(hd . wr + br), to rgb_out[3 row + c].
template <bool BITS>
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
      if (BITS) mw[j >> 3] |= (pos2(lo) | pos2(hi) << 2) << ((4 * j) & 31);
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
  if (BITS) bits[wg.g * 128 + wg.t] = make_uint4(mw[0], mw[1], 0u, 0u);
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
// and the scratch rows dzd (the tile's first), column sums to the warp's
// row of `stage`.
inline __device__ void view_backward(const Wg& wg, const uint4& mb,
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

// The warpgroup's rows of a tile whose points and directions are in pts
// (6 floats a row, this warpgroup's 64 rows; zero rows at or past nv):
// gamma(x) and, DIRS, gamma(d) into xd (swizzled) and, KEEP, the scratch
// rows gx and gd (the tile's first); then xd is visible to wgmma. The
// trunk reads only gamma(x) (xd's columns 0..KX-1: layer 0 and the skip
// take one 16-wide K step of the second tile), so a sigma-only kernel
// builds no gamma(d) and gives no directions.
template <bool KEEP, bool DIRS = true>
__device__ void embed_tile(const Wg& wg, int nv, const float* pts,
                           unsigned char* xd, bf16* __restrict__ gx,
                           bf16* __restrict__ gd) {
  wg.sync();                              // pts is complete
  for (int i = wg.t; i < 64 * (KX / 2); i += 128) {
    const int r = 64 * wg.g + i / (KX / 2), col = 2 * (i % (KX / 2));
    const float* q = pts + (r & 63) * 6;
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
    if (KEEP) *reinterpret_cast<uint32_t*>(gx + (size_t)r * KX + col) = b;
  }
  for (int i = wg.t; DIRS && i < 64 * (KD / 2); i += 128) {
    const int r = 64 * wg.g + i / (KD / 2), col = 2 * (i % (KD / 2));
    const float* q = pts + (r & 63) * 6 + 3;
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
    if (KEEP) *reinterpret_cast<uint32_t*>(gd + (size_t)r * KD + col) = b;
  }
  fence_async_smem();
  wg.sync();
}

// Layers 0 .. D-1 of one tile whose inputs are in xd, on the warpgroup's
// rows: every layer's products over the ring's slabs (produce_trunk's
// sequence) into the caller's accumulators and its epilogue into h, layer
// D-1's with the sigma head: raw sigma of the tile rows below nv to
// sig_out[row]. act (non-null when KEEP) takes every bf16 activation
// (scratch rows from row0) and `bits` the ReLU masks of the trunk's
// layers. h then holds layer D-1's activations. (forward_tile passes the
// accumulators of its later layers: with an array of its own here, nvcc
// spilled 44 bytes in the backwards' launch A, 4-8% slower.)
template <bool KEEP>
__device__ __forceinline__ void trunk_tile(float (&acc)[128], const Wg& wg,
                                           Ring& ring, int& held,
                                           const MlpWeights& p,
                                           const float* eb,
                                           const CUtensorMap* act,
                                           const unsigned char* xd,
                                           unsigned char* h, uint4* bits,
                                           size_t row0, int nv,
                                           float* sig_out) {
  const unsigned char* hA = h + wg.g * 64 * SWZ_ROW;    // this WG's rows
  const unsigned char* xA = xd + wg.g * 64 * SWZ_ROW;
  const uint32_t hs = smem_u32(h);
  auto slot = [&](int i) { return KEEP ? bits + i * 256 : nullptr; };
  int scale = 0;
  slab_mma<256, 1>(acc, ring, xA, 4, 0, scale, held);       // layer 0
  slab_mma<256, 1>(acc, ring, xA + ATILE, 1, 0, scale, held);
  slabs_done(acc, ring, held);
  before_epilogue(wg);
  epi_fwd256<true, false, KEEP>(acc, wg, eb, hs, p, nullptr, nv, slot(0));
  after_epilogue(wg, act, h, 4, row0, 0);
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
    if (i == D - 1)                       // + the sigma head
      epi_fwd256<true, true, KEEP>(acc, wg, eb + i * W, hs, p, sig_out, nv,
                                   slot(i));
    else
      epi_fwd256<true, false, KEEP>(acc, wg, eb + i * W, hs, p, nullptr, nv,
                                    slot(i));
    after_epilogue(wg, act, h, 4, row0, i);
  }
}

// The forward of one tile whose inputs are in xd, on the warpgroup's
// rows: trunk_tile, then the feature and view layers' products over the
// ring's slabs (produce_fwd's sequence) and their epilogues into h; raw
// sigma of the tile rows below nv to sig_out[row], their rgb after the
// sigmoid to rgb_out[3 row + c]. KEEP (a backward follows): every bf16
// activation also goes to the scratch (scm, rows from row0) and the ReLU
// masks to `bits` (the tile's MASK_TILE_BYTES).
template <bool KEEP>
__device__ void forward_tile(const Wg& wg, Ring& ring, int& held,
                             const MlpWeights& p, const float* eb,
                             const ScratchMaps* scm, const unsigned char* xd,
                             unsigned char* h, uint4* bits, size_t row0,
                             int nv, float* sig_out, float* rgb_out) {
  const unsigned char* hA = h + wg.g * 64 * SWZ_ROW;    // this WG's rows
  const unsigned char* xA = xd + wg.g * 64 * SWZ_ROW;
  const uint32_t hs = smem_u32(h);
  const CUtensorMap* act = KEEP ? &scm->m[MAP_ACT] : nullptr;
  float acc[128];
  trunk_tile<KEEP>(acc, wg, ring, held, p, eb, act, xd, h, bits, row0, nv,
                   sig_out);
  int scale = 0;
  for (int k = 0; k < 4; ++k)             // feature layer (linear)
    slab_mma<256, 1>(acc, ring, hA + k * ATILE, 4, 0, scale, held);
  slabs_done(acc, ring, held);
  before_epilogue(wg);
  epi_fwd256<false, false, false>(acc, wg, eb + D * W, hs, p, nullptr, nv,
                                  nullptr);
  after_epilogue(wg, act, h, 4, row0, D);
  float av[64];                           // view layer and rgb head
  scale = 0;
  for (int k = 0; k < 4; ++k)
    slab_mma<128, 1>(av, ring, hA + k * ATILE, 4, 0, scale, held);
  slab_mma<128, 1>(av, ring, xA + ATILE + 32, 3, 0, scale, held);
  slabs_done(av, ring, held);
  before_epilogue(wg);
  epi_view<KEEP>(av, wg, p, eb + D * W + W, hs, rgb_out, nv,
                 KEEP ? bits + D * 256 : nullptr);
  after_epilogue(wg, KEEP ? &scm->m[MAP_HD] : nullptr, h, 2, row0, 0);
}

// The backward of one tile after its forward_tile<true>, on the
// warpgroup's rows. heads(row) gives the f32 cotangents [v0, v1, v2, gs]
// of tile row row < nv on the rgb head's pre-activation and on raw sigma
// (zero past nv); they go to dzr_s and the scratch's dzr rows, then every
// data gradient (view, feature and trunk layers 7 .. 0; dz_i = mask_i
// (dz_{i+1} W_i^T) over the ring's slabs, produce_bwd's sequence) into h
// and the scratch, their f32 column sums added to the warpgroup's bias
// row. bits: the tile's masks.
template <class Heads>
__device__ void backward_tile(const Wg& wg, Ring& ring, int& held,
                              const MlpWeights& p, const ScratchMaps& scm,
                              const Scratch& s, unsigned char* h,
                              float* dzr_s, float* stage, float* bias,
                              const uint4* bits, size_t row0, int nv,
                              const Heads& heads) {
  const unsigned char* hA = h + wg.g * 64 * SWZ_ROW;
  const uint32_t hs = smem_u32(h);
  const uint4* mine = bits + wg.g * 128 + wg.t;
  uint4 mb = __ldcg(mine + D * 256);
  before_epilogue(wg);
  if (wg.t < 64) {                        // the heads' cotangents
    const int row = 64 * wg.g + wg.t;
    const float4 v = row < nv ? heads(row) : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d4 = dzr_s + row * 4;
    d4[0] = v.x;
    d4[1] = v.y;
    d4[2] = v.z;
    d4[3] = v.w;
    uint4* out = reinterpret_cast<uint4*>(s.dzr + (row0 + row) * DZR_W);
    out[0] = make_uint4(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w), 0u, 0u);
    out[1] = make_uint4(0u, 0u, 0u, 0u);
  }
  wg.sync();
  if (wg.t < 4) {                         // br (cols 0..2) and bs (col 3)
    float sum = 0.f;
    for (int r = 0; r < 64; ++r) sum += dzr_s[(64 * wg.g + r) * 4 + wg.t];
    bias[wg.t < 3 ? BR + wg.t : BS] += sum;
  }
  view_backward(wg, mb, dzr_s, p, hs, s.dzd + row0 * WD, stage, nv);
  fence_async_smem();
  wg.sync();
  add_colsums(wg, stage, bias + BD, WD);

  float acc[128];
  int scale = 0;                          // feature layer (linear)
  for (int k = 0; k < 2; ++k)
    slab_mma<256, 0>(acc, ring, hA + k * ATILE, 4, 0, scale, held);
  slabs_done(acc, ring, held);
  before_epilogue(wg);
  epi_bwd256<false, false>(acc, wg, mb, dzr_s, p.ws, hs, stage, nv);
  after_epilogue(wg, &scm.m[MAP_DZ], h, 4, row0, D);
  add_colsums(wg, stage, bias + BF, W);
  for (int i = D - 1; i >= 0; --i) {      // + sigma head -> trunk 7 .. 0
    mb = __ldcg(mine + i * 256);
    scale = 0;
    for (int k = 0; k < 4; ++k)
      slab_mma<256, 0>(acc, ring, hA + k * ATILE, 4, 0, scale, held);
    slabs_done(acc, ring, held);
    before_epilogue(wg);
    if (i == D - 1)
      epi_bwd256<true, true>(acc, wg, mb, dzr_s, p.ws, hs, stage, nv);
    else
      epi_bwd256<true, false>(acc, wg, mb, dzr_s, p.ws, hs, stage, nv);
    after_epilogue(wg, &scm.m[MAP_DZ], h, 4, row0, i);
    add_colsums(wg, stage, bias + BT + i * W, W);
  }
}

}  // namespace nerf
