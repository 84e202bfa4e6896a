// What the bf16 flash kernels on Hopper share beside the tile machinery of
// sm90_tile.cuh: the geometry of a block that owns a 128-row q tile (K4 in
// flash_fwd_sm90.cu, K7 in flash_bwd_dq_sm90.cu: two consumer warpgroups
// of 64 rows, key tiles streamed through a ring), the TMA box and swizzle
// constants of a [rows, D] bf16 tile, the two products of such a block
// (`issue_s`: A.B^T of a consumer's 64 rows against a key tile, both
// K-major; `issue_pv`: A.B with A the bf16 fragments of an accumulator
// (`pack_p`) and B a key tile read MN-major), and the backward's
// exponential and mask rules (`fast_exp2`, `masked_p`), which K7 shares
// with K9 and K8 (flash_bwd_sm90.cu) so that their bf16 p and ds agree.
// The bf16 ragged-stream K1 (ragged_stream_sm90.cu) takes `Boxes`,
// `issue_s` (over its 64-row tiles), `issue_pv` and `pack_p`.
#pragma once

#include "flash_common.cuh"
#include "sm90_tile.cuh"

namespace pt {
namespace flash {

constexpr int kTileQ = 128;  // q rows per block (K4, K7): 2 consumers x 64
constexpr int kTileK = 128;  // keys per streamed tile (the default)
constexpr int kTileThreads = 384;    // producer + 2 consumer warpgroups
constexpr int kTileConsumers = 256;  // arrivals that empty a stage
constexpr int kBiasLoaders = 32;     // producer warp 1 stages the bias
constexpr float kLog2e = 1.4426950408889634f;

// A [rows, D] bf16 tile lands in shared memory as kBoxes TMA boxes of kBox
// columns, each swizzled over kSwizzle bytes a row (sm90_tile.cuh).
template <int D>
struct Boxes {
  static constexpr int kBox = D < 64 ? D : 64;  // columns per TMA box
  static constexpr int kSwizzle = kBox * 2;     // bytes per box row
  static constexpr int kBoxes = D / kBox;
};

// Issues acc = A.B^T of one key tile for a consumer's 64 rows as one wgmma
// group: a_s its rows of a QT-row tile's boxes (Q; dO in K7; K1's 64-row
// tiles), b_s the BK-key tile's boxes (K; V in K7), both K-major.
template <int D, int BK = kTileK, int QT = kTileQ>
__device__ __forceinline__ void issue_s(float (&acc)[BK / 2], uint32_t a_s,
                                        uint32_t b_s) {
  using G = Boxes<D>;
  static_assert(BK == 128 || BK == 64, "key tiles of 64 or 128");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int b = kk * 16 / G::kBox, c = kk * 16 % G::kBox;
    const uint64_t da = sm90::wgmma_desc(
        a_s + b * QT * G::kSwizzle + 2 * c, 16, 8 * G::kSwizzle,
        G::kSwizzle);
    const uint64_t db = sm90::wgmma_desc(b_s + b * BK * G::kSwizzle + 2 * c,
                                         16, 8 * G::kSwizzle, G::kSwizzle);
    if constexpr (BK == 128)
      sm90::wgmma_ss_m64n128(acc, da, db, kk > 0);
    else
      sm90::wgmma_ss_m64n64(acc, da, db, kk > 0);
  }
  sm90::wgmma_commit();
}

// Issues o += A.B of one key tile as one wgmma group: A the bf16
// fragments of its BK / 16 key steps (P in K4, dS in K7), b_s the tile's
// boxes read MN-major through transpose-B (V in K4, K in K7).
template <int D, int BK = kTileK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t b_s) {
  using G = Boxes<D>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    sm90::wgmma_rs_tb<D>(
        o, pa[kk],
        sm90::wgmma_desc(b_s + kk * 16 * G::kSwizzle, BK * G::kSwizzle,
                         8 * G::kSwizzle, G::kSwizzle));
  sm90::wgmma_commit();
}

// An m64nN float32 accumulator (M = N / 2 registers a thread) as the bf16
// A fragments of its N / 16 key steps (registers 8k .. 8k+7 packed
// pairwise: sm90_tile.cuh).
template <int M>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[M / 8][4],
                                       const float (&sc)[M]) {
#pragma unroll
  for (int i = 0; i < M; i += 2)
    pa[i / 8][(i % 8) / 2] = sm90::pack_bf16(sc[i], sc[i + 1]);
}

// 2^x by the special-function unit (2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p of one score (query i, key j) on a tile that needs the mask
// (`tile_p_ds`'s rules): code < 0 marks a dead row (p = -code = 1 / Sk
// for every key; its ds is 0), code > 0 a fully masked row (p = code =
// 1 / keys it sees); x is the score in log2 units less the row's LSE.
__device__ __forceinline__ float masked_p(const Shape& sh, int i, int j,
                                          float x, float code) {
  if (code < 0.f) return j < sh.Sk ? -code : 0.f;
  if (j >= sh.Sk || i >= sh.Sq || !visible(sh, i, j)) return 0.f;
  return code > 0.f ? code : fast_exp2(x);
}

// The row code of query i given its LSE l (natural log): < 0 for a dead
// row, > 0 for a fully masked one (see masked_p), else 0.
__device__ __forceinline__ float row_code(const Shape& sh, int i, float l) {
  if (dead_row(sh, i)) return -1.f / static_cast<float>(sh.Sk);
  if (l <= kMaskedLse) return 1.f / static_cast<float>(visible_keys(sh, i));
  return 0.f;
}

}  // namespace flash
}  // namespace pt
