// K9 and K9 bias, and K8 and K8 bias, in bfloat16 and float16 on Hopper's
// tensor cores (sm_90a): one key-tile body, templated on the element type
// T and on WithDq as the SIMT `bwd_key_tile<..., WithDq>` of
// flash_common.cuh is.
//   K9 `flash_bwd_sm90_kernel` (WithDq) <- the fused flash backward of
//      paddle_tpu/ops/pallas/flash_attention.py `_flash_bwd_fused`
//      (pallas_call at :534, body `_bwd_fused_kernel`, and its `has_bias`
//      variant): dk, dv, dbias and dq;
//   K8 `flash_bwd_dkv_sm90_kernel` <- the dk/dv pass of the two-pass
//      `_flash_bwd` (pallas_call at :615, body `_bwd_dkv_kernel`, and its
//      `has_bias` variant): dk, dv and dbias only, reached from
//      flash_bwd_two_pass.cu's `bwd_dkv`.
// Both keep the contract of flash_attention.cu's K9 and of `tile_p_ds`
// (flash_common.cuh): p = exp(s * scale + bias - lse) from the LSE it is
// given (never renormalised: ring attention passes a global LSE to K8),
// bottom-right causal alignment, a dead row (causal, Sq > Sk) with
// p = 1 / Sk and ds = 0 that joins every key tile, a fully masked row
// (lse <= -1e29) with p = 1 / (keys it sees), zeros for masked entries and
// entries past Sq or Sk, dk scaled once at the end, dbias [BH, Sk] float32
// the column sums of ds in float32 before any rounding, written once
// without atomics; any Sq, Sk >= 1, D in {32, 64, 128}. As the reference's
// `_tile_p_ds` (`p.astype(do.dtype)`, `ds.astype(k.dtype)`), p and ds are
// rounded to T before they enter the products. In float16 dbias sums the
// rounded ds, as the reference's `ds.astype(jnp.float32)` column sums do,
// so a ds past float16's range (under a loss scale) gives +-inf there as
// it does in dq and dk; bf16, whose range is float32's, sums ds before
// its rounding (ROADMAP §C 7). K9's dq is summed
// across key tiles into the zeroed float32 workspace dq_ws, which
// flash_attention.cu's `scale_cast_kernel` then scales and casts. The
// float32 K9 and K8 stay the SIMT kernels of flash_attention.cu and
// flash_bwd_two_pass.cu: TF32 products would not hold float32 parity.
//
// What bounds them on an H100: 10 (K9) or 8 (K8) * BH * D * (visible
// pairs) FLOPs at 989 TFLOP/s against q, k, v, dO, lse and delta read and
// dk, dv (and K9's dq) written at 3.35 TB/s; at GPT-2-small training
// shapes (BH 192, S 1024, D 64, causal) operations, ~0.065 (K9) and
// ~0.052 ms (K8). Per (key tile, q tile) pair K9 runs five tensor-core
// products and K8 four, and both one exponential per score. The SIMT
// kernels ran them as float32 FMAs from synchronously loaded float32
// tiles, K9 adding dq with one atomic per element per pair.
//
// The design:
//   * One block per (128-key tile, bh) on a 1-D grid (any B * H), in
//     groups of bh of about 256 blocks; inside a group the key tiles go
//     heaviest first across its bh (under causal masking the first key
//     tiles see the most q tiles). A group's q, dO (and K9's dq) rows stay
//     in L2 while its blocks stream (and add into) them; on an H100 this
//     order beat K4's (heaviest first across every bh) and one bh's key
//     tiles in a row at the shapes tried for K9 (PERF.md).
//   * 384 threads. Warpgroup 0 is the producer: one thread loads the
//     block's K and V tile once by TMA and streams 64-row Q and dO tiles
//     through a ring of stages (a full and an empty mbarrier per stage):
//     K9 3, or 2 at D 128; K8, which holds no dS or dQ tile, 4, or 3 at
//     D 128. Warp 1 stages those rows' LSE (in log2 units, negated),
//     delta and a per-row code (dead row, fully masked row) with ordinary
//     loads beside them (a [BH, Sq] row slice is not 16-byte aligned in
//     general). The warpgroup hands its registers to warpgroups 1 and 2,
//     the consumers, which own 64 keys each.
//   * The products run transposed, so that p and ds stay in the
//     consumer's registers as the A operand of the next ones: S^T = K.Q^T
//     and dP^T = V.dO^T are wgmma m64n64k16 with both operands K-major in
//     shared memory; dV += P^T.dO and dK += dS^T.Q are wgmma with P^T and
//     dS^T (in T) in registers and dO and Q MN-major through transpose-B.
//     In this layout a thread's rows are keys (the bias is a per-row
//     value) and its columns queries (LSE and delta per column); dbias
//     is a row sum, reduced across the four lanes of a quad at the end.
//   * K9's dQ = dS.K: each consumer stores its dS^T, in T, into shared
//     memory as dS [q, key] in the 128-byte swizzled K-major layout that
//     a wgmma descriptor reads (two buffers, by tile parity: the other
//     consumer may still be reading the last tile's); after a named
//     barrier the two consumers split D, and each runs an m64n(D/2)
//     product over all 128 keys with K MN-major through transpose-B.
//     Each writes its float32 half of the dQ tile to shared memory in the
//     swizzled boxes of a float32 tensor map of dq_ws (conflict-free
//     stores) and one thread adds them into dq_ws with
//     `cp.reduce.async.bulk.tensor ... add` (rows past Sq are not
//     written): one or two bulk operations per consumer and (key tile,
//     q tile) pair in place of 64 * D atomics, behind a barrier of its
//     own warpgroup only. K8 has none of this: its two consumers share
//     nothing but the ring and run apart, one's products beside the
//     other's exponentials.
//   * The full mask rules run only on tiles that hold a dead or fully
//     masked row; a tile across the causal diagonal adds one compare per
//     score. Keys past Sk carry a -inf bias and rows past Sq an LSE of
//     +inf, so the fast path (one FMA, one add and one ex2 for p; a
//     subtract and a multiply for ds) gives them p = ds = 0 without a
//     test.
//   * Branches around wgmma are warp-uniform (the role comes from a
//     shuffle): under a branch the compiler cannot prove uniform, it
//     serialises the wgmma instructions.
//   * dk, dv and dbias are owned by one block and summed in one order:
//     bitwise reproducible, and K8's equal K9's bit for bit (the same
//     per-tile arithmetic in the same q-tile order). K9's dq is summed by
//     the bulk reductions of every key tile in the order the blocks run,
//     so its last bits vary.

#include "flash_sm90.cuh"

namespace pt {
namespace flash {
namespace {

constexpr int kBwdBK = 128;        // keys per block: 2 consumers x 64
constexpr int kBwdBQ = 64;         // q rows per streamed tile
constexpr int kBwdThreads = 384;   // producer + 2 consumer warpgroups
constexpr int kBwdConsumers = 256; // arrivals that empty a stage
constexpr int kStagers = 32;       // producer warp 1 stages the rows
constexpr int kGroupBlocks = 256;  // blocks per group of bh, launch order

template <int D, bool WithDq>
struct BwdTiles {
  // Q/dO tiles in flight: K9 3, or 2 at D 128, where a third would pass
  // the 227 KB a block can have; K8 (no dS, no dQ tile) 4, or 3 at D 128
  static constexpr int kStages =
      WithDq ? (D == 128 ? 2 : 3) : (D == 128 ? 3 : 4);
  static constexpr int kBox = D < 64 ? D : 64;  // columns per TMA box
  static constexpr int kSwizzle = kBox * 2;     // bytes per box row
  static constexpr int kBoxes = D / kBox;
  static constexpr int kKVBytes = kBwdBK * D * 2;  // the K (or V) tile
  static constexpr int kQBytes = kBwdBQ * D * 2;   // one Q (or dO) tile
  // K, V, the Q stages, the dO stages, and with dq two buffers of dS [64
  // q x 128 keys] in T (tile n in buffer n % 2), each two 64-key boxes
  // (128-byte swizzle), and the float32 dQ tile [64, D]; then the staged
  // rows (per stage: -LSE in log2 units, delta and the row code, 64
  // floats each, then a flag), then the barriers: kv, full[], empty[]
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kDS = kDO + kStages * kQBytes;
  static constexpr int kDSBytes = kBwdBQ * kBwdBK * 2;  // one dS buffer
  static constexpr int kDQ = kDS + (WithDq ? 2 * kDSBytes : 0);
  static constexpr int kRows = kDQ + (WithDq ? kBwdBQ * D * 4 : 0);
  static constexpr int kRowBytes = (3 * kBwdBQ + 4) * 4;
  static constexpr int kBar = kRows + kStages * kRowBytes;
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) +
                               1024;  // slack to align the base to 1024
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// Issues acc = A.B^T for a consumer's 64 keys against one 64-row tile
// (S^T = K.Q^T, dP^T = V.dO^T): a_s its rows of the K or V boxes, b_s the
// stage's Q or dO boxes, both K-major; one wgmma group.
template <typename T, int D>
__device__ __forceinline__ void issue_kq(float (&acc)[32], uint32_t a_s,
                                         uint32_t b_s) {
  using G = BwdTiles<D, true>;  // the layout of a tile is the same in K8
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int b = kk * 16 / G::kBox, c = kk * 16 % G::kBox;
    sm90::wgmma_ss_m64n64<T>(
        acc,
        sm90::wgmma_desc(a_s + b * kBwdBK * G::kSwizzle + 2 * c, 16,
                         8 * G::kSwizzle, G::kSwizzle),
        sm90::wgmma_desc(b_s + b * kBwdBQ * G::kSwizzle + 2 * c, 16,
                         8 * G::kSwizzle, G::kSwizzle),
        kk > 0);
  }
  sm90::wgmma_commit();
}

// acc += A.B over the tile's 64 q rows (dV += P^T.dO, dK += dS^T.Q): A the
// T fragments of the 4 q steps, b_s the stage's dO or Q boxes read
// MN-major. Not committed: the caller groups it.
template <typename T, int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          const uint32_t (&a)[4][4],
                                          uint32_t b_s) {
  using G = BwdTiles<D, true>;
#pragma unroll
  for (int kk = 0; kk < kBwdBQ / 16; ++kk)
    sm90::wgmma_rs_tb<D, T>(
        acc, a[kk],
        sm90::wgmma_desc(b_s + kk * 16 * G::kSwizzle, kBwdBQ * G::kSwizzle,
                         8 * G::kSwizzle, G::kSwizzle));
}

// Issues this consumer's half of dQ = dS.K over the block's 128 keys: dS
// [64 q x 128 keys] K-major in two 64-key boxes at ds_s, K MN-major
// (transpose-B) from column wg * D / 2 (an offset inside a swizzled box
// at D <= 64: the hardware swizzles the address, as it does for the
// K-major steps inside a box). One wgmma group.
template <typename T, int D>
__device__ __forceinline__ void issue_dq(float (&acc)[D / 4], uint32_t ds_s,
                                         uint32_t k_s, int wg) {
  using G = BwdTiles<D, true>;
  const int col = wg * (D / 2);
  const uint32_t kb = k_s + (col / G::kBox) * kBwdBK * G::kSwizzle +
                      2 * (col % G::kBox);
#pragma unroll
  for (int kk = 0; kk < kBwdBK / 16; ++kk)
    sm90::wgmma_ss_tb<D / 2, T>(
        acc,
        sm90::wgmma_desc(ds_s + (kk / 4) * kBwdBQ * 128 + 32 * (kk % 4), 16,
                         8 * 128, 128),
        sm90::wgmma_desc(kb + kk * 16 * G::kSwizzle, kBwdBK * G::kSwizzle,
                         8 * G::kSwizzle, G::kSwizzle),
        kk > 0);
  sm90::wgmma_commit();
}

// Byte offset of float32 element (row, col) in a box of 64 rows of
// `row_bytes` (128 or 64) as TMA swizzles it: 16-byte chunks XORed with
// the row's position in the swizzle period.
template <int RowBytes>
__device__ __forceinline__ int swizzled_f32(int row, int col) {
  const int chunk = col * 4 / 16;
  const int phase = RowBytes == 128 ? row % 8 : (row / 2) % 4;
  return row * RowBytes + ((chunk ^ phase) * 16) + (col * 4) % 16;
}

// The body of K9 (WithDq: dq_ws and its map dqmap) and K8 (without): one
// block's key tile. The maps are the kernel's __grid_constant__
// parameters, passed by reference so that TMA reads them in place.
template <typename T, int D, bool HasBias, bool WithDq>
__device__ __forceinline__ void bwd_sm90_block(
    const CUtensorMap& qmap, const CUtensorMap& kmap,
    const CUtensorMap& vmap, const CUtensorMap& domap,
    const CUtensorMap* dqmap, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dbias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, const Shape& sh) {
  using G = BwdTiles<D, WithDq>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t k_s = base, v_s = base + G::kV;
  auto q_st = [&](int s) { return base + G::kQ + s * G::kQBytes; };
  auto do_st = [&](int s) { return base + G::kDO + s * G::kQBytes; };
  // a stage's rows: -LSE * log2 e at [0, 64) (-inf past Sq), delta at
  // [64, 128), the row code at [128, 192), and at 192 a flag: some row of
  // the stage is dead or fully masked
  auto rows = [&](int s) {
    return reinterpret_cast<float*>(gbase + G::kRows + s * G::kRowBytes);
  };
  const uint32_t kv_bar = base + G::kBar;
  auto full = [&](int s) { return kv_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_bar + 8 * (1 + G::kStages + s); };

  // launch order: groups of bh, each with about kGroupBlocks blocks, and
  // inside a group the key tiles heaviest first (under causal masking the
  // first key tiles see the most q tiles) across its bh
  const int ntk = (sh.Sk + kBwdBK - 1) / kBwdBK;  // key tiles of a bh
  const int BH = gridDim.x / ntk;
  const int gsize = max(1, kGroupBlocks / ntk);    // bh per group
  const int g0 = blockIdx.x / (gsize * ntk) * gsize;
  const int gn = min(gsize, BH - g0);
  const int within = blockIdx.x - g0 * ntk;
  const int bh = g0 + within % gn;
  const int k0 = within / gn * kBwdBK;
  // the first q tile that reaches the key tile (query i sees key k0 iff
  // i >= k0 - off); with Sq > Sk the dead rows join every key tile
  int qstart = 0;
  if (sh.causal && sh.off >= 0) qstart = max(0, k0 - sh.off) / kBwdBQ * kBwdBQ;
  const int ntiles = (sh.Sq - qstart + kBwdBQ - 1) / kBwdBQ;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_bar, 1);
    for (int s = 0; s < G::kStages; ++s) {
      sm90::mbar_init(full(s), 1 + kStagers);
      sm90::mbar_init(empty(s), kBwdConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, made warp-uniform (a shuffle) so that the
  // compiler sees no divergence around the wgmma instructions
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread keeps the ring full of TMA loads; warp 1
    // stages each tile's rows beside them ----
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch(&qmap);
      sm90::tma_prefetch(&domap);
      sm90::mbar_expect_tx(kv_bar, 2 * G::kKVBytes);
      for (int b = 0; b < G::kBoxes; ++b) {
        const uint32_t off = b * kBwdBK * G::kSwizzle;
        sm90::tma_load_3d(k_s + off, &kmap, kv_bar, b * G::kBox, k0, bh);
        sm90::tma_load_3d(v_s + off, &vmap, kv_bar, b * G::kBox, k0, bh);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % G::kStages;
        // wait for the consumers to release the stage's previous tile
        if (n >= G::kStages)
          sm90::mbar_wait(empty(s), (n / G::kStages + 1) & 1);
        sm90::mbar_expect_tx(full(s), 2 * G::kQBytes);
        const int q0 = qstart + n * kBwdBQ;
        for (int b = 0; b < G::kBoxes; ++b) {
          const uint32_t off = b * kBwdBQ * G::kSwizzle;
          sm90::tma_load_3d(q_st(s) + off, &qmap, full(s), b * G::kBox, q0,
                            bh);
          sm90::tma_load_3d(do_st(s) + off, &domap, full(s), b * G::kBox,
                            q0, bh);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      const int64_t row0 = static_cast<int64_t>(bh) * sh.Sq;
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % G::kStages;
        if (n >= G::kStages)
          sm90::mbar_wait(empty(s), (n / G::kStages + 1) & 1);
        float* r = rows(s);
        const int q0 = qstart + n * kBwdBQ;
        bool special = false;
#pragma unroll
        for (int c = lane; c < kBwdBQ; c += 32) {
          const int i = q0 + c;
          // rows past Sq: -inf gives them p = 0
          float nl2 = -INFINITY, dl = 0.f, code = 0.f;
          if (i < sh.Sq) {
            const float l = lse[row0 + i];
            nl2 = -l * kLog2e;
            dl = delta[row0 + i];
            code = row_code(sh, i, l);
          }
          r[c] = nl2;
          r[kBwdBQ + c] = dl;
          r[2 * kBwdBQ + c] = code;
          special |= code != 0.f;
        }
        special = __any_sync(0xffffffffu, special);
        if (lane == 0) reinterpret_cast<int*>(r)[3 * kBwdBQ] = special;
        sm90::mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    sm90::regs_alloc<240>();
    const int wg = role - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool issuer = threadIdx.x % 128 == 0;  // adds this half of dQ
    const int kc0 = k0 + 64 * wg;               // this warpgroup's keys
    const int rl = 16 * warp + lane / 4;        // its rows: rl, rl + 8
    const int cq = 2 * (lane % 4);  // its columns in each 8-column chunk
    const float scale2 = sh.scale * kLog2e;
    // the bias of the thread's two keys in log2 units; -inf past Sk
    const float* brow = bias_row(bias, sh, bh);
    float b2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = kc0 + rl + 8 * h;
      b2[h] = j >= sh.Sk ? -INFINITY : HasBias ? brow[j] * kLog2e : 0.f;
    }
    float dk_acc[D / 2], dv_acc[D / 2], db[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t kw_s = k_s + 64 * wg * G::kSwizzle;  // its K rows
    const uint32_t vw_s = v_s + 64 * wg * G::kSwizzle;  // its V rows
    // K9: where the thread's dS entries go: its 64-key box of dS [q, key]
    // (row q at 128 bytes, 16-byte chunks swizzled by q % 8); the key of
    // row rl + 8h sits in chunk 2 * warp + h at lane / 4, query
    // 8a + cq + e at ds_at[h][e] + 1024a (+ the buffer's offset)
    uint8_t* ds_at[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ds_at[h][e] = gbase + G::kDS + wg * kBwdBQ * 128 + (cq + e) * 128 +
                      (((2 * warp + h) ^ (cq + e)) * 16) + (lane / 4) * 2;
    // K9: this warpgroup's half of the float32 dQ tile: columns wg * D / 2
    // on, in boxes of kDqBox columns as the dq map's TMA swizzle lays them
    // out
    constexpr int kDqBox = D / 2 < 32 ? D / 2 : 32;
    constexpr int kDqRow = kDqBox * 4;  // bytes: 128, or 64 at D 32
    const uint32_t dq_s = base + G::kDQ + wg * kBwdBQ * (D / 2) * 4;
    uint8_t* dq_g = gbase + G::kDQ + wg * kBwdBQ * (D / 2) * 4;
    sm90::mbar_wait(kv_bar, 0);

    for (int n = 0; n < ntiles; ++n) {
      const int s = n % G::kStages;
      const int q0 = qstart + n * kBwdBQ;
      const int dsb = (n % 2) * G::kDSBytes;  // K9: this tile's dS buffer
      sm90::mbar_wait(full(s), (n / G::kStages) & 1);
      float st[32], dpt[32];
      sm90::wgmma_fence();
      issue_kq<T, D>(st, kw_s, q_st(s));
      issue_kq<T, D>(dpt, vw_s, do_st(s));
      sm90::wgmma_wait<1>();  // S^T is in; dP^T runs on
      sm90::fence_regs(st);

      const float* r = rows(s);
      // a dead or fully masked row in the tile; a tile across the causal
      // diagonal (keys past Sk and rows past Sq need neither: their -inf
      // bias or LSE gives p = 0)
      const bool special = reinterpret_cast<const int*>(r)[3 * kBwdBQ] != 0;
      const bool diagonal = sh.causal && kc0 + 63 > q0 + sh.off;
      // P^T, kept in st in float32 and as A fragments in T in pa
      uint32_t pa[4][4], dsa[4][4];
      if (!special) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int h = (i / 2) % 2, c = 8 * (i / 4) + cq;
          const float2 nl = *reinterpret_cast<const float2*>(r + c);
          st[i] = fast_exp2(fmaf(st[i], scale2, nl.x) + b2[h]);
          st[i + 1] = fast_exp2(fmaf(st[i + 1], scale2, nl.y) + b2[h]);
          if (diagonal) {  // query q0 + c + e sees key kc0 + rl + 8h?
            const int lag = kc0 + rl + 8 * h - q0 - c - sh.off;
            if (lag > 0) st[i] = 0.f;
            if (lag > 1) st[i + 1] = 0.f;
          }
          pa[i / 8][(i % 8) / 2] = sm90::pack2<T>(st[i], st[i + 1]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int h = (i / 2) % 2, c = 8 * (i / 4) + cq;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            st[i + e] = masked_p(sh, q0 + c + e, kc0 + rl + 8 * h,
                                 fmaf(st[i + e], scale2, r[c + e]) + b2[h],
                                 r[2 * kBwdBQ + c + e]);
          pa[i / 8][(i % 8) / 2] = sm90::pack2<T>(st[i], st[i + 1]);
        }
      }
      // dV += P^T.dO runs while dS^T is formed
      sm90::wgmma_fence();
      issue_acc<T, D>(dv_acc, pa, do_st(s));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // dP^T is in
      sm90::fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i / 2) % 2, c = 8 * (i / 4) + cq;
        const float2 dl = *reinterpret_cast<const float2*>(r + kBwdBQ + c);
        float ds0 = st[i] * (dpt[i] - dl.x);
        float ds1 = st[i + 1] * (dpt[i + 1] - dl.y);
        if (special) {  // a dead row (code < 0) takes no gradient
          if (r[2 * kBwdBQ + c] < 0.f) ds0 = 0.f;
          if (r[2 * kBwdBQ + c + 1] < 0.f) ds1 = 0.f;
        }
        const uint32_t d2 = sm90::pack2<T>(ds0, ds1);
        if constexpr (HasBias) {
          if constexpr (sm90::kIsHalf<T>) {
            const float2 r2 = sm90::unpack2<T>(d2);  // the rounded ds
            db[h] += r2.x + r2.y;
          } else {
            db[h] += ds0 + ds1;
          }
        }
        dsa[i / 8][(i % 8) / 2] = d2;
        if constexpr (WithDq) {
          *reinterpret_cast<uint16_t*>(ds_at[h][0] + dsb + 1024 * (i / 4)) =
              static_cast<uint16_t>(d2 & 0xffffu);
          *reinterpret_cast<uint16_t*>(ds_at[h][1] + dsb + 1024 * (i / 4)) =
              static_cast<uint16_t>(d2 >> 16);
        }
      }

      // dK += dS^T.Q
      sm90::wgmma_fence();
      issue_acc<T, D>(dk_acc, dsa, q_st(s));
      sm90::wgmma_commit();
      if constexpr (!WithDq) {
        sm90::wgmma_wait<0>();  // dV and dK are in
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
        sm90::fence_regs(pa);  // the fragments stay live until their
        sm90::fence_regs(dsa); // products are done
        sm90::mbar_arrive(empty(s));  // Q, dO and the rows are read
      } else {
        // then this consumer's half of dQ = dS.K once both consumers' dS
        // is in shared memory and this half's last dQ tile has been read
        // out of shared memory. The other consumer may still be reading
        // the last tile's dS in its dQ product, hence two buffers; tile
        // n - 2's products, the last readers of this one, were done in
        // both before the last tile's barrier.
        sm90::fence_proxy_async();
        if (issuer) sm90::bulk_wait_read();
        sm90::named_sync(1, kBwdConsumers);
        float dq_acc[D / 4];
        sm90::wgmma_fence();
        issue_dq<T, D>(dq_acc, base + G::kDS + dsb, k_s, wg);
        sm90::wgmma_wait<1>();  // dV and dK are in
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
        sm90::fence_regs(pa);
        sm90::fence_regs(dsa);
        sm90::mbar_arrive(empty(s));
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq_acc);

        // this half of the float32 dQ tile to shared memory in the dq
        // map's swizzled boxes, then one tensor reduction per box adds it
        // into the workspace (rows past Sq are not written)
#pragma unroll
        for (int i = 0; i < D / 4; i += 2) {
          const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
          const int col = 8 * (i / 4) + cq;  // within this half
          *reinterpret_cast<float2*>(dq_g + (col / kDqBox) * kBwdBQ * kDqRow +
                                     swizzled_f32<kDqRow>(row,
                                                          col % kDqBox)) =
              make_float2(dq_acc[i], dq_acc[i + 1]);
        }
        sm90::fence_proxy_async();
        sm90::named_sync(2 + wg, 128);
        if (issuer) {
#pragma unroll
          for (int b = 0; b < D / 2 / kDqBox; ++b)
            sm90::tma_reduce_add_3d(dqmap, dq_s + b * kBwdBQ * kDqRow,
                                    wg * (D / 2) + b * kDqBox, q0, bh);
          sm90::bulk_commit();
        }
      }
    }
    // the last reduction reads shared memory: keep the block until it is
    // done
    if (WithDq && issuer) sm90::bulk_wait();

    // epilogue: dk * scale and dv in T, dbias (the quad's row sums);
    // keys past Sk are never written
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float b = db[h];
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      const int j = kc0 + rl + 8 * h;
      if (j >= sh.Sk) continue;
      const int64_t o = (static_cast<int64_t>(bh) * sh.Sk + j) * D + cq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        sm90::store2(dk + o + 8 * jj, dk_acc[4 * jj + 2 * h] * sh.scale,
                     dk_acc[4 * jj + 2 * h + 1] * sh.scale);
        sm90::store2(dv + o + 8 * jj, dv_acc[4 * jj + 2 * h],
                     dv_acc[4 * jj + 2 * h + 1]);
      }
      if (HasBias && lane % 4 == 0)
        dbias[static_cast<int64_t>(bh) * sh.Sk + j] = b;
    }
  }
}

// K9: dk, dv, dbias and dq (into dq_ws through dqmap).
template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap dqmap,
                      T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dbias,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias, Shape sh) {
  bwd_sm90_block<T, D, HasBias, true>(qmap, kmap, vmap, domap, &dqmap, dk,
                                      dv, dbias, lse, delta, bias, sh);
}

// K8: dk, dv and dbias.
template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ dbias,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias, Shape sh) {
  bwd_sm90_block<T, D, HasBias, false>(qmap, kmap, vmap, domap, nullptr,
                                       dk, dv, dbias, lse, delta, bias, sh);
}

// Launches K9 (dq_ws given) or K8 (dq_ws null) with a per-key bias when
// bias is not null.
template <typename T, int D, bool HasBias>
cudaError_t launch_bwd_sm90(void* dk, void* dv, float* dq_ws, float* dbias,
                            const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* bias, int BH,
                            Shape sh, cudaStream_t st) {
  using G = BwdTiles<D, true>;
  CUtensorMap qm, km, vm, dom, dqm;
  if (!sm90::make_map_3d<T>(&qm, q, BH, sh.Sq, D, kBwdBQ, G::kBox) ||
      !sm90::make_map_3d<T>(&dom, dout, BH, sh.Sq, D, kBwdBQ, G::kBox) ||
      !sm90::make_map_3d<T>(&km, k, BH, sh.Sk, D, kBwdBK, G::kBox) ||
      !sm90::make_map_3d<T>(&vm, v, BH, sh.Sk, D, kBwdBK, G::kBox) ||
      (dq_ws && !sm90::make_map_3d_f32(&dqm, dq_ws, BH, sh.Sq, D, kBwdBQ,
                                       D / 2 < 32 ? D / 2 : 32)))
    return cudaErrorInvalidValue;
  const int64_t blocks =
      static_cast<int64_t>(BH) * ((sh.Sk + kBwdBK - 1) / kBwdBK);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  auto* dk_ = static_cast<T*>(dk);
  auto* dv_ = static_cast<T*>(dv);
  cudaError_t e;
  if (dq_ws) {
    auto kern = flash_bwd_sm90_kernel<T, D, HasBias>;
    constexpr int smem = BwdTiles<D, true>::kSmem;
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kBwdThreads, smem, st>>>(qm, km, vm, dom, dqm, dk_, dv_,
                                          dbias, lse, delta, bias, sh);
  } else {
    auto kern = flash_bwd_dkv_sm90_kernel<T, D, HasBias>;
    constexpr int smem = BwdTiles<D, false>::kSmem;
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kBwdThreads, smem, st>>>(qm, km, vm, dom, dk_, dv_, dbias,
                                          lse, delta, bias, sh);
  }
  return cudaGetLastError();
}

template <typename T, int D>
int bwd_sm90_as(void* dk, void* dv, float* dq_ws, float* dbias,
                const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const float* bias, int BH, Shape sh, cudaStream_t st) {
  return static_cast<int>(
      bias ? launch_bwd_sm90<T, D, true>(dk, dv, dq_ws, dbias, q, k, v, dout,
                                         lse, delta, bias, BH, sh, st)
           : launch_bwd_sm90<T, D, false>(dk, dv, dq_ws, dbias, q, k, v,
                                          dout, lse, delta, bias, BH, sh,
                                          st));
}

template <typename T>
int bwd_sm90_t(void* dk, void* dv, float* dq_ws, float* dbias,
               const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* bias,
               int BH, int D, Shape sh, cudaStream_t st) {
  switch (D) {
    case 32:
      return bwd_sm90_as<T, 32>(dk, dv, dq_ws, dbias, q, k, v, dout, lse,
                                delta, bias, BH, sh, st);
    case 64:
      return bwd_sm90_as<T, 64>(dk, dv, dq_ws, dbias, q, k, v, dout, lse,
                                delta, bias, BH, sh, st);
    case 128:
      return bwd_sm90_as<T, 128>(dk, dv, dq_ws, dbias, q, k, v, dout, lse,
                                 delta, bias, BH, sh, st);
    default: return -1;
  }
}

}  // namespace

int bwd_sm90(void* dk, void* dv, float* dq_ws, float* dbias, const void* q,
             const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const float* bias,
             int BH, int D, int dtype, Shape sh, cudaStream_t st) {
  if (dtype == kDtypeHalf)
    return bwd_sm90_t<__half>(dk, dv, dq_ws, dbias, q, k, v, dout, lse,
                              delta, bias, BH, D, sh, st);
  return bwd_sm90_t<__nv_bfloat16>(dk, dv, dq_ws, dbias, q, k, v, dout, lse,
                                   delta, bias, BH, D, sh, st);
}

int bwd_dkv_sm90(void* dk, void* dv, float* dbias, const void* q,
                 const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const float* bias,
                 int BH, int D, int dtype, Shape sh, cudaStream_t st) {
  return bwd_sm90(dk, dv, nullptr, dbias, q, k, v, dout, lse, delta, bias,
                  BH, D, dtype, sh, st);
}

}  // namespace flash
}  // namespace pt
