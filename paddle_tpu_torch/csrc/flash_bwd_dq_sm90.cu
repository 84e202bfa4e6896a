// K7 and K7 bias in bfloat16 on Hopper's tensor cores (sm_90a): the dq
// pass of the two-pass flash backward of
// paddle_tpu/ops/pallas/flash_attention.py `_flash_bwd` (pallas_call at
// :580, body `_bwd_dq_kernel` with `_tile_p_ds`, and its `has_bias`
// variant), reached from flash_bwd_two_pass.cu's `bwd_dq` for bf16
// tensors. The contract is `tile_p_ds`'s (flash_common.cuh) and the SIMT
// K7's: dq = scale * sum_j ds_ij k_j, [BH, Sq, D] bf16, with p = exp(s *
// scale + bias - lse) from the LSE it is given (never renormalised: ring
// attention passes a global LSE), bottom-right causal alignment, dq = 0
// for a dead row (causal, Sq > Sk), p = 1 / (keys it sees) for a fully
// masked row (lse <= -1e29), the bias row (bh / H) * bias_bstride read in
// place (0: one row broadcast over the batch), any Sq, Sk >= 1, D in {32,
// 64, 128}. As the reference's `ds.astype(k.dtype)`, ds is rounded to
// bf16 before it enters dS.K; p and ds are formed as the bf16 K9 forms
// them (flash_bwd_sm90.cu: the same `fast_exp2`, `masked_p` and order of
// operations), so the two hold the same bf16 dS up to the rounding of
// their S products. The float32 K7 stays the SIMT `flash_bwd_dq_kernel`
// of flash_bwd_two_pass.cu: TF32 products would not hold float32 parity.
//
// What bounds it on an H100: 6 * BH * D * (visible pairs) FLOPs (the S,
// dP and dQ products) at 989 TFLOP/s against q, k, v, dO, lse and delta
// read and dq written at 3.35 TB/s; at GPT-2-small training shapes (BH
// 192, S 1024, D 64, causal) operations, ~0.039 ms. Per (q tile, key
// tile) pair it runs three tensor-core products and one exponential per
// score. The SIMT kernel it replaces ran the products as float32 FMAs from
// synchronously loaded float32 tiles.
//
// The design is K4's loop (flash_fwd_sm90.cu) with another tile body:
//   * One block per (128-row q tile, bh), 384 threads, on a grid (BH, q
//     tiles) walked heaviest first (y reversed), which takes any B * H.
//     Warpgroup 0 is the producer: one thread loads Q and dO once by TMA
//     and streams K and V tiles through a ring of 4 stages (a full and an
//     empty mbarrier each): 128 keys a tile, or 64 at D 128, where S, dP
//     and dQ of 128 keys spilled ~790 bytes a thread. With Q and dO the
//     ring takes 160 of the 227 KB at D 64, 192 at D 128. With a bias its
//     warp 1 stages each tile's bias in log2 units (-inf past Sk) beside
//     them. Warpgroups 1 and 2, the consumers, own 64 q rows each and
//     take the producer's registers (setmaxnreg).
//   * Per key tile a consumer issues S = Q.K^T and dP = dO.V^T as two
//     wgmma groups (both operands K-major in shared memory), forms p from
//     S while dP is in flight, then ds = p * (dp - delta) in float32,
//     packed to bf16 A fragments, and dQ += dS.K as a wgmma with dS in
//     registers and K MN-major through the transpose-B flag: K4's
//     `issue_s` and `issue_pv` (flash_sm90.cuh) with dO, V and K in place
//     of Q, K and V. Issuing tile t's S and dP beside tile t - 1's dQ
//     product, as K4 issues S beside P.V, was no faster on an H100 at the
//     shapes tried (faster at S 16384, slower with a bias and at D 128),
//     so each tile's three products run in turn; the two consumers
//     interleave.
//   * Each thread reads its two rows' LSE (as -LSE * log2 e; -inf, hence
//     p = 0, past Sq) and delta once. A warp whose 16 rows hold a dead or
//     a fully masked row takes `masked_p`'s rules on every tile; every
//     other warp the fast path (one FMA, one add and one ex2 for p; a
//     subtract and a multiply for ds), with the position mask only on
//     tiles across the causal diagonal or past Sk.
//   * The key loop ends at the causal horizon of the tile's last row; a
//     consumer whose rows all lie before a key tile skips its products (a
//     dead row takes no gradient, so it needs no key). A block or a
//     consumer with no key tile still writes its zeros.
//   * dq stays in float32 registers and is written once, scaled and cast
//     to bf16, without atomics: each block owns its dq rows and sums the
//     key tiles in one order, so dq is bitwise reproducible.
//   * Branches around wgmma are warp-uniform (the role comes from a
//     shuffle): under a branch the compiler cannot prove uniform, it
//     serialises the wgmma instructions.

#include "flash_sm90.cuh"

namespace pt {
namespace flash {
namespace {

template <int D>
struct DqTiles : Boxes<D> {
  // keys per tile: 64 at D 128, where S, dP and dQ of 128 keys pass the
  // 240 registers a consumer thread has
  static constexpr int kKeys = D == 128 ? 64 : kTileK;
  static constexpr int kStages = 4;                  // K/V tiles in flight
  static constexpr int kQBytes = kTileQ * D * 2;     // Q (or dO)
  static constexpr int kKVBytes = kKeys * D * 2;     // one K (or V) tile
  // Q, dO, the K tiles, the V tiles, the bias tiles (float32, log2
  // units), then the barriers: q, full[], empty[]
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBias = kV + kStages * kKVBytes;
  static constexpr int kBar = kBias + kStages * kKeys * 4;
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) +
                               1024;  // slack to align the base to 1024
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

template <int D, bool HasBias>
__global__ void __launch_bounds__(kTileThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         __nv_bfloat16* __restrict__ dq,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias, Shape sh) {
  using G = DqTiles<D>;
  constexpr int BK = G::kKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + G::kQBytes;
  const uint32_t k_s = base + G::kK;  // stage s at + s * kKVBytes
  const uint32_t v_s = base + G::kV;
  float* bias_s = reinterpret_cast<float*>(
      smem_raw + (base - sm90::smem_u32(smem_raw)) + G::kBias);
  const uint32_t q_bar = base + G::kBar;
  auto full = [&](int s) { return q_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return q_bar + 8 * (1 + G::kStages + s); };

  // launch order walks the q tiles heaviest first across every bh
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;
  // keys up to the causal horizon of the tile's last row (none when every
  // row of the tile is dead)
  int kend = sh.Sk;
  if (sh.causal) kend = max(0, min(sh.Sk, min(q0 + kTileQ, sh.Sq) + sh.off));
  const int ntiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < G::kStages; ++s) {
      sm90::mbar_init(full(s), HasBias ? 1 + kBiasLoaders : 1);
      sm90::mbar_init(empty(s), kTileConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, made warp-uniform (a shuffle) so that the
  // compiler sees no divergence around the wgmma instructions
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread keeps the ring full of TMA loads; with a
    // bias, warp 1 stages each tile's bias beside them ----
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch(&kmap);
      sm90::tma_prefetch(&vmap);
      sm90::mbar_expect_tx(q_bar, 2 * G::kQBytes);
      for (int b = 0; b < G::kBoxes; ++b) {
        const uint32_t off = b * kTileQ * G::kSwizzle;
        sm90::tma_load_3d(q_s + off, &qmap, q_bar, b * G::kBox, q0, bh);
        sm90::tma_load_3d(do_s + off, &domap, q_bar, b * G::kBox, q0, bh);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % G::kStages;
        // wait for the consumers to release the stage's previous tile
        if (t >= G::kStages)
          sm90::mbar_wait(empty(s), (t / G::kStages + 1) & 1);
        sm90::mbar_expect_tx(full(s), 2 * G::kKVBytes);
        for (int b = 0; b < G::kBoxes; ++b) {
          const uint32_t off = s * G::kKVBytes + b * BK * G::kSwizzle;
          sm90::tma_load_3d(k_s + off, &kmap, full(s), b * G::kBox, t * BK,
                            bh);
          sm90::tma_load_3d(v_s + off, &vmap, full(s), b * G::kBox, t * BK,
                            bh);
        }
      }
    } else if (HasBias && threadIdx.x / 32 == 1) {
      const float* brow = bias_row(bias, sh, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % G::kStages;
        if (t >= G::kStages)
          sm90::mbar_wait(empty(s), (t / G::kStages + 1) & 1);
        for (int c = threadIdx.x % 32; c < BK; c += 32) {
          const int j = t * BK + c;
          bias_s[s * BK + c] = j < sh.Sk ? brow[j] * kLog2e : -INFINITY;
        }
        sm90::mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    sm90::regs_alloc<240>();
    const int wg = role - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int qw0 = q0 + 64 * wg;               // this warpgroup's rows
    const int r0 = qw0 + 16 * warp + lane / 4;  // this thread's: r0, r0+8
    const int cq = 2 * (lane % 4);  // its columns in each 8-column chunk
    const float scale2 = sh.scale * kLog2e;

    // the key tiles this warpgroup computes: none past the horizon of its
    // last row, none if all its rows are dead or past Sq; it still
    // releases every stage
    int wend = ntiles;
    if (qw0 >= sh.Sq) {
      wend = 0;
    } else if (sh.causal) {
      const int horizon = min(qw0 + 63, sh.Sq - 1) + sh.off;
      wend = horizon < 0 ? 0 : min(ntiles, horizon / BK + 1);
    }

    // the thread's two rows: -LSE in log2 units, delta and the row code;
    // a warp that holds a dead or fully masked row takes the mask rules
    float nl[2], dl[2], code[2];
    bool special = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + 8 * r;
      nl[r] = -INFINITY;  // past Sq: p = 0
      dl[r] = code[r] = 0.f;
      if (i < sh.Sq) {
        const int64_t at = static_cast<int64_t>(bh) * sh.Sq + i;
        const float l = lse[at];
        nl[r] = -l * kLog2e;
        dl[r] = delta[at];
        code[r] = row_code(sh, i, l);
      }
      special |= code[r] != 0.f;
    }
    special = __any_sync(0xffffffffu, special);

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    const uint32_t qw_s = q_s + 64 * wg * G::kSwizzle;   // its Q rows
    const uint32_t dow_s = do_s + 64 * wg * G::kSwizzle; // its dO rows
    sm90::mbar_wait(q_bar, 0);

    for (int t = 0; t < wend; ++t) {
      const int s = t % G::kStages;
      const int k0 = t * BK;
      const uint32_t ks = k_s + s * G::kKVBytes;
      sm90::mbar_wait(full(s), (t / G::kStages) & 1);
      float sc[BK / 2], dp[BK / 2];
      sm90::wgmma_fence();
      issue_s<D, BK>(sc, qw_s, ks);
      issue_s<D, BK>(dp, dow_s, v_s + s * G::kKVBytes);
      sm90::wgmma_wait<1>();  // S is in; dP runs on
      sm90::fence_regs(sc);

      // P, in sc: the tile passes Sk or crosses the causal diagonal
      const bool masked =
          k0 + BK > sh.Sk || (sh.causal && k0 + BK - 1 > qw0 + sh.off);
      const float* b_s = bias_s + s * BK;
      if (!special) {
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const int r = (i / 2) % 2, c = 8 * (i / 4) + cq;
          float2 b = make_float2(0.f, 0.f);
          if constexpr (HasBias)
            b = *reinterpret_cast<const float2*>(b_s + c);
          sc[i] = fast_exp2(fmaf(sc[i], scale2, nl[r]) + b.x);
          sc[i + 1] = fast_exp2(fmaf(sc[i + 1], scale2, nl[r]) + b.y);
          if (masked) {  // does row r0 + 8r see key k0 + c (+ 1)?
            const int j = k0 + c, row = r0 + 8 * r;
            if (j >= sh.Sk || (sh.causal && j > row + sh.off)) sc[i] = 0.f;
            if (j + 1 >= sh.Sk || (sh.causal && j + 1 > row + sh.off))
              sc[i + 1] = 0.f;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const int r = (i / 2) % 2, c = 8 * (i / 4) + cq;
          float2 b = make_float2(0.f, 0.f);
          if constexpr (HasBias)
            b = *reinterpret_cast<const float2*>(b_s + c);
          sc[i] = masked_p(sh, r0 + 8 * r, k0 + c,
                           fmaf(sc[i], scale2, nl[r]) + b.x, code[r]);
          sc[i + 1] = masked_p(sh, r0 + 8 * r, k0 + c + 1,
                               fmaf(sc[i + 1], scale2, nl[r]) + b.y,
                               code[r]);
        }
      }

      // dS = P * (dP - delta), in sc, as bf16 A fragments (a dead row
      // takes none)
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = special && code[r] < 0.f ? 0.f : sc[i] * (dp[i] - dl[r]);
      }
      uint32_t dsa[BK / 16][4];
      pack_p(dsa, sc);

      // dQ += dS.K
      sm90::wgmma_fence();
      issue_pv<D, BK>(dqa, dsa, ks);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dqa);
      sm90::fence_regs(dsa);  // the fragments stay live until it is done
      sm90::mbar_arrive(empty(s));
    }
    for (int t = wend; t < ntiles; ++t) {  // past this warpgroup's rows
      const int s = t % G::kStages;
      sm90::mbar_wait(full(s), (t / G::kStages) & 1);
      sm90::mbar_arrive(empty(s));
    }

    // epilogue: dq * scale in bf16; rows past Sq are never written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sh.Sq) continue;
      __nv_bfloat16* orow =
          dq + (static_cast<int64_t>(bh) * sh.Sq + row) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * r] * sh.scale,
                                  dqa[4 * j + 2 * r + 1] * sh.scale);
    }
  }
}

template <int D, bool HasBias>
cudaError_t launch_dq_sm90(void* dq, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* delta, const float* bias, int BH,
                           Shape sh, cudaStream_t st) {
  using G = DqTiles<D>;
  CUtensorMap qm, dom, km, vm;
  if (!sm90::make_map_3d(&qm, q, BH, sh.Sq, D, kTileQ, G::kBox) ||
      !sm90::make_map_3d(&dom, dout, BH, sh.Sq, D, kTileQ, G::kBox) ||
      !sm90::make_map_3d(&km, k, BH, sh.Sk, D, G::kKeys, G::kBox) ||
      !sm90::make_map_3d(&vm, v, BH, sh.Sk, D, G::kKeys, G::kBox))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_sm90_kernel<D, HasBias>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (sh.Sq + kTileQ - 1) / kTileQ);
  kern<<<grid, kTileThreads, G::kSmem, st>>>(
      qm, dom, km, vm, static_cast<__nv_bfloat16*>(dq), lse, delta, bias,
      sh);
  return cudaGetLastError();
}

template <int D>
int bwd_dq_sm90_as(void* dq, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* bias, int BH, Shape sh, cudaStream_t st) {
  return static_cast<int>(
      bias ? launch_dq_sm90<D, true>(dq, q, k, v, dout, lse, delta, bias, BH,
                                     sh, st)
           : launch_dq_sm90<D, false>(dq, q, k, v, dout, lse, delta, bias,
                                      BH, sh, st));
}

}  // namespace

int bwd_dq_sm90(void* dq, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const float* bias, int BH, int D, Shape sh, cudaStream_t st) {
  switch (D) {
    case 32:
      return bwd_dq_sm90_as<32>(dq, q, k, v, dout, lse, delta, bias, BH, sh,
                                st);
    case 64:
      return bwd_dq_sm90_as<64>(dq, q, k, v, dout, lse, delta, bias, BH, sh,
                                st);
    case 128:
      return bwd_dq_sm90_as<128>(dq, q, k, v, dout, lse, delta, bias, BH, sh,
                                 st);
    default: return -1;
  }
}

}  // namespace flash
}  // namespace pt
