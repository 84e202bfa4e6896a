// K4 and K4 bias in bfloat16 and float16 on Hopper's tensor cores
// (sm_90a; the element type T a template parameter): the forward with LSE
// of paddle_tpu/ops/pallas/flash_attention.py `_flash_fwd_lse` (body
// `_fwd_kernel`, and its `has_bias` variant), with the contract of
// flash_attention.cu's K4 — out [BH, Sq, D] in T, lse
// [BH, Sq] float32 in natural-log units, bottom-right causal alignment,
// the bias row (bh / H) * bias_bstride read in place, dead rows averaging
// every value, fully masked rows uniform with an LSE of -1e30, any Sq,
// Sk >= 1, D in {32, 64, 128}. The float32 K4 stays the SIMT kernel of
// flash_attention.cu: TF32 products would not hold float32 parity.
//
// What bounds it on an H100: 4 * BH * D * (visible pairs) FLOPs at
// 989 TFLOP/s against q, k, v, out and lse at 3.35 TB/s; at GPT-2-small
// training shapes (BH 192, S 1024, D 64, causal) both are ~0.03 ms, and
// each (q tile, key tile) pair is two tensor-core products and one
// exponential per score. The SIMT kernel it replaces ran both products as
// float32 FMAs (~24 TFLOP/s) and loaded every tile synchronously.
//
// The design:
//   * One block per (128-row q tile, bh), 384 threads. Warpgroup 0 is the
//     producer: one thread issues the TMA loads (Q once; K and V tiles of
//     128 keys into a 3-stage ring with a full and an empty mbarrier per
//     stage), and the warpgroup hands its registers to warpgroups 1 and 2,
//     the consumers, which own 64 q rows each.
//   * S = Q.K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory; O += P.V is wgmma m64nDk16 with P (in T, as the reference's
//     `p.astype(v.dtype)`) in registers and V MN-major through the
//     transpose-B flag (`issue_s`, `issue_pv` of flash_sm90.cuh, which K7
//     shares). A consumer issues S of tile t together with P.V of
//     tile t - 1 and runs the online softmax of tile t (on the S
//     accumulator, in log2 units: scale * log2 e folded in, exp2f) while
//     the latter is on the tensor cores.
//   * The key loop stops at the causal horizon of the tile's last row (a
//     tile holding a dead row scores every key); a consumer whose rows
//     are all past a key tile's horizon skips it. The position mask runs
//     only on tiles that straddle the diagonal or pass Sk.
//   * Blocks walk the q tiles heaviest first across every bh (grid y
//     reversed, bh in x), so the long causal key loops start first and
//     the short ones fill the tail. (Putting one bh's q tiles next to
//     each other, for L2 reuse of its K and V, was slower on an H100,
//     most at long causal lengths: the last bh's heavy tiles start late.)
//   * The bias is staged per key tile by the producer's second warp with
//     ordinary loads (a row starts at (bh / H) * Sk floats, not 16-byte
//     aligned in general, so no bulk copy), in log2 units, beside the
//     tile in the ring.
//   * Branches around wgmma are warp-uniform (the role comes from a
//     shuffle): under a branch the compiler cannot prove uniform, it
//     serialises the wgmma instructions.
//   * m starts at -inf with the rescale guarded (no -inf - -inf); hidden
//     keys weigh nothing, a dead row's keys take the -1e30 fill (uniform),
//     and a fully masked row's scores all round to its -1e30 bias (p = 1
//     each: uniform), as in the plain version.

#include "flash_sm90.cuh"

namespace pt {
namespace flash {
namespace {

constexpr int kFwdStages = 3;     // K/V (and bias) tiles in flight
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdTiles : Boxes<D> {
  static constexpr int kQBytes = kTileQ * D * 2;
  static constexpr int kKVBytes = kTileK * D * 2;  // one K (or V) tile
  // Q, the K tiles, the V tiles, the bias tiles (float32, log2 units),
  // then the barriers: q, full[], empty[]
  static constexpr int kBiasOffset = kQBytes + 2 * kFwdStages * kKVBytes;
  static constexpr int kBarOffset = kBiasOffset + kFwdStages * kTileK * 4;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kFwdStages) +
                               1024;  // slack to align the base to 1024
};

// The online softmax of one key tile, on the S accumulator: the scores in
// log2 units (scale * log2 e, the bias b_s of the tile's keys, and the
// position mask where `masked`), the running row max m, the rescale alpha
// of the old sums, p = exp2(x - m) left in sc, and its row sums added to
// this thread's partial l. Row r of the thread is r0 + 8r; its columns in
// each 8-column chunk are cq, cq + 1.
template <bool HasBias>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2],
                                             const float* b_s, int k0,
                                             int r0, int cq, bool masked,
                                             float scale2, const Shape& sh) {
  const float fill = kNegInf * kLog2e;  // a dead row's score
  // without a bias or a mask the scores stay raw (scale2 > 0 keeps the
  // max) and the scale folds into the exponent's FMA
  const bool raw = !HasBias && !masked && scale2 > 0.f;
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    float2 b = make_float2(0.f, 0.f);
    if constexpr (HasBias)
      b = *reinterpret_cast<const float2*>(b_s + 8 * (i / 4) + cq);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = sc[i + e];
      if (!raw) {
        x = fmaf(x, scale2, e ? b.y : b.x);
        if (masked) {
          const int j = k0 + 8 * (i / 4) + cq + e;
          const int row = r0 + 8 * ((i / 2) % 2);
          if (j >= sh.Sk)
            x = -INFINITY;  // past the end: no weight
          else if (sh.causal && j > row + sh.off)
            // a dead row averages every key (the reference's -1e30
            // fill); a hidden key of any other row has no weight
            x = row + sh.off < 0 ? fill : -INFINITY;
        }
        sc[i + e] = x;
      }
      tmax[(i / 2) % 2] = fmaxf(tmax[(i / 2) % 2], x);
    }
  }
  const float mul = raw ? scale2 : 1.f;
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = tmax[r];
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[r], v * mul);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
    alpha[r] = exp2f(m[r] - m_use[r]);            // 0 while m was -inf
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = exp2f(fmaf(sc[i], mul, -m_use[r]));
    l[r] += sc[i];
  }
}

// Whether key tile k0 needs the position mask for a consumer whose rows
// start at qw0: it passes Sk or straddles the causal diagonal.
__device__ __forceinline__ bool masked_tile(const Shape& sh, int k0,
                                            int qw0) {
  return k0 + kTileK > sh.Sk ||
         (sh.causal && k0 + kTileK - 1 > qw0 + sh.off);
}

template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kTileThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      T* __restrict__ out,
                      float* __restrict__ lse,
                      const float* __restrict__ bias, Shape sh) {
  using G = FwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + G::kQBytes;  // stage s at + s * kKVBytes
  const uint32_t v_s = k_s + kFwdStages * G::kKVBytes;
  float* bias_s = reinterpret_cast<float*>(
      smem_raw + (base - sm90::smem_u32(smem_raw)) + G::kBiasOffset);
  const uint32_t q_bar = base + G::kBarOffset;
  auto full = [&](int s) { return q_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return q_bar + 8 * (1 + kFwdStages + s); };

  // launch order walks the q tiles heaviest first across every bh, so
  // the long causal key loops start first and the short ones fill the tail
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;
  // keys up to the causal horizon of the tile's last row; a tile that
  // holds a dead row scores every key (its rows average all of them)
  int kend = sh.Sk;
  if (sh.causal && q0 + sh.off >= 0)
    kend = min(sh.Sk, min(q0 + kTileQ, sh.Sq) + sh.off);
  const int ntiles = (kend + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < kFwdStages; ++s) {
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
      sm90::mbar_expect_tx(q_bar, G::kQBytes);
      for (int b = 0; b < G::kBoxes; ++b)
        sm90::tma_load_3d(q_s + b * kTileQ * G::kSwizzle, &qmap, q_bar,
                          b * G::kBox, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kFwdStages;
        // wait for the consumers to release the stage's previous tile
        if (t >= kFwdStages)
          sm90::mbar_wait(empty(s), (t / kFwdStages + 1) & 1);
        sm90::mbar_expect_tx(full(s), 2 * G::kKVBytes);
        for (int b = 0; b < G::kBoxes; ++b) {
          const uint32_t off = s * G::kKVBytes + b * kTileK * G::kSwizzle;
          sm90::tma_load_3d(k_s + off, &kmap, full(s), b * G::kBox,
                            t * kTileK, bh);
          sm90::tma_load_3d(v_s + off, &vmap, full(s), b * G::kBox,
                            t * kTileK, bh);
        }
      }
    } else if (HasBias && threadIdx.x / 32 == 1) {
      const float* brow = bias_row(bias, sh, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kFwdStages;
        if (t >= kFwdStages)
          sm90::mbar_wait(empty(s), (t / kFwdStages + 1) & 1);
        for (int c = threadIdx.x % 32; c < kTileK; c += 32) {
          const int j = t * kTileK + c;
          bias_s[s * kTileK + c] = j < sh.Sk ? brow[j] * kLog2e : 0.f;
        }
        sm90::mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    sm90::regs_alloc<240>();
    const int wg = role - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int qw0 = q0 + 64 * wg;                // this warpgroup's rows
    const int r0 = qw0 + 16 * warp + lane / 4;   // this thread's: r0, r0+8
    const int cq = 2 * (lane % 4);  // its columns in each 8-column chunk
    const float scale2 = sh.scale * kLog2e;

    // the key tiles this warpgroup computes: none past the horizon of its
    // last row (all of them if it holds a dead row), none if all its rows
    // are past Sq; it still releases every stage
    int wend = ntiles;
    if (qw0 >= sh.Sq)
      wend = 0;
    else if (sh.causal && qw0 + sh.off >= 0)
      wend = min(ntiles, (min(qw0 + 63, sh.Sq - 1) + sh.off) / kTileK + 1);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[64];
    uint32_t pa[8][4];  // P of the previous tile: A fragments in T
    const uint32_t qw_s = q_s + 64 * wg * G::kSwizzle;
    sm90::mbar_wait(q_bar, 0);

    // S of tile t is issued together with O += P.V of tile t - 1, and the
    // softmax of tile t runs while the latter is on the tensor cores
    if (wend > 0) {  // tile 0: S alone
      sm90::mbar_wait(full(0), 0);
      sm90::wgmma_fence();
      issue_s<T, D>(sc, qw_s, k_s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax_tile<HasBias>(sc, m, l, alpha, bias_s, 0, r0, cq,
                            masked_tile(sh, 0, qw0), scale2, sh);
      pack_p<T>(pa, sc);
    }
    for (int t = 1; t < wend; ++t) {
      const int s = t % kFwdStages, sp = (t - 1) % kFwdStages;
      const int k0 = t * kTileK;
      sm90::mbar_wait(full(s), (t / kFwdStages) & 1);
      sm90::wgmma_fence();
      issue_s<T, D>(sc, qw_s, k_s + s * G::kKVBytes);
      issue_pv<T, D>(o, pa, v_s + sp * G::kKVBytes);
      sm90::wgmma_wait<1>();  // S of tile t is in
      sm90::fence_regs(sc);
      softmax_tile<HasBias>(sc, m, l, alpha, bias_s + s * kTileK, k0, r0,
                            cq, masked_tile(sh, k0, qw0), scale2, sh);
      sm90::wgmma_wait<0>();  // P.V of tile t - 1 is in
      sm90::fence_regs(o);
      sm90::fence_regs(pa);  // pa stays live until its product is done
      sm90::mbar_arrive(empty(sp));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      pack_p<T>(pa, sc);
    }
    if (wend > 0) {  // the last tile's P.V
      const int sp = (wend - 1) % kFwdStages;
      sm90::wgmma_fence();
      issue_pv<T, D>(o, pa, v_s + sp * G::kKVBytes);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::mbar_arrive(empty(sp));
    }
    for (int t = wend; t < ntiles; ++t) {  // past this warpgroup's rows
      const int s = t % kFwdStages;
      sm90::mbar_wait(full(s), (t / kFwdStages) & 1);
      sm90::mbar_arrive(empty(s));
    }

    // epilogue: O = acc / l in T and lse = (m + log2 l) ln 2; rows past
    // Sq are never written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = r0 + 8 * r;
      if (wend == 0 || row >= sh.Sq) continue;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      T* orow = out + (static_cast<int64_t>(bh) * sh.Sq + row) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        sm90::store2(orow + 8 * j, o[4 * j + 2 * r] * inv,
                     o[4 * j + 2 * r + 1] * inv);
      if (lane % 4 == 0)
        lse[static_cast<int64_t>(bh) * sh.Sq + row] =
            (m[r] + log2f(lt)) * kLn2;
    }
  }
}

template <typename T, int D, bool HasBias>
cudaError_t launch_fwd_sm90(void* out, float* lse, const void* q,
                            const void* k, const void* v, const float* bias,
                            int BH, Shape sh, cudaStream_t st) {
  using G = FwdTiles<D>;
  CUtensorMap qm, km, vm;
  if (!sm90::make_map_3d<T>(&qm, q, BH, sh.Sq, D, kTileQ, G::kBox) ||
      !sm90::make_map_3d<T>(&km, k, BH, sh.Sk, D, kTileK, G::kBox) ||
      !sm90::make_map_3d<T>(&vm, v, BH, sh.Sk, D, kTileK, G::kBox))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_sm90_kernel<T, D, HasBias>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (sh.Sq + kTileQ - 1) / kTileQ);
  kern<<<grid, kTileThreads, G::kSmem, st>>>(
      qm, km, vm, static_cast<T*>(out), lse, bias, sh);
  return cudaGetLastError();
}

template <typename T, int D>
int fwd_sm90_as(void* out, float* lse, const void* q, const void* k,
                const void* v, const float* bias, int BH, Shape sh,
                cudaStream_t st) {
  return static_cast<int>(
      bias ? launch_fwd_sm90<T, D, true>(out, lse, q, k, v, bias, BH, sh, st)
           : launch_fwd_sm90<T, D, false>(out, lse, q, k, v, bias, BH, sh,
                                          st));
}

template <typename T>
int fwd_sm90_t(void* out, float* lse, const void* q, const void* k,
               const void* v, const float* bias, int BH, int D, Shape sh,
               cudaStream_t st) {
  switch (D) {
    case 32: return fwd_sm90_as<T, 32>(out, lse, q, k, v, bias, BH, sh, st);
    case 64: return fwd_sm90_as<T, 64>(out, lse, q, k, v, bias, BH, sh, st);
    case 128:
      return fwd_sm90_as<T, 128>(out, lse, q, k, v, bias, BH, sh, st);
    default: return -1;
  }
}

}  // namespace

int fwd_sm90(void* out, float* lse, const void* q, const void* k,
             const void* v, const float* bias, int BH, int D, int dtype,
             Shape sh, cudaStream_t st) {
  if (dtype == kDtypeHalf)
    return fwd_sm90_t<__half>(out, lse, q, k, v, bias, BH, D, sh, st);
  return fwd_sm90_t<__nv_bfloat16>(out, lse, q, k, v, bias, BH, D, sh, st);
}

}  // namespace flash
}  // namespace pt
