// K2, the paged decode attention of the serving path, on Hopper (sm_90a):
// split-KV over the block table, with TMA loads of the pool into an
// mbarrier ring. Dense (float32 or bf16) and int8 pools (codes plus one
// scale per stored vector), head_dim 32, 64 or 128.
//
// Replaces paddle_tpu/ops/pallas/unified_attention.py
// `paged_decode_attention_kernel` (327), body `_decode_kernel` (276): one
// query per sequence, q [B, H, Dh], over one layer's pool [N, BS, H, Dh]
// through tables [B, M] (block ids clamped into [0, N), as a JAX gather
// clamps), masked by kpos < min(ctx_lens[b], M * BS). The TPU kernel runs
// a grid (B, M) in order: one program per (row, table column) loads one
// whole pool block for all heads, skips a column past ctx, and carries an
// online softmax across the M columns in VMEM. Here the M axis becomes
// parallel work.
//
// What bounds it on an H100: bytes. Decode attention has one query row
// per head, so each key and value element is used for 2 FLOPs: the
// function moves 2 * sum(ctx) * H * (Dh * e + s) pool bytes (e = 2 for
// bf16, 4 for float32, 1 for int8 codes; s = 2 scale bytes a vector for
// int8, else 0) at 3.35 TB/s, against 4 * sum(ctx) * H * Dh FLOPs, about
// one FLOP a byte, far under the ~295 FLOP/byte where the tensor cores
// would be the limit. A wgmma takes 64 query rows; here there is one
// (GPT-2 has no grouped heads to fill the rest), so tensor cores would
// waste 63 of 64 rows and the design is about bytes in flight instead.
// One design serves float32 and bf16 alike.
//
// The design:
//   * Split-KV. The grid is (key split, head group of 4, row). The host
//     plans the splits from shapes it knows (B, H, M, BS: ops/kernels.py
//     `decode_split_plan`), never from ctx_lens, which lives on the card:
//     every split covers `chunk` keys (a multiple of 64) of [0, M * BS).
//     A split whose first key lies at or past min(ctx_b, M * BS) loads
//     nothing and writes an empty partial (l = 0). Each CTA writes a
//     float32 partial (m, l, acc[Dh]) per (b, h, split) to a workspace;
//     `paged_decode_combine_kernel`, one warp per (b, h), merges them in
//     split order and writes acc / max(l, 1e-30) in q's dtype. With one
//     split the split kernel writes the output and no combine runs. No
//     atomics and a fixed order everywhere: two launches give the same
//     bits.
//   * TMA into a 4-stage ring. The pool is viewed as [N * BS, H, Dh]; one
//     tensor map per pool and call, box {Dh, 4 heads, kb keys} with kb =
//     gcd(BS, stage keys), no swizzle. The producer warp keeps a window
//     of 256 of the row's block ids (clamped) in shared memory, filled
//     by its 32 lanes at once, so a stage waits on no table read; its
//     lanes issue one box per block piece, K and V, into the stage.
//     Small blocks (BS 4, 16) share a stage and its barrier, whose
//     expected bytes are their total; a large block (BS 128) spans
//     several stages. A stage holds 16 KB of
//     K and V (stage keys = 2048 / (Dh * e)), so a CTA keeps up to 64 KB
//     in flight and an SM two or three CTAs. The int8 scales ([N, BS, H],
//     2 bytes a vector, too narrow for a TMA box) are read by the
//     producer's lanes with ordinary loads a stage ahead, into registers,
//     and stored beside the stage's codes; each lane then arrives on the
//     stage's barrier.
//   * Consumers work from shared memory. Warp w owns head 4g + w of its
//     group. A key vector is read by Dh * e / 16 lanes, 16 bytes each, so
//     a warp reads 512 contiguous-per-key bytes a round and takes 32 /
//     (Dh * e / 16) keys at once: q.k is a partial dot per lane and a
//     shuffle reduction inside the key's lanes. P.V reuses the layout:
//     the lane that scored key j holds p_j and multiplies it into the
//     same 16 bytes of v_j, so p never leaves the register. Each lane
//     group keeps its own online softmax (m, l, acc of its Dh slice);
//     the groups merge by shuffles at the end of the split. No block-wide
//     barrier per stage: only the ring's full and empty barriers. Scores
//     are in log2 units (scale * log2 e folded into q), so p = exp2(x - m);
//     a lane's smem offsets are computed once, outside the stage loop,
//     and the loop has no branch (a masked key weighs 0).
//   * int8 is dequantized in registers: s = (q . codes) * k_scale * scale,
//     and p * v_scale multiplies the value codes.
//   * Semantics as the reference: masked keys weigh nothing (the
//     reference's -1e30 fill gives exp(-1e30 - m) = 0 beside a live key;
//     here a masked key is skipped), a row with ctx 0 gives zeros (as the
//     Pallas kernel's untouched accumulator does), an idle slot (ctx 1 on
//     trash block 0) reads one key. p stays float32 for P.V where the
//     reference rounds it to v's dtype (unified_attention.py:310-312):
//     float32 p is the closer to the exact sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "elem.cuh"
#include "sm90_tile.cuh"

namespace pt {
namespace decode {
namespace {

constexpr int kGroup = 4;                 // heads per CTA, a warp each
constexpr int kThreads = 32 * (kGroup + 1);  // + the producer warp
constexpr int kStages = 4;                // ring depth
constexpr int kRounds = 4;                // key rounds of a warp a stage
constexpr int kCombineWarps = 4;
constexpr int kWindow = 256;              // block ids the producer holds
constexpr float kLog2e = 1.4426950408889634f;

// The lane layout of one element type and head_dim: a key vector of one
// head is kRowBytes, read by kLanes lanes of 16 bytes (kElems elements
// each); a warp round takes kKeysPerRound keys, a stage kKeys.
template <typename KV, int DH>
struct Geo {
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(KV));
  static constexpr int kLanes = kRowBytes / 16;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(KV));
  static constexpr int kKeysPerRound = 32 / kLanes;
  static constexpr int kKeys = kKeysPerRound * kRounds;
  static_assert(kLanes >= 1 && kLanes <= 32 && kLanes * kElems == DH,
                "a key vector must be 16..512 bytes");
  static_assert(kKeys <= 64, "a split's keys must hold whole stages");
};

struct Params {
  void* out;           // [B, H, Dh] in q's dtype (one split)
  float* ws;           // [B*H*splits, Dh] acc, then [B*H*splits, 2] (m in
                       // log2 units, l)
  const void* q;       // [B, H, Dh]
  const void* kscale;  // [N*BS, H] (int8 pools)
  const void* vscale;
  const int* tables;   // [B, M]
  const int* ctx_lens;  // [B]
  int B, H, N, BS, M;
  int splits, chunk;   // the host's plan
  int heads;           // heads of a TMA box: min(kGroup, H)
  int kb;              // keys of a TMA box: gcd(BS, stage keys)
  int nbox;            // boxes of a stage: stage keys / kb
  int box_bytes;       // kb * heads * Dh * e
  int box_slot;        // box_bytes rounded up to 128 (TMA's alignment)
  int stage_bytes;     // K boxes, V boxes, (int8) K and V scales
  float scale;
};

// 16 bytes of shared memory as floats.
__device__ __forceinline__ void unpack16(const float* s, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* s,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const int8_t* s, float (&x)[16]) {
  const int4 u = *reinterpret_cast<const int4*>(s);
  const int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const char4 c = *reinterpret_cast<const char4*>(&w[i]);
    x[4 * i] = c.x; x[4 * i + 1] = c.y; x[4 * i + 2] = c.z;
    x[4 * i + 3] = c.w;
  }
}

template <typename T, typename KV, bool QUANT, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const Params p) {
  using G = Geo<KV, DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages *
                                               p.stage_bytes);
  uint64_t* empty = full + kStages;
  int* win = reinterpret_cast<int*>(empty + kStages);  // block id window

  const int split = blockIdx.x, h0 = blockIdx.y * p.heads, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lmax = p.M * p.BS;
  const int ctx = min(max(__ldg(p.ctx_lens + b), 0), lmax);
  const int c0 = split * p.chunk;
  const int c1 = min(min(c0 + p.chunk, lmax), ctx);  // end of live keys
  const int nt = c1 > c0 ? (c1 - c0 + G::kKeys - 1) / G::kKeys : 0;
  // the int8 scales of a stage: K then V, [kKeys][kGroup] floats each
  const int scale_off = 2 * p.nbox * p.box_slot;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // full: the producer's expect_tx (+ each lane's arrival once it has
      // stored the stage's int8 scales); empty: one arrival a consumer
      sm90::mbar_init(sm90::smem_u32(&full[s]), QUANT ? 1 + 32 : 1);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), kGroup);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kGroup) {  // ---- producer warp
    // the live keys of stage t: [k0, k0 + nk)
    auto stage_k0 = [&](int t) { return c0 + t * G::kKeys; };
    auto stage_nk = [&](int t) { return min(G::kKeys, c1 - stage_k0(t)); };
    // win[i] holds the (clamped) block id of table column mw + i; it is
    // refilled, all lanes at once, when stages t and t + 1 leave it
    int mw = -kWindow;
    auto cover = [&](int t) {
      const int lo = stage_k0(t) / p.BS;
      const int tn = t + 1 < nt ? t + 1 : t;
      const int hi = (stage_k0(tn) + stage_nk(tn) - 1) / p.BS;
      if (lo >= mw && hi < mw + kWindow) return;
      __syncwarp();
      mw = lo;
      const int* row = p.tables + static_cast<int64_t>(b) * p.M;
      for (int i = lane; i < kWindow; i += 32) {
        const int m = mw + i;
        win[i] = m < p.M ? min(max(__ldg(row + m), 0), p.N - 1) : 0;
      }
      __syncwarp();
    };
    auto row_of = [&](int kpos) {
      const int m = kpos / p.BS;
      return win[m - mw] * p.BS + (kpos - m * p.BS);
    };
    // int8: this lane's scales of a stage (entries lane + 32 r of the
    // stage's [kKeys][kGroup]), loaded a stage ahead of their store
    constexpr int kSc = QUANT ? G::kKeys * kGroup / 32 : 1;
    T kraw[kSc], vraw[kSc];
    auto load_scales = [&](int t) {
      if constexpr (QUANT) {
        const T* ksc = static_cast<const T*>(p.kscale);
        const T* vsc = static_cast<const T*>(p.vscale);
        const int k0 = stage_k0(t), nk = stage_nk(t);
#pragma unroll
        for (int r = 0; r < kSc; ++r) {
          const int i = lane + 32 * r, j = i / kGroup, g = i % kGroup;
          kraw[r] = vraw[r] = from_f<T>(0.f);
          if (j < nk && g < p.heads && h0 + g < p.H) {
            const int64_t at =
                static_cast<int64_t>(row_of(k0 + j)) * p.H + h0 + g;
            kraw[r] = ksc[at];
            vraw[r] = vsc[at];
          }
        }
      }
    };
    if (nt > 0) {
      if (lane == 0) {
        sm90::tma_prefetch(&kmap);
        sm90::tma_prefetch(&vmap);
      }
      cover(0);
      load_scales(0);
    }
    for (int t = 0; t < nt; ++t) {
      const int s = t % kStages;
      if (t >= kStages)
        sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((t / kStages) - 1) & 1);
      cover(t);
      const int k0 = stage_k0(t);
      const int nb = (stage_nk(t) + p.kb - 1) / p.kb;  // boxes holding a
      uint8_t* st = smem + s * p.stage_bytes;          // live key
      const uint32_t fb = sm90::smem_u32(&full[s]);
      if (lane == 0) sm90::mbar_expect_tx(fb, 2 * nb * p.box_bytes);
      __syncwarp();
      for (int j = lane; j < nb; j += 32) {
        const int row = row_of(k0 + j * p.kb);
        sm90::tma_load_3d(sm90::smem_u32(st + j * p.box_slot), &kmap, fb, 0,
                          h0, row);
        sm90::tma_load_3d(sm90::smem_u32(st + (p.nbox + j) * p.box_slot),
                          &vmap, fb, 0, h0, row);
      }
      if constexpr (QUANT) {
        float* sc = reinterpret_cast<float*>(st + scale_off);
#pragma unroll
        for (int r = 0; r < kSc; ++r) {
          sc[lane + 32 * r] = to_f(kraw[r]);
          sc[G::kKeys * kGroup + lane + 32 * r] = to_f(vraw[r]);
        }
        sm90::mbar_arrive(fb);  // release: this lane's scales are stored
        if (t + 1 < nt) load_scales(t + 1);
      }
    }
    return;
  }

  // ---- consumer warps: warp w owns head h0 + w
  const int h = h0 + warp;
  const bool head_ok = warp < p.heads && h < p.H;
  const int part = lane % G::kLanes;  // this lane's 16 bytes of a vector
  const int grp = lane / G::kLanes;   // this lane's key in a round
  // q in log2 units (scale * log2 e folded in), so p = exp2(x - m)
  float qv[G::kElems];
  {
    const T* qp = static_cast<const T*>(p.q) +
                  (static_cast<int64_t>(b) * p.H + min(h, p.H - 1)) * DH +
                  part * G::kElems;
    const float qs = p.scale * kLog2e;
#pragma unroll
    for (int e = 0; e < G::kElems; ++e)
      qv[e] = head_ok ? to_f(qp[e]) * qs : 0.f;
  }
  // m starts finite, so no exp2 ever sees -inf - -inf; a masked score is
  // -inf and weighs exp2(-inf) = 0
  float m = -FLT_MAX, l = 0.f;
  float acc[G::kElems];
#pragma unroll
  for (int e = 0; e < G::kElems; ++e) acc[e] = 0.f;

  // where this lane's key of round r lies in a stage (its 16 bytes of the
  // vector; a warp past the group's heads reads head 0's slot and writes
  // nothing): the same in every stage, so no division in the loop
  const int vec_off = (warp < p.heads ? warp : 0) * G::kRowBytes + part * 16;
  const int v_base = p.nbox * p.box_slot;
  int koff[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int j = r * G::kKeysPerRound + grp;
    koff[r] = (j / p.kb) * p.box_slot + (j % p.kb) * p.heads * G::kRowBytes +
              vec_off;
  }
  for (int t = 0; t < nt; ++t) {
    const int s = t % kStages;
    sm90::mbar_wait(sm90::smem_u32(&full[s]), (t / kStages) & 1);
    const uint8_t* st = smem + s * p.stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + scale_off);
    const int live = c1 - (c0 + t * G::kKeys);  // live keys of the stage
    float x[kRounds];
    float xmax = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = r * G::kKeysPerRound + grp;
      float kv[G::kElems];
      unpack16(reinterpret_cast<const KV*>(st + koff[r]), kv);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < G::kElems; ++e) d = fmaf(qv[e], kv[e], d);
#pragma unroll
      for (int o = G::kLanes / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if constexpr (QUANT) d *= sc[j * kGroup + warp];
      x[r] = j < live ? d : -INFINITY;  // masked: no weight
      xmax = fmaxf(xmax, x[r]);
    }
    const float m_new = fmaxf(m, xmax);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < G::kElems; ++e) acc[e] *= alpha;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = r * G::kKeysPerRound + grp;
      const bool ok = j < live;
      float pj = exp2f(x[r] - m);  // 0 when masked
      l += pj;
      if constexpr (QUANT) pj *= sc[G::kKeys * kGroup + j * kGroup + warp];
      // a masked key reads key 0's value (loaded, finite) at weight 0:
      // the stage's unloaded boxes may hold anything
      float vv[G::kElems];
      unpack16(reinterpret_cast<const KV*>(st + v_base +
                                           (ok ? koff[r] : vec_off)),
               vv);
      pj = ok ? pj : 0.f;
#pragma unroll
      for (int e = 0; e < G::kElems; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
  }

  // merge the warp's lane groups (lanes part + kLanes * g), fixed order
  float mw = m;
#pragma unroll
  for (int o = 16; o >= G::kLanes; o >>= 1)
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  const float f = l > 0.f ? exp2f(m - mw) : 0.f;
  l *= f;
#pragma unroll
  for (int e = 0; e < G::kElems; ++e) acc[e] *= f;
#pragma unroll
  for (int o = 16; o >= G::kLanes; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < G::kElems; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (!head_ok || grp != 0) return;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  if (p.splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = static_cast<T*>(p.out) + bh * DH + part * G::kElems;
#pragma unroll
    for (int e = 0; e < G::kElems; ++e) o[e] = from_f<T>(acc[e] * inv);
    return;
  }
  const int64_t at = bh * p.splits + split;
  float* wa = p.ws + at * DH + part * G::kElems;
#pragma unroll
  for (int e = 0; e < G::kElems; ++e) wa[e] = acc[e];
  if (part == 0) {
    float* ml = p.ws + static_cast<int64_t>(p.B) * p.H * p.splits * DH;
    ml[2 * at] = mw;
    ml[2 * at + 1] = l;
  }
}

// One warp per (b, h): merges the splits' partials in split order. Lane s
// (mod 32) reads partial s's (m, l) and forms its weight 2^(m - max m); a
// partial with l = 0 (no live key) weighs 0 and its m is never read, so a
// row whose splits are all empty (ctx 0) gives zeros. The weighted sums
// run in split order (acc) and over a fixed shuffle tree (l): the same
// bits on every launch.
template <typename T, int DH>
__global__ void __launch_bounds__(32 * kCombineWarps)
paged_decode_combine_kernel(T* __restrict__ out, const float* __restrict__ ws,
                            int BH, int splits) {
  constexpr int kPer = DH / 32;
  const int bh = blockIdx.x * kCombineWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (bh >= BH) return;
  const float* ml = ws + static_cast<int64_t>(BH) * splits * DH +
                    static_cast<int64_t>(bh) * splits * 2;
  float mx = -INFINITY;
  for (int s = lane; s < splits; s += 32)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float acc[kPer], l = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  const float* wa = ws + static_cast<int64_t>(bh) * splits * DH + lane;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int s = s0 + lane;
    float w = 0.f, lw = 0.f;
    if (s < splits && ml[2 * s + 1] > 0.f) {
      w = exp2f(ml[2 * s] - mx);
      lw = w * ml[2 * s + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lw += __shfl_xor_sync(0xffffffffu, lw, o);
    l += lw;
    const int n = min(32, splits - s0);
    for (int i = 0; i < n; ++i) {
      const float wi = __shfl_sync(0xffffffffu, w, i);
      const float* src = wa + static_cast<int64_t>(s0 + i) * DH;
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[e] = fmaf(wi, src[32 * e], acc[e]);
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* o = out + static_cast<int64_t>(bh) * DH + lane;
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[32 * i] = from_f<T>(acc[i] * inv);
}

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

int round_up(int x, int to) { return (x + to - 1) / to * to; }

template <typename T, typename KV, bool QUANT, int DH>
int launch(Params p, const void* k, const void* v, cudaStream_t st) {
  using G = Geo<KV, DH>;
  p.heads = p.H < kGroup ? p.H : kGroup;
  p.kb = gcd(p.BS, G::kKeys);
  p.nbox = G::kKeys / p.kb;
  p.box_bytes = p.kb * p.heads * G::kRowBytes;
  p.box_slot = round_up(p.box_bytes, 128);
  p.stage_bytes = round_up(
      2 * p.nbox * p.box_slot + (QUANT ? 2 * G::kKeys * kGroup * 4 : 0), 128);
  const int smem =
      kStages * p.stage_bytes + 2 * kStages * 8 + 4 * kWindow + 128;
  const CUtensorMapDataType type =
      QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
            : std::is_same<KV, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int rows = p.N * p.BS;
  CUtensorMap km, vm;
  if (!sm90::make_pool_map(&km, type, sizeof(KV), k, rows, p.H, DH, p.kb,
                           p.heads) ||
      !sm90::make_pool_map(&vm, type, sizeof(KV), v, rows, p.H, DH, p.kb,
                           p.heads))
    return cudaErrorInvalidValue;
  auto kern = paged_decode_split_kernel<T, KV, QUANT, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.splits, (p.H + p.heads - 1) / p.heads, p.B);
  kern<<<grid, kThreads, smem, st>>>(km, vm, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const int BH = p.B * p.H;
  paged_decode_combine_kernel<T, DH>
      <<<(BH + kCombineWarps - 1) / kCombineWarps, 32 * kCombineWarps, 0,
         st>>>(static_cast<T*>(p.out), p.ws, BH, p.splits);
  return cudaGetLastError();
}

template <typename T, typename KV, bool QUANT>
int launch_dh(int Dh, const Params& p, const void* k, const void* v,
              cudaStream_t st) {
  if (Dh == 32) return launch<T, KV, QUANT, 32>(p, k, v, st);
  if (Dh == 64) return launch<T, KV, QUANT, 64>(p, k, v, st);
  if (Dh == 128) return launch<T, KV, QUANT, 128>(p, k, v, st);
  return -1;
}

}  // namespace
}  // namespace decode
}  // namespace pt

extern "C" {

// K2. out/q [B, H, Dh]; k/v [N, BS, H, Dh] (int8 codes when quant, with
// ks/vs [N, BS, H] scales in the compute dtype); tables [B, M]; ctx_lens
// [B]; ws float32 [B * H * splits * (Dh + 2)] when splits > 1 (unused
// otherwise); splits * chunk >= M * BS, chunk a multiple of 64. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t value (0 = launched), or
// -1 for an unsupported (dtype, Dh) pair.
int pt_paged_decode_attention(void* out, void* ws, const void* q,
                              const void* k, const void* v, const void* ks,
                              const void* vs, const int* tables,
                              const int* ctx_lens, int B, int H, int Dh,
                              int N, int BS, int M, int splits, int chunk,
                              float scale, int dtype, int quant,
                              void* stream) {
  using namespace pt::decode;
  if (B <= 0) return 0;
  if (splits < 1 || chunk < 1 || chunk % 64 ||
      static_cast<int64_t>(splits) * chunk < static_cast<int64_t>(M) * BS)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{};
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.q = q;
  p.kscale = ks;
  p.vscale = vs;
  p.tables = tables;
  p.ctx_lens = ctx_lens;
  p.B = B; p.H = H; p.N = N; p.BS = BS; p.M = M;
  p.splits = splits;
  p.chunk = chunk;
  p.scale = scale;
  if (dtype == 0 && !quant)
    return launch_dh<float, float, false>(Dh, p, k, v, st);
  if (dtype == 0 && quant)
    return launch_dh<float, int8_t, true>(Dh, p, k, v, st);
  if (dtype == 1 && !quant)
    return launch_dh<__nv_bfloat16, __nv_bfloat16, false>(Dh, p, k, v, st);
  if (dtype == 1 && quant)
    return launch_dh<__nv_bfloat16, int8_t, true>(Dh, p, k, v, st);
  return -1;
}

}  // extern "C"
