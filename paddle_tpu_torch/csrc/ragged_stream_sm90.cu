// K1, the ragged-stream attention of the serving path, in bfloat16 on
// Hopper's tensor cores (sm_90a): dense and int8 pools, head_dim 32, 64 or
// 128. The float32 K1 stays the SIMT `ragged_stream_kernel` of
// unified_attention.cu (TF32 products would not hold float32 parity),
// whose C entry sends bfloat16 here.
//
// Replaces paddle_tpu/ops/pallas/unified_attention.py
// `unified_ragged_attention_kernel` (206; its pallas_call at 264), body
// `_stream_kernel` (149): segment-causal attention of a token-packed
// stream q [T, H, Dh] against one layer's pool [N, BS, H, Dh] through
// tables [B, M] (block ids clamped into [0, N), as a JAX gather clamps).
// Row t attends the keys of table row seg[t] at cache positions
// 0..min(pos[t], M * BS - 1); pad rows (pos < 0, or seg outside [0, B))
// attend nothing and come out as exact zeros. The TPU kernel runs a grid
// (128-row query tiles, table columns) in order, one segment a tile under
// a packing contract, one pool block for all heads a step through the
// MXU (products in the input dtype into float32, p cast to v's dtype
// before p.v), int8 blocks dequantized in VMEM (`_load_kv`, 136).
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): K1 does
// 4 * H * Dh * sum_t (pos_t + 1) FLOPs over the q, out and the K/V of
// each segment's horizon. A prefill chunk of n tokens reuses every key n
// times, so at serving's shapes it is a product for the tensor cores
// (the SIMT kernel it replaces ran both products as float32 FMAs); a
// short chunk is bound by bytes and by latency.
//
// The design:
//   * One CTA per (64-row query tile, head): one consumer warpgroup owns
//     the 64 rows, a producer warp feeds it. Grid (H, tiles), tiles walked
//     last first (a chunk's later rows see the most keys). No split of the
//     keys: phase 5's 512-token chunks give 8 x 12 = 96 CTAs, a
//     4096-token stream 768; two launches give the same bits (no atomics,
//     one order).
//   * The port packs chunks at pack_align 8, with no tile contract, so a
//     tile may hold several segments. The CTA reads its rows' seg/pos,
//     finds the distinct segments (in order of first appearance) and runs
//     one key pass per segment up to its horizon: the largest pos of its
//     rows, capped at M * BS - 1. In a pass the rows of other segments
//     see only masked keys: p = 0, their m, l and accumulator unchanged
//     (alpha = 1). The position mask runs only on stages that cross a
//     row's limit.
//   * Q by TMA: a 3-D map over (Dh, H, T), one head a box, swizzled (128
//     bytes a row, 64 at Dh 32). K and V through the block table by TMA:
//     the pool viewed as [N * BS, H, Dh] (`make_pool_map`, swizzled), a
//     64-key stage as 64 / kb boxes of {64 columns, 1 head, kb rows}, kb =
//     gcd(BS, 64): BS 4 sixteen 4-row boxes, BS 16 four, BS 128 one box a
//     stage. A box lands in the stage's tile at its rows' byte offset; the
//     swizzle is a function of the shared-memory address (bits 4-6 XOR
//     bits 7-9), so a 512-byte BS 4 box at an offset of 512 continues the
//     1024-byte pattern as one 8-row box would. The producer keeps 256 of
//     the segment's block ids (clamped; columns past M read block 0) in
//     shared memory, so a stage waits on no table read, and loads every
//     box of every stage, so no key of a tile holds stale bytes.
//   * int8 pools: wgmma takes no int8 x bf16 product. The codes land
//     unswizzled in the ring by TMA (box {Dh, 1 head, kb rows}); the
//     per-vector scales ([N, BS, H] bf16, too narrow for TMA) are read by
//     the producer's lanes with ordinary loads issued before it waits for
//     the stage's slot, and stored beside the codes. The consumers convert
//     a stage into a swizzled bf16 K and V tile: code * scale rounded to
//     bf16, as the reference's `_load_kv` dequantizes (not the plain
//     version's scales on S's and P's columns). A dense bf16 pool takes
//     the same staged route only where a box could not start on TMA's
//     128-byte alignment in the swizzled tile (Dh 32 with an odd BS).
//   * S = Q.K^T is wgmma m64n64k16 (both operands K-major), O += P.V
//     m64nDk16 with P in registers (bf16, as the reference's
//     `p.astype(v.dtype)`) and V MN-major through the transpose-B flag
//     (`issue_s`, `issue_pv`, `pack_p` of flash_sm90.cuh). The online
//     softmax runs on the S accumulator in log2 units; every product is
//     waited for inside its stage, so no accumulator crosses the loop's
//     back edge with a wgmma in flight. Loop bounds and roles come from
//     shuffles, so every branch around a wgmma is warp-uniform.
//   * Shared memory (bf16 dense, Dh 64): Q 8 KB, a 3-stage ring of 16 KB
//     (2 stages of 32 KB at Dh 128), barriers, the rows' seg/pos, the
//     passes and the id window: three CTAs an SM (two at Dh 128).

#include <climits>
#include <type_traits>

#include "flash_sm90.cuh"

namespace pt {
namespace stream {
namespace {

using flash::Boxes;

constexpr int kRows = 64;  // query rows of a tile: one consumer warpgroup
constexpr int kKeys = 64;  // keys of a ring stage
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kWindow = 256;               // block ids the producer holds
constexpr int kConvertBar = 1;             // the consumers' named barrier
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles : Boxes<D> {
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kTileBytes = kKeys * D * 2;  // a bf16 Q, K or V tile
  static_assert(kRows == kKeys, "Q, K and V tiles share one size");
};

struct Params {
  __nv_bfloat16* out;            // [T, H, Dh]
  const __nv_bfloat16* kscale;   // [N * BS, H] (int8 pools)
  const __nv_bfloat16* vscale;
  const int* tables;             // [B, M]
  const int* seg;                // [T]
  const int* pos;                // [T]
  int T, H, N, BS, B, M;
  int kb, kb_shift;  // pool rows of a TMA box: gcd(BS, kKeys), its log2
  int nbox;          // boxes of a stage, per tensor: kKeys / kb
  int staged;        // boxes land unswizzled in the ring, then converted
  int box_bytes;     // staged: bytes of a box
  int box_slot;      // staged: box_bytes rounded up to 128
  int stage_bytes;   // bytes of a ring stage (K, V, int8 scales)
  float scale2;      // scale * log2 e
};

// Shared-memory offsets from the 1024-aligned base: Q, the converted K
// and V tiles (staged only), the ring, the barriers (q, full[], empty[]),
// then ints: the rows' seg and pos, a first-row flag and horizon per row,
// the passes' segment and horizon, their count, and the id window.
struct Smem {
  int q, kt, vt, ring, bars, ints, total;
};

template <int D>
__host__ __device__ inline Smem plan(const Params& p) {
  using G = Tiles<D>;
  Smem s;
  s.q = 0;
  s.kt = G::kTileBytes;
  s.vt = s.kt + (p.staged ? G::kTileBytes : 0);
  s.ring = s.vt + (p.staged ? G::kTileBytes : 0);
  s.bars = s.ring + G::kStages * p.stage_bytes;
  s.ints = s.bars + 8 * (1 + 2 * G::kStages);
  s.total = s.ints + 4 * (6 * kRows + 1 + kWindow);
  return s;
}

// 16 int8 codes times a scale as 16 bf16 (two 16-byte chunks).
__device__ __forceinline__ void dequant16(const uint4& c, float sc,
                                          uint4* out) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const char4 b = *reinterpret_cast<const char4*>(&w[i]);
    o[2 * i] = sm90::pack_bf16(b.x * sc, b.y * sc);
    o[2 * i + 1] = sm90::pack_bf16(b.z * sc, b.w * sc);
  }
  out[0] = make_uint4(o[0], o[1], o[2], o[3]);
  out[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// One staged tensor of a stage (kKeys rows of D elements, box j at
// j * box_slot, row i of a box at i * D * sizeof(KV)) into a swizzled bf16
// tile in Boxes<D>'s layout: int8 codes times their vector's scale, bf16
// copied. A 16-byte chunk at tile offset `off` lands at off with bits 4-6
// (4-5 for the 64-byte swizzle) XORed by bits 7-9 (7-8), as TMA and wgmma
// place it.
template <int D, typename KV>
__device__ __forceinline__ void convert(uint8_t* tile, const uint8_t* src,
                                        const float* scale, const Params& p,
                                        int ctid) {
  using G = Boxes<D>;
  constexpr int kElems = 16 / static_cast<int>(sizeof(KV));
  constexpr int kChunks = D / kElems;  // 16-byte source chunks a row
  constexpr int kOut = kElems / 8;     // 16-byte bf16 chunks a source chunk
  constexpr int kMask = G::kSwizzle == 128 ? 7 : 3;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
#pragma unroll
  for (int i = ctid; i < kKeys * kChunks; i += kConsumers) {
    const int j = i / kChunks, c = i % kChunks;
    const uint4 v = *reinterpret_cast<const uint4*>(
        src + (j >> p.kb_shift) * p.box_slot + (j & (p.kb - 1)) * kRowBytes +
        c * 16);
    uint4 out[kOut];
    if constexpr (sizeof(KV) == 1)
      dequant16(v, scale[j], out);
    else
      out[0] = v;
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int col = c * kElems + 8 * e;  // the chunk's first column
      const int off = (col / G::kBox) * kKeys * G::kSwizzle +
                      j * G::kSwizzle + (col % G::kBox) * 2;
      *reinterpret_cast<uint4*>(tile + (off ^ (((off >> 7) & kMask) << 4))) =
          out[e];
    }
  }
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(kThreads, D == 128 ? 2 : 3)
ragged_stream_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const Params p) {
  using G = Tiles<D>;
  using KV = std::conditional_t<QUANT, int8_t, __nv_bfloat16>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same, as a pointer
  const Smem sp = plan<D>(p);
  const uint32_t q_s = base + sp.q;
  const uint32_t q_bar = base + sp.bars;
  auto full = [&](int s) { return q_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return q_bar + 8 * (1 + G::kStages + s); };
  int* rseg = reinterpret_cast<int*>(gbase + sp.ints);
  int* rpos = rseg + kRows;
  int* rlead = rpos + kRows;
  int* rhz = rlead + kRows;
  int* pseg = rhz + kRows;
  int* phz = pseg + kRows;
  int* npass_s = phz + kRows;
  int* win = npass_s + 1;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int cap = p.M * p.BS - 1;  // the table reaches no further

  // the tile's rows: (segment, position); a pad row is segment -1
  if (tid < kRows) {
    const int t = t0 + tid;
    int sg = -1, ps = -1;
    if (t < p.T) {
      sg = __ldg(p.seg + t);
      ps = __ldg(p.pos + t);
    }
    if (sg < 0 || sg >= p.B || ps < 0) {
      sg = -1;
      ps = -1;
    }
    rseg[tid] = sg;
    rpos[tid] = ps;
  }
  if (tid == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < G::kStages; ++s) {
      // full: the producer's expect_tx (+ each lane's arrival once it has
      // stored the stage's int8 scales); empty: every consumer thread
      sm90::mbar_init(full(s), QUANT ? 1 + 32 : 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // the passes: one per distinct segment, in order of first appearance,
  // up to the largest position its rows hold (capped at the table's end)
  if (tid < kRows) {
    const int sg = rseg[tid];
    int lead = sg >= 0, hz = -1;
    for (int j = 0; j < kRows; ++j) {
      if (rseg[j] == sg) {
        if (j < tid) lead = 0;
        hz = max(hz, rpos[j]);
      }
    }
    rlead[tid] = lead;
    rhz[tid] = min(hz, cap);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < kRows; ++i) {
      if (rlead[i]) {
        pseg[n] = rseg[i];
        phz[n] = rhz[i];
        ++n;
      }
    }
    *npass_s = n;
  }
  __syncthreads();

  // roles and loop bounds from shuffles: warp-uniform to the compiler, so
  // it keeps the wgmma instructions unserialised
  const int role = __shfl_sync(0xffffffffu, tid / kConsumers, 0);
  const int npass = __shfl_sync(0xffffffffu, *npass_s, 0);
  if (role == 1) {
    // ---- producer warp: Q once, then every pass's stages ----
    const int lane = tid % 32;
    if (lane == 0) {
      sm90::tma_prefetch(&kmap);
      sm90::tma_prefetch(&vmap);
      sm90::mbar_expect_tx(q_bar, G::kTileBytes);
      for (int b = 0; b < G::kBoxes; ++b)
        sm90::tma_load_3d(q_s + b * kRows * G::kSwizzle, &qmap, q_bar,
                          b * G::kBox, h, t0);
    }
    const int stage_tx = p.staged ? 2 * p.nbox * p.box_bytes
                                  : 2 * G::kTileBytes;
    int g = 0;  // stages issued over all passes
    for (int ps = 0; ps < npass; ++ps) {
      const int* trow = p.tables + static_cast<int64_t>(pseg[ps]) * p.M;
      const int nst = phz[ps] / kKeys + 1;
      // win[i] holds the clamped block id of table column mw + i (block 0
      // past the table's M columns); refilled, all lanes at once, when a
      // stage leaves it and at every new segment
      int mw = INT_MIN / 2;
      for (int t = 0; t < nst; ++t, ++g) {
        const int s = g % G::kStages;
        const int k0 = t * kKeys;
        const int lo = k0 / p.BS, hi = (k0 + kKeys - 1) / p.BS;
        if (lo < mw || hi >= mw + kWindow) {
          __syncwarp();
          mw = lo;
          for (int i = lane; i < kWindow; i += 32) {
            const int m = mw + i;
            win[i] = m < p.M ? min(max(__ldg(trow + m), 0), p.N - 1) : 0;
          }
          __syncwarp();
        }
        auto row_of = [&](int kpos) {
          const int m = kpos / p.BS;
          return win[m - mw] * p.BS + (kpos - m * p.BS);
        };
        // int8: this lane's scales of the stage (keys lane, lane + 32),
        // loaded before the wait for the stage's slot
        float ksc[2] = {0.f, 0.f}, vsc[2] = {0.f, 0.f};
        if constexpr (QUANT) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int64_t at =
                static_cast<int64_t>(row_of(k0 + lane + 32 * r)) * p.H + h;
            ksc[r] = to_f(p.kscale[at]);
            vsc[r] = to_f(p.vscale[at]);
          }
        }
        if (g >= G::kStages)
          sm90::mbar_wait(empty(s), ((g / G::kStages) - 1) & 1);
        const uint32_t st = base + sp.ring + s * p.stage_bytes;
        if (lane == 0) sm90::mbar_expect_tx(full(s), stage_tx);
        __syncwarp();
        for (int j = lane; j < p.nbox; j += 32) {
          const int row = row_of(k0 + j * p.kb);
          if (p.staged) {
            sm90::tma_load_3d(st + j * p.box_slot, &kmap, full(s), 0, h, row);
            sm90::tma_load_3d(st + (p.nbox + j) * p.box_slot, &vmap, full(s),
                              0, h, row);
          } else {
#pragma unroll
            for (int b = 0; b < G::kBoxes; ++b) {
              const uint32_t off =
                  (b * kKeys + j * p.kb) * G::kSwizzle;
              sm90::tma_load_3d(st + off, &kmap, full(s), b * G::kBox, h,
                                row);
              sm90::tma_load_3d(st + G::kTileBytes + off, &vmap, full(s),
                                b * G::kBox, h, row);
            }
          }
        }
        if constexpr (QUANT) {
          float* sc = reinterpret_cast<float*>(
              gbase + sp.ring + s * p.stage_bytes + 2 * p.nbox * p.box_slot);
          sc[lane] = ksc[0];
          sc[lane + 32] = ksc[1];
          sc[kKeys + lane] = vsc[0];
          sc[kKeys + lane + 32] = vsc[1];
          sm90::mbar_arrive(full(s));  // release: this lane's scales
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: the tile's 64 rows ----
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const int cq = 2 * (lane % 4);  // its columns in each 8-column chunk
  int rs[2], rp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] = rseg[r0 + 8 * r];
    rp[r] = min(rpos[r0 + 8 * r], cap);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[kKeys / 2];
  uint32_t pa[kKeys / 16][4];
  sm90::mbar_wait(q_bar, 0);

  int g = 0;
  for (int ps = 0; ps < npass; ++ps) {
    const int sg = __shfl_sync(0xffffffffu, pseg[ps], 0);
    const int nst = __shfl_sync(0xffffffffu, phz[ps], 0) / kKeys + 1;
    // the last key each of this thread's rows sees in the pass: none for a
    // row of another segment (its m, l and o stay as they are)
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lim[r] = rs[r] == sg ? rp[r] : -1;
    for (int t = 0; t < nst; ++t, ++g) {
      const int s = g % G::kStages;
      const int k0 = t * kKeys;
      sm90::mbar_wait(full(s), (g / G::kStages) & 1);
      const uint32_t st = base + sp.ring + s * p.stage_bytes;
      uint32_t kt = st, vt = st + G::kTileBytes;
      if (p.staged) {
        // every thread is past the previous stage's products, which read
        // the converted tiles
        sm90::named_sync(kConvertBar, kConsumers);
        const uint8_t* src = gbase + sp.ring + s * p.stage_bytes;
        const float* scl =
            reinterpret_cast<const float*>(src + 2 * p.nbox * p.box_slot);
        convert<D, KV>(gbase + sp.kt, src, scl, p, tid);
        convert<D, KV>(gbase + sp.vt, src + p.nbox * p.box_slot,
                       scl + kKeys, p, tid);
        sm90::fence_proxy_async();  // the stores, visible to wgmma
        sm90::named_sync(kConvertBar, kConsumers);
        sm90::mbar_arrive(empty(s));  // the staged stage is free
        kt = base + sp.kt;
        vt = base + sp.vt;
      }
      sm90::wgmma_fence();
      flash::issue_s<__nv_bfloat16, D, kKeys, kRows>(sc, q_s, kt);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // the online softmax in log2 units; a key past a row's limit weighs
      // nothing, and the mask runs only where a row's limit falls short of
      // the stage's last key
      const bool masked = k0 + kKeys - 1 > min(lim[0], lim[1]);
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int r = (i / 2) % 2;
        float x = sc[i] * p.scale2;
        if (masked && k0 + 8 * (i / 4) + cq + i % 2 > lim[r]) x = -INFINITY;
        sc[i] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = tmax[r];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float m_new = fmaxf(m[r], v);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
        alpha[r] = exp2f(m[r] - m_use[r]);  // 0 while m was -inf
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2f(sc[i] - m_use[r]);
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      // P in bf16, as the reference's p.astype
      flash::pack_p<__nv_bfloat16>(pa, sc);
      sm90::wgmma_fence();
      flash::issue_pv<__nv_bfloat16, D, kKeys>(o, pa, vt);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      if (!p.staged) sm90::mbar_arrive(empty(s));
    }
  }

  // epilogue: O = acc / l in bf16 (a pad row: 0 / 1e-30 = 0); rows past T
  // are never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int t = t0 + r0 + 8 * r;
    if (t >= p.T) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow =
        p.out + (static_cast<int64_t>(t) * p.H + h) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
  }
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

template <int D, bool QUANT>
int launch(Params p, const void* q, const void* k, const void* v,
           cudaStream_t st) {
  using G = Tiles<D>;
  using KV = std::conditional_t<QUANT, int8_t, __nv_bfloat16>;
  p.kb = gcd(p.BS, kKeys);  // a power of two
  p.kb_shift = 0;
  while ((1 << p.kb_shift) < p.kb) ++p.kb_shift;
  p.nbox = kKeys / p.kb;
  // a bf16 box must start on TMA's 128-byte alignment in the tile
  p.staged = QUANT || (p.kb * G::kSwizzle) % 128 != 0;
  p.box_bytes = p.kb * D * static_cast<int>(sizeof(KV));
  p.box_slot = round_up(p.box_bytes, 128);
  p.stage_bytes =
      p.staged ? round_up(2 * p.nbox * p.box_slot + (QUANT ? 8 * kKeys : 0),
                          128)
               : 2 * G::kTileBytes;
  const int smem = plan<D>(p).total + 1024;  // + slack to align the base
  const int tiles = (p.T + kRows - 1) / kRows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const int rows = p.N * p.BS;
  CUtensorMap qm, km, vm;
  bool ok = sm90::make_pool_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q,
                                p.T, p.H, D, kRows, 1, G::kBox, true);
  if (p.staged) {
    const CUtensorMapDataType type = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    ok = ok &&
         sm90::make_pool_map(&km, type, sizeof(KV), k, rows, p.H, D, p.kb,
                             1) &&
         sm90::make_pool_map(&vm, type, sizeof(KV), v, rows, p.H, D, p.kb, 1);
  } else {
    ok = ok &&
         sm90::make_pool_map(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k,
                             rows, p.H, D, p.kb, 1, G::kBox, true) &&
         sm90::make_pool_map(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v,
                             rows, p.H, D, p.kb, 1, G::kBox, true);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kern = ragged_stream_sm90_kernel<D, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(p.H, tiles), kThreads, smem, st>>>(qm, km, vm, p);
  return cudaGetLastError();
}

template <bool QUANT>
int launch_dh(int Dh, const Params& p, const void* q, const void* k,
              const void* v, cudaStream_t st) {
  if (Dh == 32) return launch<32, QUANT>(p, q, k, v, st);
  if (Dh == 64) return launch<64, QUANT>(p, q, k, v, st);
  if (Dh == 128) return launch<128, QUANT>(p, q, k, v, st);
  return -1;
}

}  // namespace

// The bf16 K1 (called by unified_attention.cu's C entry): q/out
// [n_tok, H, Dh]; k/v [N, BS, H, Dh] bf16, or int8 codes with ks/vs
// [N, BS, H] bf16 scales when quant; tables [B, M]; seg/pos [n_tok].
// Returns a cudaError_t value (0 = launched), or -1 for an unsupported Dh.
int ragged_stream_sm90(void* out, const void* q, const void* k,
                       const void* v, const void* ks, const void* vs,
                       const int* tables, const int* seg, const int* pos,
                       int n_tok, int H, int Dh, int N, int BS, int B, int M,
                       float scale, int quant, cudaStream_t st) {
  Params p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.kscale = static_cast<const __nv_bfloat16*>(ks);
  p.vscale = static_cast<const __nv_bfloat16*>(vs);
  p.tables = tables;
  p.seg = seg;
  p.pos = pos;
  p.T = n_tok; p.H = H; p.N = N; p.BS = BS; p.B = B; p.M = M;
  p.scale2 = scale * kLog2e;
  return quant ? launch_dh<true>(Dh, p, q, k, v, st)
               : launch_dh<false>(Dh, p, q, k, v, st);
}

}  // namespace stream
}  // namespace pt
