// Flash-attention kernels of the training path, for Hopper (sm_90a).
//
// They replace the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K4 `flash_fwd_kernel`   <- `_flash_fwd_lse` (body `_fwd_kernel`):
//      blockwise online-softmax attention over q [BH, Sq, D], k/v
//      [BH, Sk, D], causal or not; writes out [BH, Sq, D] in q's dtype and
//      the per-row log-sum-exp lse [BH, Sq] in float32 (the TPU kernel
//      broadcasts lse over 8 lanes for its (8, 128) tile layout; here it
//      is one float per row).
//   K6 `flash_delta_kernel` <- `_delta_rows` (body `_delta_kernel`):
//      delta = rowsum(dO * O) in float32, [BH, Sq].
//   K9 `flash_bwd_kernel`   <- `_flash_bwd_fused` (body `_bwd_fused_kernel`):
//      the one-pass backward: dk and dv of one key tile, dq summed across
//      key tiles. `tile_p_ds` (flash_common.cuh) is the one place where
//      every backward kernel recomputes p = exp(s - lse) and forms
//      ds = p * (dO.v - delta), as the TPU kernels' `_tile_p_ds`.
// The two-pass backward that replaces `_flash_bwd` (K7 dq, K8 dk/dv/dbias)
// is in flash_bwd_two_pass.cu; K8 shares K9's body (`bwd_key_tile`).
// K4 and K9 are templated on `HasBias`: the `has_bias` variants that
// `flash_attention_bias` reaches. The bias is one float32 row per batch
// entry, bias [B or 1, Sk]; block bh reads row (bh / H) * bias_bstride
// (bstride 0 broadcasts one row over the batch) and adds it to s * scale
// before the softmax. The TPU code tiles it to [BH, 8, Sk] for its
// (8, 128) layout (`_tile_bias`); here it is read in place. K9 bias also
// writes dbias [BH, Sk] float32: the column sums of ds, which each block
// owns for its key tile (it loops over every q tile), so they are summed
// in registers and written once, without atomics; the sums over heads and
// a broadcast batch are the caller's, as in the reference (`_fab_bwd`).
// The switch between K9 and K7 + K8 is the reference's, word for word
// (`_fa_bwd`/`_fab_bwd`: K9 while sq * d * 10 <= 8 MB, else the two-pass
// backward; `ops/flash_attention.py` `uses_two_pass`). It is a TPU VMEM
// budget, not a Hopper limit — K9 here keeps one q tile and one key tile
// in shared memory and takes any length — but following it keeps port and
// reference on the same kernels at every shape.
//
// Causal masking is BOTTOM-RIGHT aligned: query i sees key j iff
// j <= i + (Sk - Sq) — what the reference computes off the TPU
// (`_reference_attention`, `ops/attention.py` `_xla_attention`); the TPU
// kernels align top-left, and the two agree when Sq == Sk. A row that sees
// no key (causal, Sq > Sk) gets the reference's answer for its all--1e30
// score row: the uniform average of every value, and no gradient to q or k
// (nor to the bias, which such a row ignores). A FULLY MASKED row — one
// whose every visible key carries a bias of -1e30, e.g. a padded batch
// row with no real token — follows the reference's XLA path: uniform
// weights over the keys it sees, and the gradients of softmax at those
// weights (which reach q, k and the bias). Its LSE, -1e30 + log n, rounds
// to -1e30 in float32, so exp(s - lse) would recompute p = 1 instead of
// 1/n (what the TPU kernel's `_tile_p_ds` does): the backward takes
// lse <= -1e29 as the mark of such a row and uses p = 1 / (keys it sees).
// Tail tiles are masked, so any Sq, Sk >= 1 is taken; D is 32, 64 or 128.
//
// What bounds them on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   K4 does 4 * BH * D * (visible (i, j) pairs) FLOPs over the bytes of
//   q, k, v, out and lse; at GPT-2-small training shapes (BH 192, S 1024,
//   D 64, causal) both bounds are ~0.03 ms. K9 does 10 * BH * D * pairs
//   FLOPs (~0.065 ms there): operations. K6 reads o and dO once: bytes.
//   The bias adds B * Sk floats to read (and BH * Sk to write in K9).
//
// K4 and K9 in bfloat16 and float16 are not here: `fwd` sends K4 to
// flash_fwd_sm90.cu and `bwd` sends K9 to flash_bwd_sm90.cu, Hopper
// kernels whose products run on the tensor cores (wgmma) fed by TMA
// through an mbarrier ring — the SIMT kernels below ran them as float32
// FMAs, 36-41x their bounds at GPT-2-small shapes. In 16 bits `bwd` then
// runs `scale_cast_kernel` on the workspace as in float32. K6 takes all
// three dtypes here. K4 and K9 in float32 stay these SIMT kernels:
// TF32 tensor-core products keep ~3 digits and would break the float32
// parity of training. What the SIMT design does (float32 products, no
// tensor cores, so they run far from their bounds):
//   * One block per (q tile, bh) in K4 and per (key tile, bh) in K9, with
//     the TPU's sequential grid axis turned into a loop inside the block
//     that stops at the causal horizon (K4) or starts at the first q tile
//     that reaches the key tile (K9) — dead tiles are never visited. bh
//     is on grid y, in launches of at most 65535 bh (`launch_tiles`), so
//     any B * H is taken.
//   * 64 x 64 score tiles in shared memory; each of 256 threads owns a
//     4 x 4 micro-tile of scores and 4 rows of the output, so every
//     shared-memory load feeds two FMAs; padded pitches keep the column
//     reads free of bank conflicts.
//   * The online softmax (m, l, acc) lives in registers in float32; dk/dv
//     (and dbias) accumulate in registers in float32 across the q loop.
//   * K9's dq is summed across key tiles with float32 atomicAdd into a
//     zeroed [BH, Sq, D] workspace (the bf16 K9: one bulk reduction per
//     tile pair), then scaled and cast by a second small kernel. The
//     order of that sum changes from run to run, so K9's dq is not
//     bitwise deterministic (the tests hold it to a tolerance); K7 + K8
//     use no atomics and are.

#include "flash_common.cuh"

namespace pt {
namespace flash {

// ---- K4: forward with LSE -------------------------------------------------

template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(T* __restrict__ out, float* __restrict__ lse,
                 const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 Shape sh) {
  constexpr int DP = D + 1;
  constexpr int NA = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;             // [kBQ][DP]
  float* k_s = q_s + kBQ * DP;   // [kBK][DP]
  float* v_s = k_s + kBK * DP;   // [kBK][DP]
  float* p_s = v_s + kBK * DP;   // [kBQ][kPP]
  float* b_s = p_s + kBQ * kPP;  // [kBK], HasBias only

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int64_t bh = static_cast<int64_t>(sh.bh0) + blockIdx.y;
  const T* kb = k + bh * sh.Sk * D;
  const T* vb = v + bh * sh.Sk * D;
  const float* brow = bias_row(bias, sh, bh);
  load_tile<T, D>(q_s, q + bh * sh.Sq * D, q0, sh.Sq, kBQ);

  // keys up to the causal horizon of the tile's last row; a tile that
  // holds a dead row scores every key (its rows average all of them)
  int kend = sh.Sk;
  if (sh.causal && q0 + sh.off >= 0)
    kend = min(sh.Sk, min(q0 + kBQ, sh.Sq) + sh.off);

  float m[kTR], l[kTR], acc[kTR][NA];
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[r][a] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's k_s / v_s / p_s reads are done
    load_tile<T, D>(k_s, kb, k0, sh.Sk, kBK);
    load_tile<T, D>(v_s, vb, k0, sh.Sk, kBK);
    if (HasBias) load_bias(b_s, brow, k0, sh.Sk);
    __syncthreads();
    float s[kTR][kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kTR], kv[kTC];
#pragma unroll
      for (int r = 0; r < kTR; ++r) qv[r] = q_s[(ty * kTR + r) * DP + d];
#pragma unroll
      for (int c = 0; c < kTC; ++c) kv[c] = k_s[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < kTR; ++r)
#pragma unroll
        for (int c = 0; c < kTC; ++c) s[r][c] += qv[r] * kv[c];
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int i = q0 + ty * kTR + r;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int j = k0 + tx + 16 * c;
        float x;
        if (j >= sh.Sk) {
          x = -INFINITY;                              // past the end: no weight
        } else if (!visible(sh, i, j)) {
          // a dead row averages every key (the reference's -1e30 fill);
          // a hidden key of any other row has no weight, below even a
          // key masked by a -1e30 bias
          x = dead_row(sh, i) ? kNegInf : -INFINITY;
        } else {
          x = s[r][c] * sh.scale;
          if (HasBias) x += b_s[tx + 16 * c];
        }
        s[r][c] = x;
        tmax = fmaxf(tmax, x);
      }
      const float m_new = fmaxf(m[r], row_max(tmax));
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const float p = expf(s[r][c] - m_new);
        p_s[(ty * kTR + r) * kPP + tx + 16 * c] = p;
        psum += p;
      }
      l[r] = l[r] * alpha + row_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[r][a] *= alpha;
    }
    __syncthreads();  // p_s is complete
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) pv[r] = p_s[(ty * kTR + r) * kPP + j];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float vv = v_s[j * DP + tx + 16 * a];
#pragma unroll
        for (int r = 0; r < kTR; ++r) acc[r][a] += pv[r] * vv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int i = q0 + ty * kTR + r;
    if (i >= sh.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* o = out + (bh * sh.Sq + i) * D;
#pragma unroll
    for (int a = 0; a < NA; ++a) o[tx + 16 * a] = from_f<T>(acc[r][a] * inv);
    if (tx == 0) lse[bh * sh.Sq + i] = m[r] + logf(l[r]);
  }
}

// ---- K6: delta = rowsum(dO * O) ---------------------------------------------
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_delta_rows` (483;
// its pallas_call at 493), body `_delta_kernel` (472). What bounds it on
// an H100: bytes. It reads o and dO once (2 FLOPs an element pair) and
// writes one float a row; at GPT-2 small's training shape (B 16, H 12,
// S 1024, D 64, bf16) 51 MB, 0.0153 ms at 3.35 TB/s. The design keeps
// enough loads in flight to stream them:
//   * 16-byte loads, neighbouring lanes on neighbouring addresses: a row
//     is kLanes = D * e / 16 lanes (bf16 D 64: 8 lanes, 4 rows a warp;
//     float32 D 128: a warp a row);
//   * each warp loads its kDeltaGroups row groups of o and dO (four
//     independent 16-byte loads a lane) before it sums any of them;
//   * a lane sums its elements in order into a float32, then its row's
//     lanes reduce over a fixed shuffle tree: the same bits on every run.

constexpr int kDeltaThreads = 256;
constexpr int kDeltaGroups = 2;  // row groups a warp loads before it sums

// The dot of two 16-byte chunks (4 float32, or 8 bf16 or float16), in
// element order.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b);
template <>
__device__ __forceinline__ float dot16<float>(const uint4& a,
                                              const uint4& b) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  float acc = x.x * y.x;
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// A pair of 16-bit elements as float2.
__device__ __forceinline__ float2 pair_f(const uint32_t& w, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 pair_f(const uint32_t& w, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = pair_f(wa[i], T{});
    const float2 y = pair_f(wb[i], T{});
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

template <typename T, int D>
struct DeltaGeo {
  static constexpr int kLanes = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kRowsPerWarp = 32 / kLanes;  // rows of a group
  static constexpr int kRowsPerBlock =
      kDeltaThreads / 32 * kDeltaGroups * kRowsPerWarp;
  static_assert(kLanes >= 1 && kLanes <= 32, "a row is 16..512 bytes");
};

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_delta_kernel(float* __restrict__ delta, const T* __restrict__ o,
                   const T* __restrict__ dout, int64_t rows) {
  using G = DeltaGeo<T, D>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int part = lane % G::kLanes;  // this lane's 16 bytes of a row
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * G::kRowsPerBlock +
                       warp * kDeltaGroups * G::kRowsPerWarp +
                       lane / G::kLanes;
  uint4 a[kDeltaGroups], b[kDeltaGroups];
#pragma unroll
  for (int u = 0; u < kDeltaGroups; ++u) {
    const int64_t row = row0 + u * G::kRowsPerWarp;
    a[u] = b[u] = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const int64_t at = row * D * static_cast<int64_t>(sizeof(T)) / 16 +
                         part;
      a[u] = __ldg(reinterpret_cast<const uint4*>(o) + at);
      b[u] = __ldg(reinterpret_cast<const uint4*>(dout) + at);
    }
  }
#pragma unroll
  for (int u = 0; u < kDeltaGroups; ++u) {
    float acc = dot16<T>(a[u], b[u]);
#pragma unroll
    for (int s = G::kLanes / 2; s > 0; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    const int64_t row = row0 + u * G::kRowsPerWarp;
    if (part == 0 && row < rows) delta[row] = acc;
  }
}

// ---- K9: fused backward -------------------------------------------------------

// K9 is the key-tile backward with dq (`bwd_key_tile<..., true>`, in
// flash_common.cuh, whose body K8 shares without the dq sums).
template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(float* __restrict__ dq_ws, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ dbias,
                 const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ bias, Shape sh) {
  extern __shared__ float smem[];
  bwd_key_tile<T, D, HasBias, true>(smem, dq_ws, dk, dv, dbias, q, k, v,
                                    dout, lse, delta, bias, sh);
}

// dq = scale * workspace, in the compute dtype.
template <typename T>
__global__ void scale_cast_kernel(T* __restrict__ dst,
                                  const float* __restrict__ src, int64_t n,
                                  float scale) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    dst[i] = from_f<T>(src[i] * scale);
}

// ---- host side -----------------------------------------------------------

template <typename T, int D, bool HasBias>
cudaError_t launch_fwd_as(void* out, float* lse, const void* q,
                          const void* k, const void* v, const float* bias,
                          int BH, Shape sh, cudaStream_t st) {
  constexpr int DP = D + 1;
  return launch_tiles(flash_fwd_kernel<T, D, HasBias>,
                      kBQ * DP + 2 * kBK * DP + kBQ * kPP +
                          (HasBias ? kBK : 0),
                      (sh.Sq + kBQ - 1) / kBQ, BH, sh, st,
                      static_cast<T*>(out), lse, static_cast<const T*>(q),
                      static_cast<const T*>(k), static_cast<const T*>(v),
                      bias);
}

template <typename T, int D>
cudaError_t launch_fwd(void* out, float* lse, const void* q, const void* k,
                       const void* v, const float* bias, int BH, Shape sh,
                       cudaStream_t st) {
  return bias ? launch_fwd_as<T, D, true>(out, lse, q, k, v, bias, BH, sh, st)
              : launch_fwd_as<T, D, false>(out, lse, q, k, v, bias, BH, sh,
                                           st);
}

template <typename T, int D>
cudaError_t launch_delta(float* delta, const void* o, const void* dout,
                         int64_t rows, cudaStream_t st) {
  constexpr int per_block = DeltaGeo<T, D>::kRowsPerBlock;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_delta_kernel<T, D>
      <<<static_cast<unsigned>(blocks), kDeltaThreads, 0, st>>>(
          delta, static_cast<const T*>(o), static_cast<const T*>(dout), rows);
  return cudaGetLastError();
}

template <typename T, int D, bool HasBias>
cudaError_t launch_bwd_kernel(void* dk, void* dv, float* dq_ws, float* dbias,
                              const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const float* bias, int BH,
                              Shape sh, cudaStream_t st) {
  return launch_tiles(
      flash_bwd_kernel<T, D, HasBias>, bwd_key_tile_smem_floats<D, HasBias>(),
      (sh.Sk + kBK - 1) / kBK, BH, sh, st, dq_ws, static_cast<T*>(dk),
      static_cast<T*>(dv), dbias, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, bias);
}

// dq = scale * dq_ws in T, after either K9.
template <typename T>
cudaError_t launch_scale_cast(void* dq, const float* dq_ws, int BH, int D,
                              Shape sh, cudaStream_t st) {
  const int64_t n = static_cast<int64_t>(BH) * sh.Sq * D;
  const int64_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  scale_cast_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<T*>(dq), dq_ws, n, sh.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(void* dq, void* dk, void* dv, float* dq_ws,
                       float* dbias, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, const float* bias, int BH,
                       Shape sh, cudaStream_t st) {
  cudaError_t e =
      bias ? launch_bwd_kernel<float, D, true>(dk, dv, dq_ws, dbias, q, k,
                                               v, dout, lse, delta, bias, BH,
                                               sh, st)
           : launch_bwd_kernel<float, D, false>(dk, dv, dq_ws, dbias, q, k,
                                                v, dout, lse, delta, bias,
                                                BH, sh, st);
  if (e != cudaSuccess) return e;
  return launch_scale_cast<float>(dq, dq_ws, BH, D, sh, st);
}

int fwd(void* out, float* lse, const void* q, const void* k, const void* v,
        const float* bias, int BH, int H, int Sq, int Sk, int D,
        int bias_bstride, float scale, int causal, int dtype,
        cudaStream_t st) {
  const Shape sh = make_shape(Sq, Sk, causal, scale, H, bias_bstride);
  if (dtype == kDtypeBf16 || dtype == kDtypeHalf)
    return fwd_sm90(out, lse, q, k, v, bias, BH, D, dtype, sh, st);
  cudaError_t e;  // float32: the SIMT kernel
  if (dtype == 0 && D == 32)
    e = launch_fwd<float, 32>(out, lse, q, k, v, bias, BH, sh, st);
  else if (dtype == 0 && D == 64)
    e = launch_fwd<float, 64>(out, lse, q, k, v, bias, BH, sh, st);
  else if (dtype == 0 && D == 128)
    e = launch_fwd<float, 128>(out, lse, q, k, v, bias, BH, sh, st);
  else
    return -1;
  return static_cast<int>(e);
}

int delta(float* dl, const void* o, const void* dout, int64_t rows, int D,
          int dtype, cudaStream_t st) {
  PT_FLASH_DISPATCH(launch_delta, dl, o, dout, rows, st);
}

int bwd(void* dq, void* dk, void* dv, float* dq_ws, float* dbias,
        const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* dl, const float* bias, int BH, int H,
        int Sq, int Sk, int D, int bias_bstride, float scale, int causal,
        int dtype, cudaStream_t st) {
  const Shape sh = make_shape(Sq, Sk, causal, scale, H, bias_bstride);
  if (dtype == kDtypeBf16 || dtype == kDtypeHalf) {
    // 16 bits: the tensor-core kernel, then the cast
    const int e = bwd_sm90(dk, dv, dq_ws, dbias, q, k, v, dout, lse, dl,
                           bias, BH, D, dtype, sh, st);
    if (e != 0) return e;
    return static_cast<int>(
        dtype == kDtypeHalf
            ? launch_scale_cast<__half>(dq, dq_ws, BH, D, sh, st)
            : launch_scale_cast<__nv_bfloat16>(dq, dq_ws, BH, D, sh, st));
  }
  cudaError_t e;  // float32: the SIMT kernel
  if (dtype == 0 && D == 32)
    e = launch_bwd<32>(dq, dk, dv, dq_ws, dbias, q, k, v, dout, lse, dl,
                       bias, BH, sh, st);
  else if (dtype == 0 && D == 64)
    e = launch_bwd<64>(dq, dk, dv, dq_ws, dbias, q, k, v, dout, lse, dl,
                       bias, BH, sh, st);
  else if (dtype == 0 && D == 128)
    e = launch_bwd<128>(dq, dk, dv, dq_ws, dbias, q, k, v, dout, lse, dl,
                        bias, BH, sh, st);
  else
    return -1;
  return static_cast<int>(e);
}

}  // namespace flash
}  // namespace pt

extern "C" {

// K4. q/out [BH, Sq, D], k/v [BH, Sk, D] (contiguous, 16-byte aligned),
// lse [BH, Sq] float32; bias NULL, or float32 rows of Sk read at
// (bh / H) * bias_bstride. Returns a cudaError_t value (0 = launched), or
// -1.
int pt_flash_fwd(void* out, void* lse, const void* q, const void* k,
                 const void* v, const void* bias, int BH, int H, int Sq,
                 int Sk, int D, int bias_bstride, float scale, int causal,
                 int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  return pt::flash::fwd(out, static_cast<float*>(lse), q, k, v,
                        static_cast<const float*>(bias), BH, H, Sq, Sk, D,
                        bias_bstride, scale, causal, dtype,
                        static_cast<cudaStream_t>(stream));
}

// K6. o/dout [rows, D]; delta [rows] float32.
int pt_flash_delta(void* delta, const void* o, const void* dout,
                   long long rows, int D, int dtype, void* stream) {
  if (rows <= 0) return 0;
  return pt::flash::delta(static_cast<float*>(delta), o, dout, rows, D, dtype,
                          static_cast<cudaStream_t>(stream));
}

// K9. q/dout/dq [BH, Sq, D], k/v/dk/dv [BH, Sk, D], lse/delta [BH, Sq]
// float32, dq_ws [BH, Sq, D] float32 and zeroed by the caller; bias as
// K4's, and with it dbias [BH, Sk] float32 (every entry written).
int pt_flash_bwd(void* dq, void* dk, void* dv, void* dq_ws, void* dbias,
                 const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* bias, int BH, int H, int Sq, int Sk, int D,
                 int bias_bstride, float scale, int causal, int dtype,
                 void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  return pt::flash::bwd(dq, dk, dv, static_cast<float*>(dq_ws),
                        static_cast<float*>(dbias), q, k, v, dout,
                        static_cast<const float*>(lse),
                        static_cast<const float*>(delta),
                        static_cast<const float*>(bias), BH, H, Sq, Sk, D,
                        bias_bstride, scale, causal, dtype,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
