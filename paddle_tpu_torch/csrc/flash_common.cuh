// What the flash-attention kernels share: the tile geometry, the shape and
// masking rules, the tile loader, the backward's tile math (`tile_p_ds`),
// the body of the SIMT key-tile backward (K9 with dq, K8 without), the
// host entries of the 16-bit (bf16 and float16) tensor-core kernels and
// the (dtype, D) dispatch of the C entry points. flash_attention.cu (K4,
// K6, K9) and flash_bwd_two_pass.cu (K7, K8) include it, and through
// flash_sm90.cuh flash_fwd_sm90.cu (K4 in bf16 and float16),
// flash_bwd_sm90.cu (K9 and K8) and flash_bwd_dq_sm90.cu (K7); each
// compiles in its own nvcc process. See flash_attention.cu for the
// masking semantics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "elem.cuh"

namespace pt {
namespace flash {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kTR = kBQ / 16;  // score rows per thread
constexpr int kTC = kBK / 16;  // score columns per thread
constexpr int kPP = kBK + 1;   // pitch of the score tiles in shared memory
// The dtype codes of the C entry points (ops/kernels.py DTYPE_CODES).
constexpr int kDtypeFloat = 0, kDtypeBf16 = 1, kDtypeHalf = 2;
// A row's LSE at or below this marks it fully masked.
constexpr float kMaskedLse = -1e29f;

struct Shape {
  int Sq, Sk;
  int off;  // Sk - Sq: the bottom-right causal alignment
  int causal;
  float scale;
  int H;             // heads: block bh reads bias row bh / H
  int bias_bstride;  // Sk, or 0 for one bias row broadcast over the batch
  int bh0;  // the first bh of a SIMT launch (bh = bh0 + blockIdx.y)
};

inline Shape make_shape(int Sq, int Sk, int causal, float scale, int H,
                        int bias_bstride) {
  return Shape{Sq, Sk, Sk - Sq, causal, scale, H, bias_bstride, 0};
}

__device__ __forceinline__ bool visible(const Shape& sh, int i, int j) {
  return !sh.causal || j <= i + sh.off;
}

// A query row that sees no key at all (causal with Sq > Sk).
__device__ __forceinline__ bool dead_row(const Shape& sh, int i) {
  return sh.causal && i + sh.off < 0;
}

// How many keys query row i sees (>= 1 unless the row is dead).
__device__ __forceinline__ int visible_keys(const Shape& sh, int i) {
  return sh.causal ? min(sh.Sk, i + sh.off + 1) : sh.Sk;
}

// The bias row of block bh (nullptr without a bias).
__device__ __forceinline__ const float* bias_row(const float* bias,
                                                 const Shape& sh,
                                                 int64_t bh) {
  return bias ? bias + (bh / sh.H) * sh.bias_bstride : nullptr;
}

// Rows r0 .. r0+rows-1 of a [S, D] matrix into shared memory as float
// (pitch D + 1), zeros past row S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, int rows) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < rows * D / 4; i += kThreads) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) v = load4(src + static_cast<int64_t>(r0 + r) * D + d);
    float* o = dst + r * DP + d;
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
}

// Keys k0 .. k0+kBK-1 of a bias row into shared memory, zeros past Sk.
__device__ __forceinline__ void load_bias(float* dst, const float* brow,
                                          int k0, int Sk) {
  if (threadIdx.x < kBK)
    dst[threadIdx.x] = k0 + threadIdx.x < Sk ? brow[k0 + threadIdx.x] : 0.f;
}

// Reductions over the 16 threads of one score row (16 consecutive lanes).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The backward's tile math for score (i, j), in one place (the TPU
// kernels' `_tile_p_ds`): p = exp(s * scale + bias_j - lse) from the
// LSE it is given (never renormalised over the block's own keys, so a
// caller may pass a global LSE) and ds = p * (dp - delta), where s =
// q_i.k_j and dp = dO_i.v_j. Masked and out-of-range entries get p = ds =
// 0; a dead row gets the uniform p = 1 / Sk of the reference's constant
// fill and ds = 0; a fully masked row (lse <= kMaskedLse) gets p = 1 /
// (keys it sees) and the usual ds.
template <bool HasBias>
__device__ __forceinline__ void tile_p_ds(const Shape& sh, int i, int j,
                                          float s, float bias, float dp,
                                          float lse, float delta, float& p,
                                          float& ds) {
  if (i >= sh.Sq || j >= sh.Sk) {
    p = 0.f;
    ds = 0.f;
  } else if (dead_row(sh, i)) {
    p = 1.f / static_cast<float>(sh.Sk);
    ds = 0.f;
  } else if (!visible(sh, i, j)) {
    p = 0.f;
    ds = 0.f;
  } else {
    if (lse <= kMaskedLse)
      p = 1.f / static_cast<float>(visible_keys(sh, i));
    else
      p = HasBias ? expf(s * sh.scale + bias - lse) : expf(s * sh.scale - lse);
    ds = p * (dp - delta);
  }
}

// The scores s = q.k and dp = dO.v of this thread's 4 x 4 micro-tile:
// rows ty*kTR + r of the q/dO tiles, keys tx + 16c of the k/v tiles.
template <int D>
__device__ __forceinline__ void score_tiles(const float* q_s,
                                            const float* do_s,
                                            const float* k_s,
                                            const float* v_s, int ty, int tx,
                                            float (&s)[kTR][kTC],
                                            float (&dp)[kTR][kTC]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int c = 0; c < kTC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[kTR], dov[kTR], kv[kTC], vv[kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      qv[r] = q_s[(ty * kTR + r) * DP + d];
      dov[r] = do_s[(ty * kTR + r) * DP + d];
    }
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      kv[c] = k_s[(tx + 16 * c) * DP + d];
      vv[c] = v_s[(tx + 16 * c) * DP + d];
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        s[r][c] += qv[r] * kv[c];
        dp[r][c] += dov[r] * vv[c];
      }
  }
}

// ---- the key-tile backward: K9 (WithDq) and K8 ------------------------------

// Shared memory of `bwd_key_tile`, in floats.
template <int D, bool HasBias>
constexpr int bwd_key_tile_smem_floats() {
  return 2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBQ * kPP + 2 * kBQ +
         (HasBias ? kBK : 0);
}

// One block's work for key tile blockIdx.x of row bh = bh0 + blockIdx.y: loop
// over the q tiles from the first that reaches the key tile, with dk, dv
// (and the column sums of ds, dbias) in registers, written once at the
// end. WithDq (K9) also sums dq_i += ds k_j into the float32 workspace
// dq_ws with atomics, across key tiles; without it (K8) the block writes
// nothing but its own key tile, so the result is bitwise reproducible.
template <typename T, int D, bool HasBias, bool WithDq>
__device__ __forceinline__ void bwd_key_tile(
    float* smem, float* __restrict__ dq_ws, T* __restrict__ dk,
    T* __restrict__ dv, float* __restrict__ dbias, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ bias,
    const Shape& sh) {
  constexpr int DP = D + 1;
  constexpr int NA = D / 16;
  float* k_s = smem;               // [kBK][DP]
  float* v_s = k_s + kBK * DP;     // [kBK][DP]
  float* q_s = v_s + kBK * DP;     // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;    // [kBQ][DP]
  float* p_s = do_s + kBQ * DP;    // [kBQ][kPP]
  float* ds_s = p_s + kBQ * kPP;   // [kBQ][kPP]
  float* lse_s = ds_s + kBQ * kPP; // [kBQ]
  float* dl_s = lse_s + kBQ;       // [kBQ]
  float* b_s = dl_s + kBQ;         // [kBK], HasBias only

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * kBK;
  const int64_t bh = static_cast<int64_t>(sh.bh0) + blockIdx.y;
  const T* qb = q + bh * sh.Sq * D;
  const T* dob = dout + bh * sh.Sq * D;
  load_tile<T, D>(k_s, k + bh * sh.Sk * D, k0, sh.Sk, kBK);
  load_tile<T, D>(v_s, v + bh * sh.Sk * D, k0, sh.Sk, kBK);
  if (HasBias) load_bias(b_s, bias_row(bias, sh, bh), k0, sh.Sk);

  // the first q tile that reaches key k0 (query i sees it iff
  // i >= k0 - off); with Sq > Sk the dead rows join every key tile
  int qstart = 0;
  if (sh.causal && sh.off >= 0) qstart = max(0, k0 - sh.off) / kBQ * kBQ;

  // this thread's keys ty*kTR + r and dims tx + 16a; db_acc: the column
  // sums of ds for those keys (every tx of a ty sums the same column)
  float dk_acc[kTR][NA], dv_acc[kTR][NA], db_acc[kTR];
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    db_acc[r] = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) dk_acc[r][a] = dv_acc[r][a] = 0.f;
  }

  for (int q0 = qstart; q0 < sh.Sq; q0 += kBQ) {
    __syncthreads();  // the previous q tile's reads are done
    load_tile<T, D>(q_s, qb, q0, sh.Sq, kBQ);
    load_tile<T, D>(do_s, dob, q0, sh.Sq, kBQ);
    if (tid < kBQ) {
      const bool in = q0 + tid < sh.Sq;
      lse_s[tid] = in ? lse[bh * sh.Sq + q0 + tid] : 0.f;
      dl_s[tid] = in ? delta[bh * sh.Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[kTR][kTC], dp[kTR][kTC];
    score_tiles<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int row = ty * kTR + r;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int col = tx + 16 * c;
        float p, ds;
        tile_p_ds<HasBias>(sh, q0 + row, k0 + col, s[r][c],
                           HasBias ? b_s[col] : 0.f, dp[r][c], lse_s[row],
                           dl_s[row], p, ds);
        p_s[row * kPP + col] = p;
        ds_s[row * kPP + col] = ds;
      }
    }
    __syncthreads();  // p_s / ds_s are complete

    // dv_j += p^T dO_i and dk_j += ds^T q_i
#pragma unroll 4
    for (int qr = 0; qr < kBQ; ++qr) {
      float pv[kTR], dsv[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        pv[r] = p_s[qr * kPP + ty * kTR + r];
        dsv[r] = ds_s[qr * kPP + ty * kTR + r];
        if (HasBias) db_acc[r] += dsv[r];
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float dov = do_s[qr * DP + tx + 16 * a];
        const float qv = q_s[qr * DP + tx + 16 * a];
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          dv_acc[r][a] += pv[r] * dov;
          dk_acc[r][a] += dsv[r] * qv;
        }
      }
    }

    if constexpr (WithDq) {
      // dq_i += ds k_j for this thread's queries ty*kTR + r, summed across
      // key tiles in the float32 workspace
      float dqa[kTR][NA];
#pragma unroll
      for (int r = 0; r < kTR; ++r)
#pragma unroll
        for (int a = 0; a < NA; ++a) dqa[r][a] = 0.f;
#pragma unroll 4
      for (int kc = 0; kc < kBK; ++kc) {
        float dsv[kTR];
#pragma unroll
        for (int r = 0; r < kTR; ++r) dsv[r] = ds_s[(ty * kTR + r) * kPP + kc];
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const float kv = k_s[kc * DP + tx + 16 * a];
#pragma unroll
          for (int r = 0; r < kTR; ++r) dqa[r][a] += dsv[r] * kv;
        }
      }
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const int i = q0 + ty * kTR + r;
        if (i >= sh.Sq) continue;
        float* dst = dq_ws + (bh * sh.Sq + i) * D;
#pragma unroll
        for (int a = 0; a < NA; ++a) atomicAdd(dst + tx + 16 * a, dqa[r][a]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int j = k0 + ty * kTR + r;
    if (j >= sh.Sk) continue;
    const int64_t base = (bh * sh.Sk + j) * D;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      dk[base + tx + 16 * a] = from_f<T>(dk_acc[r][a] * sh.scale);
      dv[base + tx + 16 * a] = from_f<T>(dv_acc[r][a]);
    }
    if (HasBias && tx == 0) dbias[bh * sh.Sk + j] = db_acc[r];
  }
}

// Grid y of a launch holds at most this many bh.
constexpr int kMaxGridY = 65535;

// Sets a kernel's dynamic shared memory limit and launches it on a
// (tiles, BH) grid, as launches of at most kMaxGridY bh each (the shape's
// bh0 tells a launch its first bh; the kernel takes the shape last), so
// any B * H is taken; returns the first launch error.
template <typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kern, int floats, int tiles, int BH,
                         Shape sh, cudaStream_t st, Args... args) {
  const size_t smem = sizeof(float) * static_cast<size_t>(floats);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  for (int bh0 = 0; bh0 < BH; bh0 += kMaxGridY) {
    sh.bh0 = bh0;
    const int n = BH - bh0 < kMaxGridY ? BH - bh0 : kMaxGridY;
    kern<<<dim3(tiles, n), kThreads, smem, st>>>(args..., sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// K4 (bias with a non-null bias) on the tensor cores (flash_fwd_sm90.cu)
// in bfloat16, or float16 when dtype is kDtypeHalf (the same for the
// entries below). Returns a cudaError_t value, or -1 for a D other than
// 32, 64 or 128.
int fwd_sm90(void* out, float* lse, const void* q, const void* k,
             const void* v, const float* bias, int BH, int D, int dtype,
             Shape sh, cudaStream_t st);

// K9 (bias with a non-null bias) on the tensor cores
// (flash_bwd_sm90.cu): dk, dv, dbias, and dq summed into the zeroed
// float32 workspace dq_ws (unscaled); a null dq_ws launches K8 instead
// (`bwd_dkv_sm90`). Returns a cudaError_t value, or -1 for a D other than
// 32, 64 or 128.
int bwd_sm90(void* dk, void* dv, float* dq_ws, float* dbias, const void* q,
             const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const float* bias,
             int BH, int D, int dtype, Shape sh, cudaStream_t st);

// K8 (bias with a non-null bias) on the tensor cores
// (flash_bwd_sm90.cu): K9's body without its dq, writing dk, dv and dbias.
// Returns a cudaError_t value, or -1 for a D other than 32, 64 or 128.
int bwd_dkv_sm90(void* dk, void* dv, float* dbias, const void* q,
                 const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const float* bias,
                 int BH, int D, int dtype, Shape sh, cudaStream_t st);

// K7 (bias with a non-null bias) on the tensor cores
// (flash_bwd_dq_sm90.cu): dq = scale * dS.K, written once in the inputs'
// dtype.
// Returns a cudaError_t value, or -1 for a D other than 32, 64 or 128.
int bwd_dq_sm90(void* dq, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const float* bias, int BH, int D, int dtype, Shape sh,
                cudaStream_t st);

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns -1 for an
// unsupported (dtype, D) pair; the Python wrapper checks both before
// calling.
#define PT_FLASH_DISPATCH(LAUNCH, ...)                                 \
  do {                                                                 \
    cudaError_t e;                                                     \
    if (dtype == 0 && D == 32) e = LAUNCH<float, 32>(__VA_ARGS__);     \
    else if (dtype == 0 && D == 64) e = LAUNCH<float, 64>(__VA_ARGS__); \
    else if (dtype == 0 && D == 128)                                   \
      e = LAUNCH<float, 128>(__VA_ARGS__);                             \
    else if (dtype == 1 && D == 32)                                    \
      e = LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);                      \
    else if (dtype == 1 && D == 64)                                    \
      e = LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                      \
    else if (dtype == 1 && D == 128)                                   \
      e = LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                     \
    else if (dtype == 2 && D == 32)                                    \
      e = LAUNCH<__half, 32>(__VA_ARGS__);                             \
    else if (dtype == 2 && D == 64)                                    \
      e = LAUNCH<__half, 64>(__VA_ARGS__);                             \
    else if (dtype == 2 && D == 128)                                   \
      e = LAUNCH<__half, 128>(__VA_ARGS__);                            \
    else                                                               \
      return -1;                                                       \
    return static_cast<int>(e);                                        \
  } while (0)

}  // namespace flash
}  // namespace pt
