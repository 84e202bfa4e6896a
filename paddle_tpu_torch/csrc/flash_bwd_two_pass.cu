// The two-pass flash backward, for Hopper (sm_90a).
//
// It replaces `_flash_bwd` of paddle_tpu/ops/pallas/flash_attention.py,
// the backward the reference takes for long sequences (`_fa_bwd` and
// `_fab_bwd` once sq * d * 10 > 8 MB; ring attention calls it on every
// ring block), in two kernels (their float32 SIMT forms here; in bfloat16
// the entries below send both to tensor-core kernels of their own units):
//   K7 `flash_bwd_dq_kernel`  <- `_bwd_dq_kernel` (pallas_call at :580):
//      dq = scale * sum_j ds_ij k_j, written in q's dtype;
//   K8 `flash_bwd_dkv_kernel` <- `_bwd_dkv_kernel` (pallas_call at :615):
//      dk = scale * sum_i ds_ij q_i, dv = sum_i p_ij dO_i in k/v's dtype,
//      and with a bias dbias [BH, Sk] float32, the column sums of ds.
// Both take q/dO [BH, Sq, D], k/v [BH, Sk, D], the forward's LSE and K6's
// delta ([BH, Sq] float32), and are templated on <T, D, HasBias> as K4 and
// K9 are (the per-key bias [B or 1, Sk] float32, row bh / H read in
// place). Masking, the bottom-right causal alignment, dead rows and fully
// masked rows are K9's (see flash_attention.cu): both kernels reach p and
// ds only through `tile_p_ds` (flash_common.cuh), which computes
// p = exp(s * scale + bias - lse) from the LSE it is GIVEN and never
// renormalises over the kernel's own keys — so a caller may pass the LSE
// (and the delta) of a larger attention, as ring attention passes the
// global ones while the kernels see one block of keys.
//
// What bounds them on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): K7
// does 6 * BH * D * (visible (i, j) pairs) FLOPs (s, dp and dq products),
// K8 8 * BH * D * pairs (s, dp, dv and dk); at GPT-2 training shapes both
// are bound by operations, as K9 (10 * BH * D * pairs) is. Splitting K9
// costs the two products K7 repeats (s and dp), and buys the loss of its
// atomics.
//
// What the design does about it:
//   * K7 is K4's loop: one block per q tile, q, dO, lse and delta loaded
//     once, key tiles streamed up to the causal horizon of the tile's last
//     row (a dead row, which sees no key, takes no gradient); dq sums in
//     float32 registers and is written once as dq * scale — no workspace
//     and no second cast kernel. In bfloat16 `bwd_dq` sends it to
//     flash_bwd_dq_sm90.cu's `flash_bwd_dq_sm90_kernel`, K4's tensor-core
//     loop (wgmma products, TMA loads through an mbarrier ring) with dS.K
//     in place of P.V. In float32 it is `flash_bwd_dq_kernel` here, in
//     SIMT products as the float32 K4 and K9: one block per (64-row q
//     tile, bh).
//   * K8 is K9 without its dq. In bfloat16 `bwd_dkv` sends it to
//     flash_bwd_sm90.cu's `flash_bwd_dkv_sm90_kernel`, the bf16 K9's
//     tensor-core body (wgmma products, TMA loads through an mbarrier
//     ring) without its dQ path. In float32 it is the SIMT K9 without its
//     dq atomics (`bwd_key_tile<float, D, HasBias, false>`): one block per
//     (64-key tile, bh), k, v and the bias tile loaded once, q tiles
//     streamed from the first that reaches the key tile; dk, dv and the
//     dbias column sums stay in registers and are written once.
//   * Every output element is owned by one block and summed in one fixed
//     order, so K7 and K8 are bitwise reproducible from run to run (K9's
//     dq, summed with atomics or bulk reductions, is not), and the bf16
//     K8's dk, dv and dbias equal the bf16 K9's bit for bit.

#include "flash_common.cuh"

namespace pt {
namespace flash {

// ---- K7: dq ------------------------------------------------------------------

template <int D, bool HasBias>
constexpr int dq_smem_floats() {
  return 2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * kPP +
         (HasBias ? kBK : 0);
}

template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(T* __restrict__ dq, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, Shape sh) {
  constexpr int DP = D + 1;
  constexpr int NA = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;   // [kBQ][DP]
  float* k_s = do_s + kBQ * DP;   // [kBK][DP]
  float* v_s = k_s + kBK * DP;    // [kBK][DP]
  float* ds_s = v_s + kBK * DP;   // [kBQ][kPP]
  float* b_s = ds_s + kBQ * kPP;  // [kBK], HasBias only

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int64_t bh = static_cast<int64_t>(sh.bh0) + blockIdx.y;
  const T* kb = k + bh * sh.Sk * D;
  const T* vb = v + bh * sh.Sk * D;
  const float* brow = bias_row(bias, sh, bh);
  load_tile<T, D>(q_s, q + bh * sh.Sq * D, q0, sh.Sq, kBQ);
  load_tile<T, D>(do_s, dout + bh * sh.Sq * D, q0, sh.Sq, kBQ);

  // this thread's rows ty*kTR + r: their lse and delta, and dq columns
  // tx + 16a
  float lse_r[kTR], dl_r[kTR], acc[kTR][NA];
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int i = q0 + ty * kTR + r;
    lse_r[r] = i < sh.Sq ? lse[bh * sh.Sq + i] : 0.f;
    dl_r[r] = i < sh.Sq ? delta[bh * sh.Sq + i] : 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[r][a] = 0.f;
  }

  // keys up to the causal horizon of the tile's last row (none when every
  // row of the tile is dead)
  int kend = sh.Sk;
  if (sh.causal) kend = max(0, min(sh.Sk, min(q0 + kBQ, sh.Sq) + sh.off));

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous key tile's k_s / v_s / ds_s reads are done
    load_tile<T, D>(k_s, kb, k0, sh.Sk, kBK);
    load_tile<T, D>(v_s, vb, k0, sh.Sk, kBK);
    if (HasBias) load_bias(b_s, brow, k0, sh.Sk);
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
                           HasBias ? b_s[col] : 0.f, dp[r][c], lse_r[r],
                           dl_r[r], p, ds);
        ds_s[row * kPP + col] = ds;
      }
    }
    __syncthreads();  // ds_s is complete

    // dq_i += ds_ij k_j
#pragma unroll 4
    for (int kc = 0; kc < kBK; ++kc) {
      float dsv[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) dsv[r] = ds_s[(ty * kTR + r) * kPP + kc];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float kv = k_s[kc * DP + tx + 16 * a];
#pragma unroll
        for (int r = 0; r < kTR; ++r) acc[r][a] += dsv[r] * kv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int i = q0 + ty * kTR + r;
    if (i >= sh.Sq) continue;
    T* o = dq + (bh * sh.Sq + i) * D;
#pragma unroll
    for (int a = 0; a < NA; ++a)
      o[tx + 16 * a] = from_f<T>(acc[r][a] * sh.scale);
  }
}

// ---- K8: dk, dv (and dbias) ----------------------------------------------------

template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dbias, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, Shape sh) {
  extern __shared__ float smem[];
  bwd_key_tile<T, D, HasBias, false>(smem, nullptr, dk, dv, dbias, q, k, v,
                                     dout, lse, delta, bias, sh);
}

// ---- host side -----------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq(void* dq, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* bias, int BH, Shape sh, cudaStream_t st) {
  const int tiles = (sh.Sq + kBQ - 1) / kBQ;
  if (bias)
    return launch_tiles(flash_bwd_dq_kernel<T, D, true>,
                        dq_smem_floats<D, true>(), tiles, BH, sh, st,
                        static_cast<T*>(dq), static_cast<const T*>(q),
                        static_cast<const T*>(k), static_cast<const T*>(v),
                        static_cast<const T*>(dout), lse, delta, bias);
  return launch_tiles(flash_bwd_dq_kernel<T, D, false>,
                      dq_smem_floats<D, false>(), tiles, BH, sh, st,
                      static_cast<T*>(dq), static_cast<const T*>(q),
                      static_cast<const T*>(k), static_cast<const T*>(v),
                      static_cast<const T*>(dout), lse, delta, bias);
}

template <typename T, int D>
cudaError_t launch_dkv(void* dk, void* dv, float* dbias, const void* q,
                       const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta,
                       const float* bias, int BH, Shape sh,
                       cudaStream_t st) {
  const int tiles = (sh.Sk + kBK - 1) / kBK;
  if (bias)
    return launch_tiles(flash_bwd_dkv_kernel<T, D, true>,
                        bwd_key_tile_smem_floats<D, true>(), tiles, BH, sh,
                        st, static_cast<T*>(dk), static_cast<T*>(dv), dbias,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v),
                        static_cast<const T*>(dout), lse, delta, bias);
  return launch_tiles(flash_bwd_dkv_kernel<T, D, false>,
                      bwd_key_tile_smem_floats<D, false>(), tiles, BH, sh,
                      st, static_cast<T*>(dk), static_cast<T*>(dv), dbias,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(dout),
                      lse, delta, bias);
}

int bwd_dq(void* dq, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* dl,
           const float* bias, int BH, int H, int Sq, int Sk, int D,
           int bias_bstride, float scale, int causal, int dtype,
           cudaStream_t st) {
  const Shape sh = make_shape(Sq, Sk, causal, scale, H, bias_bstride);
  if (dtype == 1)  // bfloat16: the tensor-core kernel of flash_bwd_dq_sm90.cu
    return bwd_dq_sm90(dq, q, k, v, dout, lse, dl, bias, BH, D, sh, st);
  cudaError_t e;  // float32: the SIMT kernel
  if (dtype == 0 && D == 32)
    e = launch_dq<float, 32>(dq, q, k, v, dout, lse, dl, bias, BH, sh, st);
  else if (dtype == 0 && D == 64)
    e = launch_dq<float, 64>(dq, q, k, v, dout, lse, dl, bias, BH, sh, st);
  else if (dtype == 0 && D == 128)
    e = launch_dq<float, 128>(dq, q, k, v, dout, lse, dl, bias, BH, sh, st);
  else
    return -1;
  return static_cast<int>(e);
}

int bwd_dkv(void* dk, void* dv, float* dbias, const void* q, const void* k,
            const void* v, const void* dout, const float* lse,
            const float* dl, const float* bias, int BH, int H, int Sq, int Sk,
            int D, int bias_bstride, float scale, int causal, int dtype,
            cudaStream_t st) {
  const Shape sh = make_shape(Sq, Sk, causal, scale, H, bias_bstride);
  if (dtype == 1)  // bfloat16: the tensor-core kernel of flash_bwd_sm90.cu
    return bwd_dkv_sm90(dk, dv, dbias, q, k, v, dout, lse, dl, bias, BH, D,
                        sh, st);
  cudaError_t e;  // float32: the SIMT kernel
  if (dtype == 0 && D == 32)
    e = launch_dkv<float, 32>(dk, dv, dbias, q, k, v, dout, lse, dl, bias,
                              BH, sh, st);
  else if (dtype == 0 && D == 64)
    e = launch_dkv<float, 64>(dk, dv, dbias, q, k, v, dout, lse, dl, bias,
                              BH, sh, st);
  else if (dtype == 0 && D == 128)
    e = launch_dkv<float, 128>(dk, dv, dbias, q, k, v, dout, lse, dl, bias,
                               BH, sh, st);
  else
    return -1;
  return static_cast<int>(e);
}

}  // namespace flash
}  // namespace pt

extern "C" {

// K7. q/dout/dq [BH, Sq, D], k/v [BH, Sk, D] (contiguous, 16-byte
// aligned), lse/delta [BH, Sq] float32; bias NULL, or float32 rows of Sk
// read at (bh / H) * bias_bstride. Every entry of dq is written. Returns
// a cudaError_t value (0 = launched), or -1.
int pt_flash_bwd_dq(void* dq, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* bias, int BH, int H, int Sq, int Sk, int D,
                    int bias_bstride, float scale, int causal, int dtype,
                    void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  return pt::flash::bwd_dq(dq, q, k, v, dout, static_cast<const float*>(lse),
                           static_cast<const float*>(delta),
                           static_cast<const float*>(bias), BH, H, Sq, Sk, D,
                           bias_bstride, scale, causal, dtype,
                           static_cast<cudaStream_t>(stream));
}

// K8. As K7, writing dk/dv [BH, Sk, D] and, with a bias, dbias [BH, Sk]
// float32 (every entry written).
int pt_flash_bwd_dkv(void* dk, void* dv, void* dbias, const void* q,
                     const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* bias,
                     int BH, int H, int Sq, int Sk, int D, int bias_bstride,
                     float scale, int causal, int dtype, void* stream) {
  if (BH <= 0 || Sk <= 0) return 0;
  return pt::flash::bwd_dkv(dk, dv, static_cast<float*>(dbias), q, k, v, dout,
                            static_cast<const float*>(lse),
                            static_cast<const float*>(delta),
                            static_cast<const float*>(bias), BH, H, Sq, Sk, D,
                            bias_bstride, scale, causal, dtype,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
