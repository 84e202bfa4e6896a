// The ragged-stream attention kernel of the serving path in float32, for
// Hopper (sm_90a), and the C entry of K1 in both dtypes: bfloat16 goes to
// the tensor-core kernel of ragged_stream_sm90.cu. K2, the paged decode
// kernel, is paged_decode_sm90.cu.
//
// K1 `ragged_stream_kernel` replaces the TPU kernel
//   paddle_tpu/ops/pallas/unified_attention.py
//   `unified_ragged_attention_kernel` (body `_stream_kernel`):
//   segment-causal attention of a token-packed stream q [T, H, Dh] against
//   one layer's paged pool. Row t carries (seg[t], pos[t]) and attends the
//   keys of table row seg[t] at cache positions 0..pos[t]; pad rows
//   (pos < 0, or seg outside [0, B)) attend nothing and come out as zeros.
// It reads the pool through the K3 loader in kv_load.cuh, dense or int8
// (per-vector scales, dequantized in registers). It is the float32 K1
// only: TF32 tensor-core products would not hold float32 parity (phase 4
// of chip_smoke.py runs the decoder in float32 through it), so it stays a
// SIMT kernel, as the float32 K4, K7, K8 and K9 do.
//
// What bounds it on an H100 (3.35 TB/s HBM, 67 TFLOP/s float32 outside
// the tensor cores): K1 does 4 * H * Dh * sum_t (pos_t + 1) FLOPs over
// the K/V of each segment's horizon; a prefill chunk of n tokens reuses
// every key n times, so a long chunk is FLOP-bound and a short one
// byte-bound.
//
// What the design does about it (f32 SIMT math):
//   * The kernel does not walk the padded table width: K1 loops only up
//     to each segment's causal horizon. The TPU grid visits every (tile,
//     block) pair and predicates the dead ones off.
//   * K1 takes the per-token seg/pos the op already receives, so it needs
//     no packing contract: a 16-row query tile that mixes segments runs
//     one pass per segment, and each K/V tile it loads into shared memory
//     serves all 16 rows of that segment (16x reuse of the bytes read).
//   * Every pool vector is read with 4-lane vector loads, dequantized in
//     registers; no gathered or dequantized copy of the pool exists.
//   * Scores, the running max m, the sum l and the accumulator stay in
//     f32 (online softmax, -1e30 masking as the TPU kernels); the output
//     is acc / max(l, 1e-30), so pad rows flush finite zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "kv_load.cuh"

namespace pt {

constexpr int kThreads = 128;

// ---- K1: ragged-stream attention ---------------------------------------

constexpr int kQT = 16;    // query rows per block
constexpr int kTK = 32;    // keys per shared-memory tile
constexpr int kGroup = 8;  // threads per query row (kQT * kGroup == 128)

template <typename T, typename KV, bool QUANT, int DH>
__global__ void __launch_bounds__(kThreads)
ragged_stream_kernel(T* __restrict__ out, const T* __restrict__ q,
                     PagedPool<KV, T, QUANT> kp, PagedPool<KV, T, QUANT> vp,
                     const int* __restrict__ seg, const int* __restrict__ pos,
                     int n_tok, int n_rows, float scale) {
  constexpr int DP = DH + 1;  // padded pitch: conflict-free column reads
  constexpr int NA = DH / kGroup;  // output lanes per thread
  constexpr int NK = kTK / kGroup;  // scores per thread per tile
  __shared__ float q_s[kQT][DP];
  __shared__ float k_s[kTK][DP];
  __shared__ float v_s[kTK][DP];
  __shared__ float p_s[kQT][kTK + 1];
  __shared__ int64_t slot_s[kTK];
  __shared__ int seg_s[kQT], pos_s[kQT], done_s[kQT];
  __shared__ int cur_seg, horizon;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int H = kp.H;
  const int r = tid / kGroup;  // this thread's query row in the tile
  const int g = tid % kGroup;  // its lane in the row's group
  // the row's 8 threads are 8 consecutive lanes of one warp; only they
  // take part in the row's shuffles (other rows may skip a tile)
  const unsigned gmask = 0xffu << (tid & 31 & ~(kGroup - 1));

  if (tid < kQT) {
    const int t = t0 + tid;
    int sg = -1, ps = -1;
    if (t < n_tok) {
      sg = seg[t];
      ps = pos[t];
    }
    if (sg < 0 || sg >= n_rows || ps < 0) {  // pad row: attends nothing
      sg = -1;
      ps = -1;
    }
    seg_s[tid] = sg;
    pos_s[tid] = ps;
    done_s[tid] = sg < 0;
  }
  for (int i = tid; i < kQT * DH / 4; i += kThreads) {
    const int rr = i / (DH / 4), d = (i % (DH / 4)) * 4;
    const int t = t0 + rr;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < n_tok) v = load4(q + (static_cast<int64_t>(t) * H + h) * DH + d);
    q_s[rr][d] = v.x; q_s[rr][d + 1] = v.y;
    q_s[rr][d + 2] = v.z; q_s[rr][d + 3] = v.w;
  }
  __syncthreads();

  const int my_seg = seg_s[r];
  const int my_pos = pos_s[r];
  const int cap = kp.M * kp.BS - 1;  // the table reaches no further
  float m = kNegInf, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;

  while (true) {
    // next pass: the segment of the first unprocessed row, run up to the
    // largest position any of the tile's rows of that segment holds
    if (tid == 0) {
      int s = -1, hz = -1;
      for (int i = 0; i < kQT; ++i) {
        if (!done_s[i]) {
          s = seg_s[i];
          break;
        }
      }
      if (s >= 0) {
        for (int i = 0; i < kQT; ++i) {
          if (seg_s[i] == s) {
            hz = max(hz, pos_s[i]);
            done_s[i] = 1;
          }
        }
      }
      cur_seg = s;
      horizon = min(hz, cap);
    }
    __syncthreads();
    const int cs = cur_seg, hz = horizon;
    if (cs < 0) break;
    const bool active = my_seg == cs;
    for (int k0 = 0; k0 <= hz; k0 += kTK) {
      if (tid < kTK) {
        const int kpos = k0 + tid;
        slot_s[tid] = kpos <= hz ? kp.slot(cs, kpos) : -1;
      }
      __syncthreads();
      for (int i = tid; i < kTK * DH / 4; i += kThreads) {
        const int j = i / (DH / 4), d = (i % (DH / 4)) * 4;
        const int64_t s = slot_s[j];
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 vv = kv;
        if (s >= 0) {
          kv = kp.load4(s, h, d);
          vv = vp.load4(s, h, d);
        }
        k_s[j][d] = kv.x; k_s[j][d + 1] = kv.y;
        k_s[j][d + 2] = kv.z; k_s[j][d + 3] = kv.w;
        v_s[j][d] = vv.x; v_s[j][d + 1] = vv.y;
        v_s[j][d + 2] = vv.z; v_s[j][d + 3] = vv.w;
      }
      __syncthreads();
      if (active && k0 <= my_pos) {
        float sc[NK];
#pragma unroll
        for (int c = 0; c < NK; ++c) sc[c] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          const float qd = q_s[r][d];
#pragma unroll
          for (int c = 0; c < NK; ++c) sc[c] += qd * k_s[g + kGroup * c][d];
        }
        float tmax = kNegInf;
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          const bool ok = k0 + g + kGroup * c <= my_pos;
          sc[c] = ok ? sc[c] * scale : kNegInf;
          tmax = fmaxf(tmax, sc[c]);
        }
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(gmask, tmax, o));
        const float m_new = fmaxf(m, tmax);
        const float alpha = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          const bool ok = k0 + g + kGroup * c <= my_pos;
          const float p = ok ? expf(sc[c] - m_new) : 0.f;
          p_s[r][g + kGroup * c] = p;
          psum += p;
        }
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1)
          psum += __shfl_xor_sync(gmask, psum, o);
        l = l * alpha + psum;
        m = m_new;
        __syncwarp(gmask);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const int d = g + kGroup * a;
          float o = acc[a] * alpha;
#pragma unroll 8
          for (int j = 0; j < kTK; ++j) o += p_s[r][j] * v_s[j][d];
          acc[a] = o;
        }
      }
      __syncthreads();
    }
    __syncthreads();  // every thread has read cur_seg before it changes
  }

  const int t = t0 + r;
  if (t < n_tok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + (static_cast<int64_t>(t) * H + h) * DH;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int d = g + kGroup * a;
      o[d] = from_f<T>(acc[a] * inv);
    }
  }
}

// ---- host side -----------------------------------------------------------

template <typename T, typename KV, bool QUANT>
PagedPool<KV, T, QUANT> make_pool(const void* data, const void* scales,
                                  const int* tables, int N, int BS, int H,
                                  int Dh, int M) {
  PagedPool<KV, T, QUANT> p;
  p.data = static_cast<const KV*>(data);
  p.scales = static_cast<const T*>(scales);
  p.tables = tables;
  p.N = N; p.BS = BS; p.H = H; p.Dh = Dh; p.M = M;
  return p;
}

template <typename T, typename KV, bool QUANT, int DH>
void launch_stream(void* out, const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const int* tables,
                   const int* seg, const int* pos, int n_tok, int H, int N,
                   int BS, int B, int M, float scale, cudaStream_t st) {
  auto kp = make_pool<T, KV, QUANT>(k, ks, tables, N, BS, H, DH, M);
  auto vp = make_pool<T, KV, QUANT>(v, vs, tables, N, BS, H, DH, M);
  dim3 grid((n_tok + kQT - 1) / kQT, H);
  ragged_stream_kernel<T, KV, QUANT, DH><<<grid, kThreads, 0, st>>>(
      static_cast<T*>(out), static_cast<const T*>(q), kp, vp, seg, pos,
      n_tok, B, scale);
}

// The float32 kernels; the wrapper checks dtype and Dh before calling.
#define PT_DISPATCH(LAUNCH, ...)                                          \
  do {                                                                    \
    if (!quant) {                                                         \
      if (Dh == 32) LAUNCH<float, float, false, 32>(__VA_ARGS__);         \
      else if (Dh == 64) LAUNCH<float, float, false, 64>(__VA_ARGS__);    \
      else if (Dh == 128) LAUNCH<float, float, false, 128>(__VA_ARGS__);  \
      else return -1;                                                     \
    } else {                                                              \
      if (Dh == 32) LAUNCH<float, int8_t, true, 32>(__VA_ARGS__);         \
      else if (Dh == 64) LAUNCH<float, int8_t, true, 64>(__VA_ARGS__);    \
      else if (Dh == 128) LAUNCH<float, int8_t, true, 128>(__VA_ARGS__);  \
      else return -1;                                                     \
    }                                                                     \
  } while (0)

namespace stream {
// ragged_stream_sm90.cu: the bfloat16 K1 on the tensor cores.
int ragged_stream_sm90(void* out, const void* q, const void* k,
                       const void* v, const void* ks, const void* vs,
                       const int* tables, const int* seg, const int* pos,
                       int n_tok, int H, int Dh, int N, int BS, int B, int M,
                       float scale, int quant, cudaStream_t st);
}  // namespace stream

}  // namespace pt

extern "C" {

// K1. q/out [n_tok, H, Dh]; k/v [N, BS, H, Dh] (int8 codes when quant,
// with ks/vs [N, BS, H] scales in the compute dtype); tables [B, M];
// seg/pos [n_tok]. Returns a cudaError_t value (0 = launched), or -1.
int pt_ragged_stream_attention(void* out, const void* q, const void* k,
                               const void* v, const void* ks, const void* vs,
                               const int* tables, const int* seg,
                               const int* pos, int n_tok, int H, int Dh,
                               int N, int BS, int B, int M, float scale,
                               int dtype, int quant, void* stream) {
  using namespace pt;
  if (n_tok <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return stream::ragged_stream_sm90(out, q, k, v, ks, vs, tables, seg,
                                      pos, n_tok, H, Dh, N, BS, B, M, scale,
                                      quant, st);
  if (dtype != 0) return -1;
  PT_DISPATCH(launch_stream, out, q, k, v, ks, vs, tables, seg, pos, n_tok,
              H, N, BS, B, M, scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
