// K3 — the shared paged-pool loader of the ragged-stream (K1) and
// paged-decode (K2) attention kernels in unified_attention.cu.
//
// Replaces: paddle_tpu/ops/pallas/unified_attention.py `kv_operand_specs`,
// `kv_operands` and `_load_kv` — the TPU kernels steer their DMA pipeline
// with a scalar-prefetched block index (`tables[row, m]`) and dequantize
// an int8 block in VMEM (`codes * scale[..., None]`).
//
// On Hopper there is no separate DMA stage to steer: each kernel resolves
// a cache position to a pool row itself (`slot`) and reads the vector it
// needs through `load4` / `load1`, which dequantize an int8 pool in
// registers. It is not a launch of its own; the bound and design notes of
// the kernels that use it are in unified_attention.cu.
//
// Pool layout (one layer, contiguous): data [N, BS, H, Dh]; for an int8
// pool, scales [N, BS, H] in the compute dtype (one absmax scale per
// stored vector); tables [B, M] int32 block ids, 0-padded (block 0 is the
// reserved trash block).
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace pt {

constexpr float kNegInf = -1e30f;  // the TPU kernels' masking value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements as float (one 16-, 8- or 4-byte load; the
// caller keeps the element offset a multiple of 4 and the base aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

// One layer's K or V pool. KV is the stored element type (the compute
// type T for a dense pool, int8_t for a quantized one); S is the scale
// type (T). QUANT selects the int8 dequant.
template <typename KV, typename S, bool QUANT>
struct PagedPool {
  const KV* data;     // [N, BS, H, Dh]
  const S* scales;    // [N, BS, H]; unused when !QUANT
  const int* tables;  // [B, M]
  int N, BS, H, Dh, M;

  // Pool row (block * BS + offset) of cache position `kpos` of table row
  // `row`. The block id is clamped into the pool, as a JAX gather clamps.
  __device__ __forceinline__ int64_t slot(int row, int kpos) const {
    const int m = kpos / BS;
    int blk = tables[static_cast<int64_t>(row) * M + m];
    blk = min(max(blk, 0), N - 1);
    return static_cast<int64_t>(blk) * BS + (kpos - m * BS);
  }

  __device__ __forceinline__ float scale(int64_t s, int h) const {
    return QUANT ? to_f(scales[s * H + h]) : 1.0f;
  }

  // Lanes d..d+3 of the (row s, head h) vector, dequantized.
  __device__ __forceinline__ float4 load4(int64_t s, int h, int d) const {
    float4 v = pt::load4(data + (s * H + h) * Dh + d);
    if (QUANT) {
      const float sc = scale(s, h);
      v.x *= sc; v.y *= sc; v.z *= sc; v.w *= sc;
    }
    return v;
  }

  // Lane d of the (row s, head h) vector, dequantized.
  __device__ __forceinline__ float load1(int64_t s, int h, int d) const {
    const float x = to_f(data[(s * H + h) * Dh + d]);
    return QUANT ? x * scale(s, h) : x;
  }
};

}  // namespace pt
