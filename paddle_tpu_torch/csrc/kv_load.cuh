// K3 — the paged-pool loader of the float32 ragged-stream attention
// kernel (K1) in unified_attention.cu. The paged decode kernel (K2,
// paged_decode_sm90.cu) and the bf16 K1 (ragged_stream_sm90.cu) resolve
// block ids the same way (clamped into [0, N)) and load whole block pieces
// by TMA instead; the bf16 K1 dequantizes an int8 stage in shared memory.
//
// Replaces: paddle_tpu/ops/pallas/unified_attention.py `kv_operand_specs`,
// `kv_operands` and `_load_kv` — the TPU kernels steer their DMA pipeline
// with a scalar-prefetched block index (`tables[row, m]`) and dequantize
// an int8 block in VMEM (`codes * scale[..., None]`).
//
// On Hopper there is no separate DMA stage to steer: each kernel resolves
// a cache position to a pool row itself (`slot`) and reads the vector it
// needs through `load4`, which dequantizes an int8 pool in
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

#include "elem.cuh"

namespace pt {

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
};

}  // namespace pt
