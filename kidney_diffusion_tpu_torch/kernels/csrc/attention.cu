// Fused attention softmax(q k^T * D^-1/2) v over (B, N, H, D) bf16 for
// Hopper (sm_90a).
//
// Replaces: kidney_diffusion_tpu/kernels/attention.py::_fused_attention
// (body `_attention_kernel`). Same function as the JAX reference
// `xla_attention`: q is scaled in its own dtype, scores are fp32, the
// softmax weights are rounded to v's dtype (bf16) before P.V, and keys may
// outnumber queries (appended context tokens); ragged Nq and Nk (down to
// Nk = 2 for cross-attention onto time tokens) are handled by bounds, not
// padding.
//
// What bounds it on this card: at the U-Net's shapes (D = 64, Nq <= 4096,
// Nk <= Nq + 4) the flagship's attention is a small share of a forward;
// self-attention at Nq = 1024 does ~4*Nk*D operations per query (bound by
// operations), cross-attention with Nk = 2 or 4 reads q and writes o and
// little else (bound by bytes).
//
// Design: a flash-style online softmax. One block per (batch*head, 64-query
// tile), one thread per query. A thread keeps its scaled query row and its
// fp32 output accumulator in registers; the block stages 32-key tiles of K
// and V in shared memory (fp32), every thread reads the same key row
// (a broadcast, no bank conflicts), keeps a running max and sum in fp32,
// rescales its accumulator once per key tile, and adds bf16-rounded
// exp(s - max) * v. The (Nq x Nk) score matrix never exists in memory.
// The TPU design kept all of K and V in VMEM; a block's 227 KB of shared
// memory cannot, so K and V stream in tiles. Tensor-core (mma) tiles are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // queries per block = threads per block
constexpr int BK = 32;  // keys per shared-memory tile

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16(f));
}

template <int D>
__global__ void __launch_bounds__(BQ) attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H, int Nq, int Nk,
    float scale) {
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int qi = blockIdx.x * BQ + threadIdx.x;
  const bool active = qi < Nq;
  const size_t qbase = ((size_t)(b * Nq + (active ? qi : 0)) * H + h) * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d8 = 0; d8 < D; d8 += 8) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (active) raw = *reinterpret_cast<const uint4*>(q + qbase + d8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qr[d8 + i] = round_bf16(__bfloat162float(e[i]) * scale);  // q * scale in bf16
      acc[d8 + i] = 0.0f;
    }
  }
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    const int nkt = min(BK, Nk - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < nkt * (D / 8); i += BQ) {
      const int j = i / (D / 8), d8 = (i % (D / 8)) * 8;
      const size_t src = ((size_t)(b * Nk + k0 + j) * H + h) * D + d8;
      const uint4 kr = *reinterpret_cast<const uint4*>(k + src);
      const uint4 vr = *reinterpret_cast<const uint4*>(v + src);
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kr);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ks[j][d8 + e] = __bfloat162float(ke[e]);
        vs[j][d8 + e] = __bfloat162float(ve[e]);
      }
    }
    __syncthreads();
    if (!active) continue;

    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = -INFINITY;
      if (j < nkt) {
        dot = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      }
      s[j] = dot;
      mt = fmaxf(mt, dot);
    }
    const float corr = expf(m - mt);  // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (j < nkt) {
        const float p = expf(s[j] - mt);
        l += p;
        const float pb = round_bf16(p);  // P in v's dtype before P.V
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pb, vs[j][d], acc[d]);
      }
    }
    m = mt;
  }

  if (active) {
    const float inv = 1.0f / l;
#pragma unroll
    for (int d8 = 0; d8 < D; d8 += 8) {
      uint4 raw;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(acc[d8 + i] * inv);
      *reinterpret_cast<uint4*>(o + qbase + d8) = raw;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Nq, int Nk, int H,
           float scale, cudaStream_t stream) {
  const dim3 grid((Nq + BQ - 1) / BQ, B * H);
  attention_kernel<D><<<grid, BQ, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Nq, Nk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, Nq, H, D), k and v (B, Nk, H, D), o (B, Nq, H, D), all bf16 and
// contiguous; D is 32 or 64. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported D).
int kdt_attention(const void* q, const void* k, const void* v, void* o, int B, int Nq, int Nk,
                  int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, Nq, Nk, H, scale, s);
    case 64: return launch<64>(q, k, v, o, B, Nq, Nk, H, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
