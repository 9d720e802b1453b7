// Fused attention softmax(q k^T * D^-1/2) v over (B, N, H, D) bf16 for
// Hopper (sm_90a), on the tensor cores.
//
// Replaces: kidney_diffusion_tpu/kernels/attention.py::_fused_attention
// (body `_attention_kernel`). Same function as the JAX reference
// `xla_attention`: q is scaled in its own dtype, scores are fp32, the
// softmax weights are rounded to v's dtype (bf16) before P.V, and keys may
// outnumber queries (appended context tokens); ragged Nq and Nk (down to
// Nk = 2 for cross-attention onto time tokens) are masked to -inf, not
// padded. The one deviation: the kernel rounds exp(s - running max) to
// bf16 where the reference rounds the normalised weights.
//
// What bounds it on this card: self-attention at Nq = 1024, Nk = 1026,
// 8 heads of 64 does 4*Nq*Nk*D*8 = 2.2 GFLOP on 3 MB (bound by operations,
// ~2 us at the bf16 peak); cross-attention onto 2-4 tokens reads q and
// writes o and little else (bound by bytes). At these sizes what is scarce
// is latency and blocks: 8 heads x 16 query tiles is 128 blocks, about one
// wave on 132 SMs.
//
// Design: a FlashAttention-2 style forward on `mma.sync.m16n8k16` (bf16 in,
// fp32 accumulate). A block of 4 warps owns 64 queries of one (batch, head),
// 16 per warp. K and V stream in 64-key tiles through a 3-slot shared-memory
// ring filled with 16-byte `cp.async` (keys past Nk are zero filled); the
// blocks of one head start at different key tiles, so they do not all read
// the same rows at once. S = (q*scale) K^T runs on the tensor cores with Q
// and K fragments from `ldmatrix`, a k step's fragments loaded before its
// eight independent products. The loop is software-pipelined: step t issues
// the products S(t+1) before the softmax and P.V of tile t, so the tensor
// cores work on the next scores while the warp computes exponentials (two
// score buffers, the loop unrolled by two). The online softmax stays in
// registers (row max and sum as trees, then across the quad of lanes that
// share a row by `__shfl_xor_sync`; exp by one FMA and `ex2.approx`);
// P = exp(S - m) is rounded to bf16 in registers and used directly as the
// A operand of P.V (the m16n8 accumulator layout is the k16 A layout), with
// V fragments from `ldmatrix.trans`. O stays in fp32 registers, is
// normalised once at the end and leaves through shared memory as 16-byte
// rows. A full tile is straight-line code; a partial one skips the 8- and
// 16-key blocks without a valid key, so Nk = 2 costs one block of products.
// At the self-attention shape a warp's key tile is 64 `mma.sync` products
// against about a hundred instructions of softmax, so the products' rate
// bounds the loop; the rest is the fixed cost of a block (its query tile,
// first key tile and store). `wgmma` is not used: the heaviest call is
// ~2 us of tensor-core work at its peak and 128 blocks of 64 queries fill
// the 132 SMs, so latency and per-block cost weigh as much as the product
// rate; `wgmma` products are the step to take if attention's share of
// device time grows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int SLOTS = 3;      // K/V tiles in the ring: t (P.V), t + 1 (S), t + 2 (loading)
constexpr int THREADS = 128;  // 4 warps x 16 queries
constexpr float LOG2E = 1.4426950408889634f;  // exp(s - m) = 2^(s log2 e - m log2 e)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false the destination is zero filled
// and nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on one 16x8x16 tile (A row-major, B column-major, fp32 sums)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far below what a bf16 softmax weight can carry)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// shared memory: the query tile and a ring of SLOTS tiles of K and of V,
// rows padded by 16 bytes so that 8 rows of an ldmatrix hit 8 bank groups
template <int D>
constexpr int smem_bytes() {
  return (BQ + 2 * SLOTS * BK) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(THREADS) attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H, int Nq, int Nk,
    float scale) {
  constexpr int LD = D + 8;   // padded row
  constexpr int KS = D / 16;  // k steps of S = Q K^T
  constexpr int ND = D / 8;   // 8-column blocks of O
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NJ = BK / 8;  // 8-key column blocks of S
  extern __shared__ __align__(16) uint8_t smem_raw[];  // smem_bytes<D>()
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* kv = qs + BQ * LD;  // slot i: K at 2 i BK rows, V at (2 i + 1) BK rows

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t stride = (size_t)H * D;  // elements from one token to the next
  const __nv_bfloat16* qb = q + ((size_t)b * Nq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Nk * H + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Nk * H + h) * D;
  __nv_bfloat16* ob = o + ((size_t)b * Nq * H + h) * D;

  // The block's t-th key tile is tile (t + first) % n_tiles: blocks of one
  // head start at different tiles, so at any moment they read different
  // rows of K and V (the softmax does not depend on the order). It goes to
  // ring slot t % SLOTS.
  const int n_tiles = (Nk + BK - 1) / BK;
  const int first = blockIdx.x % n_tiles;
  auto key_tile = [&](int t) { return t + first < n_tiles ? t + first : t + first - n_tiles; };
  auto k_slot = [&](int slot) { return kv + slot * 2 * BK * LD; };
  // a thread copies the same 16-byte column of rows lr, lr + RP, ...
  constexpr int RP = THREADS / CH;  // rows per pass of the block
  const int lr = tid / CH, lc = (tid % CH) * 8;
  auto load_kv = [&](int t, int slot) {
    const int k0 = key_tile(t) * BK;
    __nv_bfloat16* kd = k_slot(slot) + lr * LD + lc;
    __nv_bfloat16* vd = kd + BK * LD;
#pragma unroll
    for (int j = 0; j < BK / RP; ++j) {
      const int key = k0 + lr + j * RP;
      const bool ok = key < Nk;
      const size_t off = (size_t)(ok ? key : 0) * stride + lc;
      cp_async16(smem_u32(kd + j * RP * LD), kb + off, ok);
      cp_async16(smem_u32(vd + j * RP * LD), vb + off, ok);
    }
  };
  auto valid_keys = [&](int t) { return min(BK, Nk - key_tile(t) * BK); };

  load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  // the query tile, q * scale rounded to bf16 (its own dtype), zeros past Nq
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c8 = (i % CH) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < Nq) raw = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * stride + c8);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    *reinterpret_cast<uint4*>(&qs[r * LD + c8]) = raw;
  }
  cp_async_wait<1>();  // this thread's copies of tile 0 are in
  __syncthreads();     // everyone's, and the query tile
  // A fragments of this warp's 16 queries: lanes 0-15 address rows 0-15 at
  // columns 0-7 of each k step, lanes 16-31 the same rows at columns 8-15
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(&qs[(warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8]));

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  // this lane's rows are g and g + 8 of the warp's 16; its columns of an
  // 8-column block are 2 * t4 and 2 * t4 + 1
  const int t4 = lane & 3;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};  // this lane's partial sums; the quad is summed at the end

  // S = (q * scale) K^T of tile t, keys past the tile's valid ones at -inf.
  // FULL (all 64 keys valid) is straight-line code, so the eight
  // independent column blocks interleave on the tensor cores; a partial
  // tile skips 16-key blocks without a valid key.
  auto scores = [&](float (&s)[NJ][4], const int slot, const int nkt, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const __nv_bfloat16* kt = k_slot(slot);
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // K fragments of the k step first, then its eight independent products;
      // matrices: keys 0-7 x d 0-7, keys 0-7 x d 8-15, keys 8-15 x d 0-7, keys 8-15 x d 8-15
      uint32_t bf[NJ / 2][4];
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        if (FULL || jj * 16 < nkt) {
          const int key = jj * 16 + (lane & 7) + (lane >> 4) * 8;
          const int col = kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bf[jj], smem_u32(&kt[key * LD + col]));
        }
      }
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        if (FULL || jj * 16 < nkt) {
          mma16816(s[2 * jj], qf[kk], bf[jj][0], bf[jj][1]);
          mma16816(s[2 * jj + 1], qf[kk], bf[jj][2], bf[jj][3]);
        }
      }
    }
    if (!FULL) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * t4 + (e & 1) >= nkt) s[j][e] = -INFINITY;
    }
  };

  // The online softmax of a tile's scores s, then O += P V.
  auto softmax_pv = [&](float (&s)[NJ][4], const int slot, const int nkt, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const __nv_bfloat16* vt = k_slot(slot) + BK * LD;
    // row max and sums as trees, then across the quad of lanes of a row
    float rm[2][NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      rm[0][j] = fmaxf(s[j][0], s[j][1]);
      rm[1][j] = fmaxf(s[j][2], s[j][3]);
    }
    float mx[2], mxl[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int w = NJ / 2; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) rm[r][j] = fmaxf(rm[r][j], rm[r][j + w]);
      mx[r] = fmaxf(m_run[r], rm[r][0]);
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mxl[r] = mx[r] * LOG2E;
      corr[r] = ex2(fmaf(m_run[r], LOG2E, -mxl[r]));  // 0 on the first tile (m_run = -inf)
      l_run[r] *= corr[r];
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // P = exp(S - m) in fp32 for the sums, bf16 (v's dtype) for P.V; the
    // accumulator of key block 2kk (2kk + 1) is the low (high) half of A
    uint32_t pa[NJ / 2][4];
    float ls[2][NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;  // 8-key blocks past nkt stay 0
      if (FULL || j * 8 < nkt) {
        p0 = ex2(fmaf(s[j][0], LOG2E, -mxl[0]));
        p1 = ex2(fmaf(s[j][1], LOG2E, -mxl[0]));
        p2 = ex2(fmaf(s[j][2], LOG2E, -mxl[1]));
        p3 = ex2(fmaf(s[j][3], LOG2E, -mxl[1]));
      }
      ls[0][j] = p0 + p1;
      ls[1][j] = p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int w = NJ / 2; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) ls[r][j] += ls[r][j + w];
      l_run[r] += ls[r][0];
    }
    // O += P V over 16-key steps that hold a valid key
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      if (FULL || kk * 16 < nkt) {
        // transposed matrices: keys 0-7 x d 0-7, keys 8-15 x d 0-7,
        // keys 0-7 x d 8-15, keys 8-15 x d 8-15
        uint32_t bf[ND / 2][4];
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = dp * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bf[dp], smem_u32(&vt[key * LD + col]));
        }
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          mma16816(acc[2 * dp], pa[kk], bf[dp][0], bf[dp][1]);
          mma16816(acc[2 * dp + 1], pa[kk], bf[dp][2], bf[dp][3]);
        }
      }
    }
  };

  // Software pipeline: step t issues the products S(t + 1) before the
  // softmax and P.V of tile t, so the tensor cores work on the next tile's
  // scores while the warp computes exponentials; two score buffers
  // alternate (the loop is unrolled by two to keep them in registers).
  // slot0 is tile t's slot; the next two tiles take the next two slots
  auto step = [&](const int t, const int slot0, float (&s_cur)[NJ][4],
                  float (&s_next)[NJ][4]) {
    const int slot1 = slot0 == SLOTS - 1 ? 0 : slot0 + 1;
    const int slot2 = slot1 == SLOTS - 1 ? 0 : slot1 + 1;
    cp_async_wait<0>();  // this thread's copies of tile t + 1 are in
    __syncthreads();     // everyone's; every warp is done with tile t - 1's slot
    if (t + 2 < n_tiles) load_kv(t + 2, slot2);  // tile t - 1's slot
    cp_async_commit();
    if (t + 1 < n_tiles) {
      const int nk1 = valid_keys(t + 1);
      if (nk1 == BK) {
        scores(s_next, slot1, nk1, std::true_type{});
      } else {
        scores(s_next, slot1, nk1, std::false_type{});
      }
    }
    const int nkt = valid_keys(t);
    if (nkt == BK) {
      softmax_pv(s_cur, slot0, nkt, std::true_type{});
    } else {
      softmax_pv(s_cur, slot0, nkt, std::false_type{});
    }
    return slot1;
  };
  float s_a[NJ][4], s_b[NJ][4];
  {
    const int nk0 = valid_keys(0);
    if (nk0 == BK) {
      scores(s_a, 0, nk0, std::true_type{});
    } else {
      scores(s_a, 0, nk0, std::false_type{});
    }
  }
  for (int t = 0, slot = 0; t < n_tiles; t += 2) {
    slot = step(t, slot, s_a, s_b);
    if (t + 1 < n_tiles) slot = step(t + 1, slot, s_b, s_a);
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / l;
  }

  // ---- normalise once, stage the warp's 16 rows in shared memory, store ----
  __nv_bfloat16* stage = &qs[warp * 16 * LD];  // this warp's own query rows
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<uint32_t*>(&stage[g * LD + j * 8 + 2 * t4]) =
        pack_bf16(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(&stage[(g + 8) * LD + j * 8 + 2 * t4]) =
        pack_bf16(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c8 = (i % CH) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < Nq)
      *reinterpret_cast<uint4*>(ob + (size_t)qi * stride + c8) =
          *reinterpret_cast<const uint4*>(&stage[r * LD + c8]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Nq, int Nk, int H,
           float scale, cudaStream_t stream) {
  static bool allowed = false;  // above 48 KB only once the kernel allows it
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  const dim3 grid((Nq + BQ - 1) / BQ, B * H);
  attention_kernel<D><<<grid, THREADS, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Nq, Nk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, Nq, H, D), k and v (B, Nk, H, D), o (B, Nq, H, D), all bf16,
// contiguous and 16-byte aligned; D is 32 or 64; Nk >= 1. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported D).
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
