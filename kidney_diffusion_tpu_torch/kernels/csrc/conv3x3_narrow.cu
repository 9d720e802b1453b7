// The narrow ends of the U-Nets' 3x3 SAME convolutions over NHWC bf16 for
// Hopper (sm_90a): the init conv (Cin <= 8: 3 or 6 on the flagship) and the
// final conv (Cout <= 8: 3), each with its own kernel. `kernels/conv3x3.py`
// routes them here ("narrow"), by a pure function of (Cin, Cout, quant,
// bias_in_dtype).
//
// Replaces: kidney_diffusion_tpu/kernels/conv3x3.py::_pallas_conv3x3 (:394,
// body `_kernel`, stats finisher at :475-481), for these calls. Same
// function as `conv3x3_sm90.cu` and `conv3x3.cu` in bf16: y = conv3x3(pro(x))
// + bias with fp32 accumulation, the optional prologue silu(x * a + c) per
// (batch, input channel) rounded to bf16 with the SAME zero padding after
// it, per-tile [sum z, sum z^2] and [max, min] slots (range_mode 1: of fp32
// z; 2: of the bf16 output), row chunks whose halo rows come from the
// neighbour chunk, and `bias_in_dtype`: y = bf16(bf16(z) + bf16(bias)), the
// two roundings of `flax.linen.Conv(dtype=bf16)` at the unchunked init conv.
//
// What bounds them on this card: bytes. The final conv does 2*9*Cin*3
// operations per pixel on 2*Cin input bytes (27 per byte); the init conv
// 2*9*Cin*Cout on 2*Cout output bytes (54 at Cin 6). Both are far below
// the ~295 FLOP/byte where the bf16 tensor cores would be the limit: the
// final conv must read its input once, the init conv write its output once.
// A general implicit GEMM wastes both: padded to 64 output channels the
// final conv computes 21x the products it needs and re-reads rows; padded
// to 16 input channels per tap the init conv does nine passes of K.
//
// Design.
// - Final conv (`narrow_out`, Cout <= 8, Cin % 64 == 0, Cin <= 256): a
//   persistent grid, one block an SM, walks (tile, 64-channel slice) jobs;
//   a tile is 4 x 64 pixels and all Cout channels (padded to 8, one n8 of
//   `mma.sync.m16n8k16`). The tile's halo'd patch (6 x 66 pixels x 128
//   bytes, 16-byte chunks XOR-swizzled) arrives by `cp.async` in a ring of
//   three buffers, two jobs ahead, so each input byte comes from HBM about
//   once (the halo rows mostly from L2) while the previous job computes.
//   The 9 taps' weights of every slice sit in shared memory in fragment
//   order (at most 36 KB), loaded once per block. Each warp owns a
//   16-column strip and half of a slice's K: it reads every patch row once
//   per (dx, k16) with `ldmatrix` and adds it into the accumulators of the
//   up to three output rows that row feeds (dy = 0, 1, 2), so the patch is
//   read 3 times, not 9. The two K halves meet in shared memory; the
//   epilogue stages the tile's outputs (6 bytes a pixel at Cout 3) and
//   stores whole pixel rows with 16-byte stores.
// - Init conv (`narrow_in`, Cin <= 8, Cout % 64 == 0, Cout <= 512): K is
//   the 9 taps x Cin folded into one dimension (27 or 54 values, padded to
//   32 or 64, or 80 at Cin 8): one K pass, not nine padded taps. A
//   persistent grid walks 128-pixel tiles; each warp gathers its 16 pixels'
//   A fragments straight from the tile's small patch (Cin channels a
//   pixel) into registers, once per tile, and runs them against the folded
//   weights (in fragment order in shared memory, loaded once per block) for
//   64 output channels at a time; the epilogue stages each 64-channel pass
//   in shared memory for 16-byte stores, and the range of the bf16 output
//   (request C's call) is taken from the values a thread stores. The block
//   covers all Cout, so the patch is read once; the next tile's patch is
//   loaded into registers while this one computes.
// Stats and range slots go to one slot per tile, reduced across warps in
// a fixed order (no atomics; the wrapper reduces the slots in a fixed
// order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int SMS = 132;      // streaming multiprocessors of an H100 SXM

struct Args {
  const __nv_bfloat16* x;  // (nb, H, W, Cin)
  const __nv_bfloat16* w;  // (3, 3, Cin, Cout)
  const float* bias;       // (Cout) or null
  const float* pro;        // (nb, 2, Cin) or null
  __nv_bfloat16* y;        // (nb, H, W, Cout)
  float* partial;          // (nb, n_tiles, 2, Cout) [sum z, sum z^2] or null
  float* prange;           // (nb, n_tiles, 2, Cout) [max, min] or null
  int nb, H, W, Cin, Cout, chunks, TH, TW, tiles_x, n_tiles;
  int range_mode;          // 1: of fp32 z (bias added by the wrapper); 2: of the bf16 output
  int bias_in_dtype;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// d (16 x 8, fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 as one 32-bit fragment register: lo in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The prologue as the plain version computes it: x * a + c with each step
// rounded, silu by the accurate exponential and a true division, bf16.
__device__ __forceinline__ __nv_bfloat16 prologue(float x, float a, float c) {
  const float f = __fadd_rn(__fmul_rn(x, a), c);
  return __float2bfloat16(f / (1.0f + expf(-f)));
}

// the stored value: bf16 of z + bias, or of bf16(z) + bf16(bias)
__device__ __forceinline__ __nv_bfloat16 yval(const Args& a, float z, float b) {
  if (a.bias_in_dtype)
    return __float2bfloat16(__bfloat162float(__float2bfloat16(z)) +
                            __bfloat162float(__float2bfloat16(b)));
  return __float2bfloat16(__fadd_rn(z, b));
}

// Whether the conv reads image row `r` (-1 and H: the halo rows), column
// `c` of batch item `bi` from the input, not as a padding zero: rows -1
// and H exist only inside a row-chunked image, from the neighbour chunk.
__device__ __forceinline__ bool is_input(const Args& a, int bi, int r, int c) {
  if (c < 0 || c >= a.W || r < -1 || r > a.H) return false;
  if (r == -1) return a.chunks > 0 && bi % a.chunks != 0;
  if (r == a.H) return a.chunks > 0 && bi % a.chunks != a.chunks - 1 && bi + 1 < a.nb;
  return true;
}

// The input pixel the conv reads at row `r`, column `c` of item `bi` (see
// `is_input`; the halo rows resolve to the neighbour chunk's edge rows).
__device__ __forceinline__ const __nv_bfloat16* src_pixel(const Args& a, int bi, int r, int c) {
  const int b = r < 0 ? bi - 1 : (r == a.H ? bi + 1 : bi);
  r = r < 0 ? a.H - 1 : (r == a.H ? 0 : r);
  return a.x + ((size_t)(b * a.H + r) * a.W + c) * a.Cin;
}

// byte offset of 16-byte chunk `c` of patch pixel `p` (chunks XOR-swizzled
// by the pixel, so 8 consecutive pixels of an ldmatrix hit 8 bank groups)
__device__ __forceinline__ uint32_t patch_off(int p, int c) {
  return p * 128 + ((c ^ (p & 7)) << 4);
}

// ---------------------------------------------------------------------------
// final conv: Cout <= 8
constexpr int OUT_TH = 4, OUT_TW = 64;       // the tile: 4 rows x 64 columns
constexpr int OUT_PW = OUT_TW + 2;           // patch columns
constexpr int OUT_NPATCH = (OUT_TH + 2) * OUT_PW;
constexpr int OUT_PBYTES = OUT_NPATCH * 128;  // one 64-channel patch buffer
constexpr int OUT_NBUF = 3;                   // patch ring: two jobs in flight
constexpr int OUT_MAX_CIN = 256;

// shared memory: the patch ring, the weights in fragment order, the K
// halves' exchange, the stats exchange and the output tile
__host__ __device__ constexpr int out_smem_bytes(int cin) {
  return OUT_NBUF * OUT_PBYTES + 9 * cin * 16 + 4 * OUT_TH * 32 * 16 + 4 * 8 * 16 +
         OUT_TH * OUT_TW * 8 * 2;
}

__global__ void __launch_bounds__(THREADS, 1) conv3x3_narrow_out(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* patches = smem;
  uint2* bfrag = reinterpret_cast<uint2*>(smem + OUT_NBUF * OUT_PBYTES);  // [tap][k16][lane]
  float4* kred = reinterpret_cast<float4*>(smem + OUT_NBUF * OUT_PBYTES + 9 * a.Cin * 16);
  float4* sred = kred + 4 * OUT_TH * 32;                                  // [strip][n]
  __nv_bfloat16* ost = reinterpret_cast<__nv_bfloat16*>(sred + 4 * 8);   // [row][col][Cout]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = warp & 3, kh = warp >> 2;  // 16-column strip, half of a slice's K
  const int g = lane >> 2, t4 = lane & 3;
  const int nsl = a.Cin / 64, nk16 = a.Cin / 16;
  const int total = a.nb * a.n_tiles;
  const int my_tiles = blockIdx.x < total ? (total - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_jobs = my_tiles * nsl;

  // the weights of every (tap, k16) as this lane's B fragment: k rows 2t,
  // 2t+1 (b0) and 2t+8, 2t+9 (b1) of input channel block k16, column g
  for (int i = tid; i < 9 * nk16 * 32; i += THREADS) {
    const int l = i & 31, tk = i >> 5, tap = tk / nk16, k16 = tk - tap * nk16;
    const int n = l >> 2, k0 = k16 * 16 + 2 * (l & 3);
    __nv_bfloat16 v[4] = {};
    if (n < a.Cout) {
      const __nv_bfloat16* wp = a.w + ((size_t)tap * a.Cin + k0) * a.Cout + n;
      v[0] = wp[0];
      v[1] = wp[a.Cout];
      v[2] = wp[8 * a.Cout];
      v[3] = wp[9 * a.Cout];
    }
    bfrag[i] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }

  auto tile_of = [&](int j) { return blockIdx.x + (j / nsl) * gridDim.x; };
  // job j (tile, slice j % nsl): its raw halo'd patch into buffer j % 3;
  // zeros where the conv reads padding
  auto load = [&](int j) {
    const int tg = tile_of(j), s = j % nsl;
    const int bi = tg / a.n_tiles, tt = tg - bi * a.n_tiles;
    const int ty0 = (tt / a.tiles_x) * OUT_TH, tx0 = (tt % a.tiles_x) * OUT_TW;
    const uint32_t dst = smem_u32(patches + (j % OUT_NBUF) * OUT_PBYTES);
    const int c = tid & 7, coff = s * 64 + c * 8;
    int p = tid >> 3, pr = p / OUT_PW, pc = p - pr * OUT_PW;
    for (; p < OUT_NPATCH; p += THREADS / 8) {
      const int r = ty0 + pr - 1, col = tx0 + pc - 1;
      const bool in = is_input(a, bi, r, col);
      cp_async16(dst + patch_off(p, c), in ? src_pixel(a, bi, r, col) + coff : a.x, in);
      pc += THREADS / 8;
      while (pc >= OUT_PW) pc -= OUT_PW, ++pr;
    }
  };

  if (n_jobs > 0) load(0);
  cp_async_commit();
  if (n_jobs > 1) load(1);
  cp_async_commit();

  float acc[OUT_TH][4];
#pragma unroll
  for (int r = 0; r < OUT_TH; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;

  for (int j = 0; j < n_jobs; ++j) {
    const int tg = tile_of(j), s = j % nsl;
    const int bi = tg / a.n_tiles, tt = tg - bi * a.n_tiles;
    const int ty0 = (tt / a.tiles_x) * OUT_TH, tx0 = (tt % a.tiles_x) * OUT_TW;
    uint8_t* buf = patches + (j % OUT_NBUF) * OUT_PBYTES;
    cp_async_wait<1>();  // this thread's copies of job j are in
    __syncthreads();     // everyone's; every warp is done with job j - 1
    if (a.pro != nullptr) {  // in place, all threads; padding pixels stay zero
      const float* pa = a.pro + (size_t)bi * 2 * a.Cin + s * 64;
      for (int i = tid; i < OUT_NPATCH * 8; i += THREADS) {
        const int p = i >> 3, c = i & 7, pr = p / OUT_PW, pc = p - pr * OUT_PW;
        if (!is_input(a, bi, ty0 + pr - 1, tx0 + pc - 1)) continue;
        uint4* ptr = reinterpret_cast<uint4*>(buf + patch_off(p, c));
        uint4 val = *ptr;
        __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = prologue(__bfloat162float(v[e]), pa[c * 8 + e], pa[a.Cin + c * 8 + e]);
        *ptr = val;
      }
      __syncthreads();
    }
    if (j + 2 < n_jobs) load(j + 2);  // into job j - 1's buffer
    cp_async_commit();

    // this warp's B fragments of the slice: 9 taps x its two k16 steps
    uint32_t bw[9][2][2];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint2 v = bfrag[(tap * nk16 + s * 4 + kh * 2 + kk) * 32 + lane];
        bw[tap][kk][0] = v.x;
        bw[tap][kk][1] = v.y;
      }
    // patch row pr feeds output rows pr - dy, dy = 0, 1, 2
    const uint32_t pbase = smem_u32(buf);
    const int col = strip * 16 + (lane & 15), khalf = lane >> 4;
#pragma unroll
    for (int pr = 0; pr < OUT_TH + 2; ++pr) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, pbase + patch_off(pr * OUT_PW + col + dx, (kh * 2 + kk) * 2 + khalf));
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int orow = pr - dy;
            if (orow < 0 || orow >= OUT_TH) continue;
            mma_bf16(acc[orow], af, bw[dy * 3 + dx][kk][0], bw[dy * 3 + dx][kk][1]);
          }
        }
      }
    }
    if (s != nsl - 1) continue;

    // ---- the tile is done: the two K halves meet, then the epilogue ----
    if (kh == 1) {
#pragma unroll
      for (int r = 0; r < OUT_TH; ++r)
        kred[(strip * OUT_TH + r) * 32 + lane] = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                                             acc[r][3]);
    }
    __syncthreads();
    const bool stats = a.partial != nullptr || a.prange != nullptr;
    if (kh == 0) {
#pragma unroll
      for (int r = 0; r < OUT_TH; ++r) {
        const float4 o = kred[(strip * OUT_TH + r) * 32 + lane];
        acc[r][0] += o.x;
        acc[r][1] += o.y;
        acc[r][2] += o.z;
        acc[r][3] += o.w;
      }
      // accumulator 2h + c of row r: pixel (r, strip * 16 + g + 8h), channel 2 t4 + c
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 2 * t4 + c;
        const bool n_ok = n < a.Cout;
        const float b = (n_ok && a.bias != nullptr) ? a.bias[n] : 0.0f;
        float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
#pragma unroll
        for (int r = 0; r < OUT_TH; ++r) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cx = strip * 16 + g + 8 * h;
            const float z = acc[r][2 * h + c];
            const __nv_bfloat16 yv = yval(a, z, b);
            if (n_ok) ost[(r * OUT_TW + cx) * a.Cout + n] = yv;
            if (!stats || ty0 + r >= a.H || tx0 + cx >= a.W) continue;
            s1 += z;
            s2 += z * z;
            const float rv = a.range_mode == 2 ? __bfloat162float(yv) : z;
            hi = fmaxf(hi, rv);
            lo = fminf(lo, rv);
          }
        }
        if (stats) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
            hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
            lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
          }
          if (lane < 4) sred[strip * 8 + n] = make_float4(s1, s2, hi, lo);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < OUT_TH; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
    __syncthreads();
    if (stats && tid < a.Cout) {
      float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
      for (int w = 0; w < 4; ++w) {  // a fixed order
        const float4 r = sred[w * 8 + tid];
        s1 += r.x;
        s2 += r.y;
        hi = fmaxf(hi, r.z);
        lo = fminf(lo, r.w);
      }
      const size_t slot = ((size_t)bi * a.n_tiles + tt) * 2 * a.Cout + tid;
      if (a.partial != nullptr) {
        a.partial[slot] = s1;
        a.partial[slot + a.Cout] = s2;
      }
      if (a.prange != nullptr) {
        a.prange[slot] = hi;
        a.prange[slot + a.Cout] = lo;
      }
    }
    // whole pixel rows of the tile: 16-byte stores where the row is aligned
    const int ncols = min(OUT_TW, a.W - tx0), row_elems = ncols * a.Cout;
    for (int r = 0; r < OUT_TH && ty0 + r < a.H; ++r) {
      __nv_bfloat16* dst = a.y + ((size_t)(bi * a.H + ty0 + r) * a.W + tx0) * a.Cout;
      const __nv_bfloat16* src = ost + r * OUT_TW * a.Cout;
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (row_elems & 7) == 0) {
        for (int i = tid; i < row_elems / 8; i += THREADS)
          reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
      } else {
        for (int i = tid; i < row_elems; i += THREADS) dst[i] = src[i];
      }
    }
    // ost, kred and sred are next written after the next job's barrier
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// init conv: Cin <= 8, K = 9 * Cin folded into KS k16 steps
constexpr int IN_BM = 128;           // pixels a tile
constexpr int IN_MAX_PATCH = 264;    // (TH+2)*(TW+2) of the widest 128-pixel tile, 2 x 64
constexpr int IN_OLD = 64 + 8;       // output staging row (bf16), padded by 16 bytes
constexpr int IN_MAX_COUT = 512;

__host__ __device__ constexpr int in_smem_bytes(int ks, int cout) {
  return ks * cout * 32 + IN_BM * IN_OLD * 2 + 8 * 64 * 16 + IN_MAX_PATCH * 8 * 2 + 16;
}

template <int KS>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_narrow_in(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint2* bfrag = reinterpret_cast<uint2*>(smem);  // [k16][n8][lane]
  __nv_bfloat16* ost = reinterpret_cast<__nv_bfloat16*>(smem + KS * a.Cout * 32);
  float4* sred = reinterpret_cast<float4*>(ost + IN_BM * IN_OLD);  // [warp][64]
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(sred + 8 * 64);
  const int zero = IN_MAX_PATCH * 8;  // a zero element: the padding of K
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int Cin = a.Cin, Cout = a.Cout, K = 9 * Cin, n8 = Cout / 8;
  const int TH = a.TH, TW = a.TW, PW = TW + 2, npatch = (TH + 2) * PW;
  if (tid == 0) patch[zero] = __float2bfloat16(0.0f);

  // the folded weights B (K x Cout) = w reshaped, k = tap * Cin + ci, as
  // this lane's B fragment of (k16, n8): rows 2t, 2t+1 and 2t+8, 2t+9,
  // column g; zeros past K
  for (int i = tid; i < KS * n8 * 32; i += THREADS) {
    const int l = i & 31, kn = i >> 5, k16 = kn / n8, nb8 = kn - k16 * n8;
    const int n = nb8 * 8 + (l >> 2), k0 = k16 * 16 + 2 * (l & 3);
    __nv_bfloat16 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + (e & 1) + (e >> 1) * 8;
      v[e] = k < K ? a.w[(size_t)k * Cout + n] : __float2bfloat16(0.0f);
    }
    bfrag[i] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
  // where this lane's A fragment elements sit in the patch, relative to its
  // pixel: k = ks * 16 + 2 t4 + {0, 1, 8, 9} -> (tap, ci); -1 past K
  int koff[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = ks * 16 + 2 * t4 + (e & 1) + (e >> 1) * 8;
      const int tap = k / Cin, ci = k - tap * Cin;
      koff[ks][e] = k < K ? ((tap / 3) * PW + tap % 3) * Cin + ci : -1;
    }
  // this warp's pixels: m = 16 warp + g (+ 8)
  const int m_lo = warp * 16 + g, m_hi = m_lo + 8;
  const int pb_lo = ((m_lo / TW) * PW + m_lo % TW) * Cin, pb_hi = ((m_hi / TW) * PW + m_hi % TW) * Cin;
  // range mode 2 without stats reads [max, min] off the staged bf16 output;
  // stats (and range mode 1) come from the fp32 accumulators
  const bool stats = a.partial != nullptr || (a.prange != nullptr && a.range_mode != 2);
  const bool out_range = a.partial == nullptr && a.prange != nullptr && a.range_mode == 2;

  // the next tile's patch elements, loaded into registers while this tile
  // computes: a thread holds elements tid, tid + THREADS, ... (raw bf16)
  constexpr int NEL = (IN_MAX_PATCH * 8 + THREADS - 1) / THREADS;
  const int n_el = npatch * Cin;
  unsigned short nxt[NEL];
  auto fetch = [&](int tg) {
    const int bi = tg / a.n_tiles, tt = tg - bi * a.n_tiles;
    const int ty0 = (tt / a.tiles_x) * TH, tx0 = (tt % a.tiles_x) * TW;
#pragma unroll
    for (int e = 0; e < NEL; ++e) {
      const int i = tid + e * THREADS, p = i / Cin, ci = i - p * Cin, pr = p / PW;
      const int r = ty0 + pr - 1, col = tx0 + p - pr * PW - 1;
      nxt[e] = (i < n_el && is_input(a, bi, r, col))
                   ? __bfloat16_as_ushort(src_pixel(a, bi, r, col)[ci])
                   : static_cast<unsigned short>(0);
    }
  };
  if (blockIdx.x < a.nb * a.n_tiles) fetch(blockIdx.x);

  for (int tg = blockIdx.x; tg < a.nb * a.n_tiles; tg += gridDim.x) {
    const int bi = tg / a.n_tiles, tt = tg - bi * a.n_tiles;
    const int ty0 = (tt / a.tiles_x) * TH, tx0 = (tt % a.tiles_x) * TW;
    const float* pa = a.pro ? a.pro + (size_t)bi * 2 * Cin : nullptr;
    __syncthreads();  // the previous tile's fragments are read, its output stored
    // the halo'd patch, Cin channels a pixel: prologue, padding zeros after it
#pragma unroll
    for (int e = 0; e < NEL; ++e) {
      const int i = tid + e * THREADS;
      if (i >= n_el) break;
      const int p = i / Cin, ci = i - p * Cin, pr = p / PW;
      __nv_bfloat16 v = __ushort_as_bfloat16(nxt[e]);
      if (pa != nullptr && is_input(a, bi, ty0 + pr - 1, tx0 + p - pr * PW - 1))
        v = prologue(__bfloat162float(v), pa[ci], pa[Cin + ci]);
      patch[i] = v;
    }
    __syncthreads();
    if (tg + gridDim.x < a.nb * a.n_tiles) fetch(tg + gridDim.x);
    uint32_t af[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {  // a0: row g, k 2t; a1: row g+8; a2, a3: k + 8
        const int pb = (rr & 1) ? pb_hi : pb_lo, e0 = (rr >> 1) * 2;
        const int o0 = koff[ks][e0], o1 = koff[ks][e0 + 1];
        af[ks][rr] = pack2(patch[o0 >= 0 ? pb + o0 : zero], patch[o1 >= 0 ? pb + o1 : zero]);
      }
    const bool ok_lo = ty0 + m_lo / TW < a.H && tx0 + m_lo % TW < a.W;
    const bool ok_hi = ty0 + m_hi / TW < a.H && tx0 + m_hi % TW < a.W;

    for (int pass = 0; pass < Cout / 64; ++pass) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint2 b = bfrag[(ks * n8 + pass * 8 + nt) * 32 + lane];
          mma_bf16(acc[nt], af[ks], b.x, b.y);
        }
      // accumulator 2h + c of n8 block nt: pixel m_lo (h 0) or m_hi, column nt*8 + 2 t4 + c
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int nl = nt * 8 + 2 * t4, co = pass * 64 + nl;
        const float b0 = a.bias != nullptr ? a.bias[co] : 0.0f;
        const float b1 = a.bias != nullptr ? a.bias[co + 1] : 0.0f;
        const __nv_bfloat16 y00 = yval(a, acc[nt][0], b0), y01 = yval(a, acc[nt][1], b1);
        const __nv_bfloat16 y10 = yval(a, acc[nt][2], b0), y11 = yval(a, acc[nt][3], b1);
        *reinterpret_cast<uint32_t*>(&ost[m_lo * IN_OLD + nl]) = pack2(y00, y01);
        *reinterpret_cast<uint32_t*>(&ost[m_hi * IN_OLD + nl]) = pack2(y10, y11);
        if (!stats) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!(h ? ok_hi : ok_lo)) continue;
            const float z = acc[nt][2 * h + c];
            s1 += z;
            s2 += z * z;
            const __nv_bfloat16 yv = h ? (c ? y11 : y10) : (c ? y01 : y00);
            const float rv = a.range_mode == 2 ? __bfloat162float(yv) : z;
            hi = fmaxf(hi, rv);
            lo = fminf(lo, rv);
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
            hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
            lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
          }
          if (lane < 4) sred[warp * 64 + nl + c] = make_float4(s1, s2, hi, lo);
        }
      }
      __syncthreads();
      if (stats && tid < 64) {
        float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
#pragma unroll
        for (int w = 0; w < 8; ++w) {  // a fixed order
          const float4 r = sred[w * 64 + tid];
          s1 += r.x;
          s2 += r.y;
          hi = fmaxf(hi, r.z);
          lo = fminf(lo, r.w);
        }
        const size_t slot = ((size_t)bi * a.n_tiles + tt) * 2 * Cout + pass * 64 + tid;
        if (a.partial != nullptr) {
          a.partial[slot] = s1;
          a.partial[slot + Cout] = s2;
        }
        if (a.prange != nullptr) {
          a.prange[slot] = hi;
          a.prange[slot + Cout] = lo;
        }
      }
      // 16-byte stores: a thread stores chunk oc = tid & 7 of pixels tid / 8 +
      // 32 j; range mode 2 takes [max, min] of the values it stores, then
      // across the warp's lanes with the same oc, then across warps
      float hi[8], lo[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) hi[e] = -INFINITY, lo[e] = INFINITY;
      const int oc = tid & 7;
#pragma unroll
      for (int j = 0; j < IN_BM / 32; ++j) {
        const int m = (tid >> 3) + 32 * j;
        const int oy = ty0 + m / TW, ox = tx0 + m % TW;
        if (oy >= a.H || ox >= a.W) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(&ost[m * IN_OLD + oc * 8]);
        *reinterpret_cast<uint4*>(a.y + ((size_t)(bi * a.H + oy) * a.W + ox) * Cout +
                                  pass * 64 + oc * 8) = v;
        if (out_range) {
          const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            hi[e] = fmaxf(hi[e], __bfloat162float(vb[e]));
            lo[e] = fminf(lo[e], __bfloat162float(vb[e]));
          }
        }
      }
      if (out_range) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
#pragma unroll
          for (int off = 8; off < 32; off <<= 1) {
            hi[e] = fmaxf(hi[e], __shfl_xor_sync(0xffffffffu, hi[e], off));
            lo[e] = fminf(lo[e], __shfl_xor_sync(0xffffffffu, lo[e], off));
          }
          if (lane < 8) sred[warp * 64 + oc * 8 + e] = make_float4(0.0f, 0.0f, hi[e], lo[e]);
        }
        __syncthreads();
        if (tid < 64) {
          float h = -INFINITY, l = INFINITY;
#pragma unroll
          for (int w = 0; w < 8; ++w) {  // a fixed order
            const float4 r = sred[w * 64 + tid];
            h = fmaxf(h, r.z);
            l = fminf(l, r.w);
          }
          const size_t slot = ((size_t)bi * a.n_tiles + tt) * 2 * Cout + pass * 64 + tid;
          a.prange[slot] = h;
          a.prange[slot + Cout] = l;
        }
      }
      __syncthreads();  // ost and sred are free for the next pass
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, int& allowed) {
  if (allowed >= bytes) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return static_cast<int>(err);
}

template <int KS>
int launch_in(const Args& a, int blocks, cudaStream_t stream) {
  static int allowed = 0;  // above 48 KB only once the kernel allows it
  const int bytes = in_smem_bytes(KS, a.Cout);
  const int err = set_smem(conv3x3_narrow_in<KS>, bytes, allowed);
  if (err != 0) return err;
  conv3x3_narrow_in<KS><<<blocks, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (nb, H, W, Cin) bf16; w (3, 3, Cin, Cout) bf16; bias (Cout) fp32 or null;
// pro (nb, 2, Cin) fp32 or null; y (nb, H, W, Cout) bf16; partial and prange
// (nb, n_tiles, 2, Cout) fp32 or null; all pointers 16-byte aligned.
// Either Cout <= 8 with Cin % 64 == 0 and Cin <= 256 (the final conv: tiles
// of 4 x 64 pixels, tile_h and tile_w must say so), or Cin <= 8 with
// Cout % 64 == 0 and Cout <= 512 (the init conv: tiles of tile_h x tile_w
// == 128 pixels, (tile_h + 2) * (tile_w + 2) <= 264). n_tiles =
// ceil(H / tile_h) * ceil(W / tile_w). range_mode 1: [max, min] of the
// pre-bias fp32 z; 2: of the bf16 output. bias_in_dtype: y = bf16(bf16(z)
// + bf16(bias)). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernels do not take).
int kdt_conv3x3_narrow(const void* x, const void* w, const void* bias, const void* pro, void* y,
                       void* partial, void* prange, int nb, int H, int W, int Cin, int Cout,
                       int chunks, int tile_h, int tile_w, int range_mode, int bias_in_dtype,
                       void* stream) {
  const bool out = Cout >= 1 && Cout <= 8 && Cin % 64 == 0 && Cin >= 64 && Cin <= OUT_MAX_CIN &&
                   tile_h == OUT_TH && tile_w == OUT_TW;
  const bool in = Cin >= 1 && Cin <= 8 && Cout % 64 == 0 && Cout >= 64 &&
                  Cout <= IN_MAX_COUT && tile_h * tile_w == IN_BM && tile_w >= 1 &&
                  (tile_h + 2) * (tile_w + 2) <= IN_MAX_PATCH;
  if (!(out || in) || nb < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.pro = static_cast<const float*>(pro);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = static_cast<float*>(partial);
  a.prange = static_cast<float*>(prange);
  a.nb = nb;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.chunks = chunks;
  a.TH = tile_h;
  a.TW = tile_w;
  a.tiles_x = (W + tile_w - 1) / tile_w;
  a.n_tiles = a.tiles_x * ((H + tile_h - 1) / tile_h);
  a.range_mode = range_mode;
  a.bias_in_dtype = bias_in_dtype;
  const int total = nb * a.n_tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out) {
    static int allowed = 0;
    const int bytes = out_smem_bytes(Cin);
    const int err = set_smem(conv3x3_narrow_out, bytes, allowed);
    if (err != 0) return err;
    conv3x3_narrow_out<<<min(total, SMS), THREADS, bytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = min(total, 2 * SMS);
  if (Cin <= 3) return launch_in<2>(a, blocks, st);
  if (Cin <= 7) return launch_in<4>(a, blocks, st);
  return launch_in<5>(a, blocks, st);
}

const char* kdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
