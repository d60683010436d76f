// Fused EdgeLine linear attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel edgeyolo_tpu/ops/pallas/linear_attention.py
// (`_la_kernel`, launched by `_la_pallas`). Per (batch, head) pair, with
// q, k, v of shape (N, D):
//   k' = softmax over D of each row of k
//   q' = exp(q - max_N q) / (sum_N exp(q - max_N q) + 1e-9)   (per column)
//   ctx = k'^T v                                              (D x D, f32)
//   y = q' ctx, cast to the input type
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s f32
// outside the tensor cores). At the serving shape (B, N, H, D) =
// (32, 400, 2, 64) in bf16 the kernel must read q, k, v and write y once:
// 13.1 MB, 3.9 us. The two products are 4 B*H N D^2 = 0.42 GFLOP: 0.4 us on
// the tensor cores, 6.3 us on the CUDA cores. So the bytes bound the kernel,
// but only if (a) the blocks fill the card: B*H = 64 (batch, head) pairs
// for 132 SMs, and (b) the products do not run on the CUDA cores.
//
// Design. Two launches on the caller's stream.
//   Context phase, grid (B*H) x S. N is split into S chunks of whole
//     64-token tiles; the caller takes S as large as keeps the grid within
//     one wave of the blocks an SM holds (4 in bf16, 2 in f32, from the
//     occupancy calculator): 7 chunks, 448 blocks at the serving shape. A
//     block walks its chunk tile by tile: it loads k, v and q (16-byte
//     loads along the tokens where the layout allows, else one element per
//     load), row-softmaxes k over D (four threads per token, shuffle
//     reductions), folds the tile into an online column max and rescaled
//     sum of q (256 / D threads per column) and accumulates its partial
//     ctx = k'^T v: on the tensor cores (mma.sync, bf16 operands, f32
//     accumulation) for bf16 inputs at D = 32 and 64, with f32 FMAs for
//     f32 inputs and for the other head dims. It writes the partial ctx and
//     column statistics to an f32 workspace.
//   Merge, fixed order, no float atomics. Each block bumps an integer
//     counter of its (batch, head) after a __threadfence(); the block that
//     arrives last sums the S partials in the order s = 0 .. S-1, combines
//     the column statistics (max, and sums rescaled to it), folds
//     1 / (sum + 1e-9) into the rows of ctx, writes the finished ctx and
//     column max over partial 0 and resets the counter. The result is the
//     same bits from run to run.
//   Output phase, grid (B*H) x ceil(N / 64). A block stages the finished
//     ctx in shared memory, loads its q tile as exp(q - max) and writes
//     y = q' ctx (tensor cores in bf16 at D = 32 and 64, as above; FMAs
//     otherwise) through a shared-memory tile, so the stores walk the
//     unit-stride axis. It reads q a second time: 1.25x the least traffic,
//     mostly from L2 (q is 3.3 MB at the serving shape; L2 is 50 MB).
// Accumulation is always f32; inputs and outputs are f32 or bf16. The
// workspace is B*H*S*(D*D + 2*D) floats (7.6 MB at the serving shape); the
// caller allocates it and the B*H int32 counters, which are zero between
// launches, and may keep both for the launches on one stream.
//
// Layout. Every tensor is addressed through explicit element strides for
// (b, n, h, d), so the kernel reads q, k and v straight out of the NCHW
// output of the qkv 1x1 convolution (channel order [3][heads][head_dim],
// stride 1 along the tokens) and writes y as (B, H*D, N) without transpose
// copies. Shared-memory tiles are d-major (one row per head-dim index, the
// tokens contiguous).
//
// C interface, bound with ctypes (no PyTorch headers):
//   int edgeyolo_la_forward(q, k, v, y, workspace, counters, stream,
//                           const LaShape* shape)
// LaShape (below) holds what stays fixed for one input shape: dtype
// (0 = float32, 1 = bfloat16), head_dim (8, 16, 32, 48, 64, 96, 128 or 192), B, N, H,
// S, chunk (a multiple of 64 with S = ceil(N / chunk)), the device and the element
// strides (b, n, h, d) of q, k and v (one set) and of y. The caller builds
// it once per shape, so a call converts eight arguments. The launches go to
// `device` (made current for the call) on `stream`.
// Returns the first non-zero cudaError_t (0 on success).
//   int edgeyolo_la_forward_marked(q, k, v, y, workspace, counters, stream,
//                                  const LaShape* shape, void* const* events)
// is the same call with three cudaEvent_t recorded on the stream: before the
// context launch, between the two launches and after the output launch, so
// a caller can time each phase with its own event pair.
//   int edgeyolo_la_blocks_per_sm(int dtype, int head_dim, device)
// returns the context blocks one SM holds at once (negative: -cudaError_t).
//
// Head dims. The tensor-core tiles cover D = 32 and 64 (the C2PSA stage);
// MSLA's quarters give D = 8 and 16 at scale n, 48 and 96 at scale x, which
// take the FMA products: a simple path, right first. At D = 8 one thread
// holds no whole row of ctx, so the 64 entries are split over the tile's
// tokens four ways and summed through shared memory; the q statistics use
// the largest power-of-two group of threads per column that fits (32 at
// D = 8, 2 at D = 96), and threads past the last column repeat it and
// store nothing. At D = 96 the D x D context tile of the output phase is
// wider than a token tile (row pitch D + 4), and the output kernel's two
// tiles exceed 48 KB, so both kernels take their tiles as opted-in dynamic
// shared memory.
//
// The wavelet HyperACE's LL-band attention (yolov13-test) gives D = 128 at
// scale l and 192 at x, over 100 tokens at 640 px and 1 at 64 px. Both take
// the FMA products, the simple path: each thread owns D * D / 256 = 64 or
// 144 context accumulators, so the products read k' and v one token at a
// time (scalar loads, the accumulators leave no registers for float4s) and
// the context kernel asks for one block per SM, not two; the q statistics
// take two threads per column and, at 192, two passes of 128 columns; the
// merge sums its float4 rounds four at a time over the partials. The
// shared tiles take 102 and 153 KiB in the context kernel, 100 and 198 KiB
// in the output kernel (the D x D context at pitch D + 4 and the q tile),
// within the 227 KiB a block may opt in to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct LaShape {
  int dtype, head_dim, B, N, H, S, chunk, device;
  long long in[4], out[4];  // element strides along (b, n, h, d) of q, k, v and of y
};

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 64;          // tokens per tile
constexpr int kPitch = kTileN + 4;  // f32 row pitch: 16-byte rows, an odd number of 16-byte units
// Row pitch of the D x D context tile of the output phase: kPitch while
// D <= kTileN, else D + 4.
template <int D>
constexpr int kCtxPitch = (D > kTileN ? D : kTileN) + 4;

struct Strides {
  long long b, n, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// exp for f32 inputs is the accurate expf (their tolerance is 1e-5 of the
// output scale); for bf16 inputs, whose outputs keep 8 bits, it is one MUFU
// ex2 (__expf, a few ulp near 0).
template <typename T>
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
template <>
__device__ __forceinline__ float exp_t<__nv_bfloat16>(float x) { return __expf(x); }

__device__ __forceinline__ float shfl_xor(float x, int mask) {
  return __shfl_xor_sync(0xffffffffu, x, mask);
}

// Load the D x kTileN tile of tokens n0 .. n0 + kTileN - 1 of src into shared
// memory as f32 (row d at s + d * kPitch). Tokens at or past n_end get
// `fill`; the others go through f(d, x). `vec`: the tokens are the
// unit-stride axis and every 16-byte group of them is aligned and whole.
template <typename T, int D, typename F>
__device__ __forceinline__ void load_tile(float* __restrict__ s, const T* __restrict__ src,
                                          long long base, const Strides& st, int n0, int n_end,
                                          bool vec, float fill, F f) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    constexpr int kPerRow = kTileN / V;
    for (int i = threadIdx.x; i < D * kPerRow; i += kThreads) {
      const int d = i / kPerRow;
      const int r = (i % kPerRow) * V;
      const int n = n0 + r;
      float x[V];
      if (n < n_end) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + base + n + d * st.d);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < V; ++j) x[j] = f(d, to_f32(e[j]));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) x[j] = fill;
      }
      float4* dst = reinterpret_cast<float4*>(s + d * kPitch + r);
#pragma unroll
      for (int j = 0; j < V / 4; ++j)
        dst[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    }
  } else {  // one element per load, neighbouring threads on the unit-stride axis
    const bool n_fastest = st.n == 1;
    for (int i = threadIdx.x; i < D * kTileN; i += kThreads) {
      const int r = n_fastest ? i % kTileN : i / D;
      const int d = n_fastest ? i / kTileN : i % D;
      const int n = n0 + r;
      s[d * kPitch + r] = n < n_end ? f(d, to_f32(src[base + n * st.n + d * st.d])) : fill;
    }
  }
}

// Store the D x kTileN f32 tile s (row pitch kPitch) to tokens n0 .. of dst.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const float* __restrict__ s,
                                           long long base, const Strides& st, int n0, int N,
                                           bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    constexpr int kPerRow = kTileN / V;
    for (int i = threadIdx.x; i < D * kPerRow; i += kThreads) {
      const int d = i / kPerRow;
      const int r = (i % kPerRow) * V;
      const int n = n0 + r;
      if (n >= N) continue;
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) store_f32(e + j, s[d * kPitch + r + j]);
      *reinterpret_cast<uint4*>(dst + base + n + d * st.d) = u;
    }
  } else {
    const bool n_fastest = st.n == 1;
    for (int i = threadIdx.x; i < D * kTileN; i += kThreads) {
      const int r = n_fastest ? i % kTileN : i / D;
      const int d = n_fastest ? i / kTileN : i % D;
      const int n = n0 + r;
      if (n < N) store_f32(dst + base + n * st.n + d * st.d, s[d * kPitch + r]);
    }
  }
}

// The products. Each thread holds D * D / kThreads = D * kTileN / kThreads / 4
// accumulators in both (one at D = 8): f32 FMAs on the CUDA cores for f32
// inputs (their tolerance, 1e-5 of the output scale, takes no bf16
// rounding) and for bf16 inputs at D other than 32 and 64, and mma.sync
// m16n8k16 on the tensor cores for bf16 inputs at D = 32 and 64, with bf16
// operands rounded once from the f32 tiles while the fragments are built and
// f32 accumulation. Fragment layouts are those of the PTX ISA for
// mma.m16n8k16 .row.col: lane = 4 g + t; A (16 x 16) registers hold rows
// g, g + 8 and columns 2t, 2t + 1 (+ 8); B (16 x 8) rows 2t, 2t + 1 (+ 8) of
// column g; C rows g, g + 8 and columns 2t, 2t + 1.
template <typename T, int D>
constexpr bool kTensorCores = false;
template <>
constexpr bool kTensorCores<__nv_bfloat16, 32> = true;
template <>
constexpr bool kTensorCores<__nv_bfloat16, 64> = true;

template <int D>
constexpr bool kHeadDim = D == 8 || D == 16 || D == 32 || D == 48 || D == 64 || D == 96 ||
                          D == 128 || D == 192;

// Threads that share one column of q in its statistics: the largest power of
// two that keeps a column for each group (32 at D = 8, 4 at D = 48 and 64,
// 2 from D = 96); and the passes over the columns this takes (2 at D = 192,
// else 1).
template <int D>
constexpr int kColThreads = kThreads / D >= 32  ? 32
                            : kThreads / D >= 16 ? 16
                            : kThreads / D >= 8  ? 8
                            : kThreads / D >= 4  ? 4
                                                 : 2;
template <int D>
constexpr int kColPasses = (D * kColThreads<D> + kThreads - 1) / kThreads;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(const float* p) {  // p[0], p[1]; 8-byte aligned
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16(x.x, x.y);
}

// d += a b, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ctx[d][e] += sum over the tile's tokens r of ks[d][r] vs[e][r]. FMA path:
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j, and sums the
// tokens in order. At D = 8 the D * D entries take kThreads / (D * D)
// threads each: thread t sums entry t % (D * D) over the tokens of its
// share t / (D * D) of the tile. Above D = 96 the tokens are read one at a
// time (float4 operands would not fit beside the accumulators).
template <int D>
__device__ __forceinline__ void ctx_fma(const float* ks, const float* vs, float* acc) {
  if constexpr (D < 16) {
    constexpr int kShare = kTileN * D * D / kThreads;  // tokens of one thread
    const int e = threadIdx.x % (D * D);
    const int r0 = threadIdx.x / (D * D) * kShare;
    const float* kr = ks + e / D * kPitch + r0;
    const float* vr = vs + e % D * kPitch + r0;
#pragma unroll
    for (int r = 0; r < kShare; r += 4) {
      const float4 a = *reinterpret_cast<const float4*>(kr + r);
      const float4 b = *reinterpret_cast<const float4*>(vr + r);
      acc[0] = fmaf(a.x, b.x, acc[0]);
      acc[0] = fmaf(a.y, b.y, acc[0]);
      acc[0] = fmaf(a.z, b.z, acc[0]);
      acc[0] = fmaf(a.w, b.w, acc[0]);
    }
  } else if constexpr (D > 96) {
    constexpr int R = D / 16;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll 2
    for (int r = 0; r < kTileN; ++r) {
      float kr[R], vr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) kr[i] = ks[(ty + 16 * i) * kPitch + r];
#pragma unroll
      for (int j = 0; j < R; ++j) vr[j] = vs[(tx + 16 * j) * kPitch + r];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i * R + j] = fmaf(kr[i], vr[j], acc[i * R + j]);
    }
  } else {
    constexpr int R = D / 16;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll 4
    for (int r = 0; r < kTileN; r += 4) {
      float4 kr[R], vr[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        kr[i] = *reinterpret_cast<const float4*>(ks + (ty + 16 * i) * kPitch + r);
#pragma unroll
      for (int j = 0; j < R; ++j)
        vr[j] = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * kPitch + r);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          float& a = acc[i * R + j];
          a = fmaf(kr[i].x, vr[j].x, a);
          a = fmaf(kr[i].y, vr[j].y, a);
          a = fmaf(kr[i].z, vr[j].z, a);
          a = fmaf(kr[i].w, vr[j].w, a);
        }
    }
  }
}

// `red` is kThreads floats of shared memory, free to use (D = 8 sums the
// token shares there; every thread calls this).
template <int D>
__device__ __forceinline__ void store_ctx_fma(float* part, const float* acc, float* red) {
  if constexpr (D < 16) {
    red[threadIdx.x] = acc[0];
    __syncthreads();
    if (threadIdx.x < D * D) {
      float sum = 0.f;
#pragma unroll
      for (int i = threadIdx.x; i < kThreads; i += D * D) sum += red[i];
      part[threadIdx.x] = sum;
    }
  } else {
    constexpr int R = D / 16;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) part[(ty + 16 * i) * D + tx + 16 * j] = acc[i * R + j];
  }
}

// Tensor-core path: M = d, N = e, K = tokens. A = k' (row-major: a row of
// ks is one d over the tokens), B = v (column e of B is the row e of vs).
// The (D / 16) x (D / 8) output tiles go to the 8 warps: warp w owns m-tile
// w / kWarpsPerM and kN n-tiles from (w % kWarpsPerM) * kN.
template <int D>
struct CtxTiles {
  static constexpr int kN = D * D / 1024;  // 4 (D = 64), 1 (D = 32)
  static constexpr int kWarpsPerM = D / 8 / kN;
};

template <int D>
__device__ __forceinline__ void ctx_mma(const float* ks, const float* vs, float* acc) {
  constexpr int kN = CtxTiles<D>::kN;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int m0 = warp / CtxTiles<D>::kWarpsPerM * 16;
  const int e0 = warp % CtxTiles<D>::kWarpsPerM * kN * 8;
#pragma unroll
  for (int k0 = 0; k0 < kTileN; k0 += 16) {
    const float* ar = ks + (m0 + g) * kPitch + k0 + 2 * t;
    const uint32_t a[4] = {pack_bf16(ar), pack_bf16(ar + 8 * kPitch), pack_bf16(ar + 8),
                           pack_bf16(ar + 8 * kPitch + 8)};
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float* br = vs + (e0 + 8 * j + g) * kPitch + k0 + 2 * t;
      const uint32_t b[2] = {pack_bf16(br), pack_bf16(br + 8)};
      mma_bf16(acc + 4 * j, a, b);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_ctx_mma(float* part, const float* acc) {
  constexpr int kN = CtxTiles<D>::kN;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int m0 = warp / CtxTiles<D>::kWarpsPerM * 16;
  const int e0 = warp % CtxTiles<D>::kWarpsPerM * kN * 8;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float* c = part + (m0 + g) * D + e0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(c + 8 * D) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// y[r][e] = sum over d of qs[d][r] ctx[d][e] for the tile's 64 tokens, qs
// with row pitch kPitch and ctx with kCtxPitch<D>, written to ys[e][r]
// (pitch kPitch; it may alias qs: every read is done before the first
// write). FMA path: thread (a, c) owns
// columns c + kCols j (kCols = 16, or D when D < 16) and the kTok tokens
// from kTok a (4 tokens, 2 at D = 8).
template <int D>
__device__ __forceinline__ void y_fma(const float* qs, const float* ctx, float* ys) {
  constexpr int kCols = D < 16 ? D : 16;
  constexpr int R = D / kCols;
  constexpr int kTok = kTileN * kCols / kThreads;
  static_assert(kTok == 4 || kTok == 2, "4 or 2 tokens a thread");
  const int a = threadIdx.x / kCols;
  const int c = threadIdx.x % kCols;
  float out[kTok][R];
#pragma unroll
  for (int i = 0; i < kTok; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float p[kTok];
    if constexpr (kTok == 4) {
      const float4 x = *reinterpret_cast<const float4*>(qs + d * kPitch + 4 * a);
      p[0] = x.x, p[1] = x.y, p[2] = x.z, p[3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(qs + d * kPitch + 2 * a);
      p[0] = x.x, p[1] = x.y;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float w = ctx[d * kCtxPitch<D> + c + kCols * j];
#pragma unroll
      for (int i = 0; i < kTok; ++i) out[i][j] = fmaf(p[i], w, out[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float* dst = ys + (c + kCols * j) * kPitch + kTok * a;
    if constexpr (kTok == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(out[0][j], out[1][j], out[2][j], out[3][j]);
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(out[0][j], out[1][j]);
    }
  }
}

// Tensor-core path: M = tokens, N = e, K = d. A = q' (element (r, d) is
// qs[d][r]), B = ctx. Warp w owns the m-tile w / 2 and D / 16 n-tiles.
template <int D>
__device__ __forceinline__ void y_mma(const float* qs, const float* ctx, float* ys) {
  constexpr int kN = D / 16;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int m0 = warp / 2 * 16;
  const int e0 = warp % 2 * kN * 8;
  float acc[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    const float* ac = qs + (k0 + 2 * t) * kPitch + m0 + g;
    const uint32_t a[4] = {pack_bf16(ac[0], ac[kPitch]), pack_bf16(ac[8], ac[kPitch + 8]),
                           pack_bf16(ac[8 * kPitch], ac[9 * kPitch]),
                           pack_bf16(ac[8 * kPitch + 8], ac[9 * kPitch + 8])};
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      constexpr int P = kCtxPitch<D>;
      const float* bc = ctx + (k0 + 2 * t) * P + e0 + 8 * j + g;
      const uint32_t b[2] = {pack_bf16(bc[0], bc[P]), pack_bf16(bc[8 * P], bc[9 * P])};
      mma_bf16(acc[j], a, b);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float* c = ys + (e0 + 8 * j + 2 * t) * kPitch + m0 + g;
    c[0] = acc[j][0];
    c[kPitch] = acc[j][1];
    c[8] = acc[j][2];
    c[kPitch + 8] = acc[j][3];
  }
}

// Context phase and merge; block (bh, s) owns tokens [s * chunk, (s + 1) * chunk).
// The tensor-core kernel is held to 64 registers a thread, so that four
// blocks fit an SM and the serving shape's 448 blocks run in one wave; above
// D = 96 the accumulators take what one block per SM allows.
template <typename T, int D>
constexpr int kMinBlocks = kTensorCores<T, D> ? 4 : D > 96 ? 1 : 2;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, D>)
la_context_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  float* __restrict__ ws, int* __restrict__ counters, int H, int N, int S,
                  int chunk, Strides si, bool vec) {
  static_assert(kHeadDim<D>, "head_dim must be 8, 16, 32, 48, 64, 96, 128 or 192");
  constexpr int kAcc = D * D >= kThreads ? D * D / kThreads : 1;  // ctx accumulators per thread
  constexpr int kTpc = kColThreads<D>;  // threads per column of q
  constexpr int kWs = D * D + 2 * D;  // floats per partial: ctx, column max, column sum
  extern __shared__ float4 smem[];    // three D x kPitch f32 tiles
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + D * kPitch;
  float* qs = vs + D * kPitch;
  __shared__ float inv_sum[D];
  __shared__ bool last;

  const int bh = blockIdx.x;
  const int s = blockIdx.y;
  const long long in0 = (bh / H) * si.b + (bh % H) * si.h;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_begin = s * chunk;
  const int n_end = min(N, n_begin + chunk);

  // softmax of k: token sr of the tile; quarter sp of the head dim, chosen
  // so that the 32 lanes of a warp hit 32 distinct banks
  const int sr = warp * 8 + lane % 8;
  const int sp = lane / 8;
  // statistics of q: in pass p, column qc0 + p * kThreads / kTpc, rows qp,
  // qp + kTpc, ...; the groups past the last column (D = 48, 96, 192) repeat
  // it and store nothing
  constexpr int kPasses = kColPasses<D>;
  const int qc0 = warp * (32 / kTpc) + lane / kTpc;
  const int qp = lane % kTpc;

  float m_run[kPasses], s_run[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) m_run[p] = -INFINITY, s_run[p] = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const auto identity = [](int, float x) { return x; };
  for (int n0 = n_begin; n0 < n_end; n0 += kTileN) {
    // tokens past the chunk: k' and v are 0 (no weight), q is -inf (no mass)
    load_tile<T, D>(ks, k, in0, si, n0, n_end, vec, 0.f, identity);
    load_tile<T, D>(vs, v, in0, si, n0, n_end, vec, 0.f, identity);
    load_tile<T, D>(qs, q, in0, si, n0, n_end, vec, -INFINITY, identity);
    __syncthreads();
    {
      constexpr int J = D / 4;
      float x[J];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        x[j] = ks[(2 * sp + (j & 1) + 8 * (j >> 1)) * kPitch + sr];
        m = fmaxf(m, x[j]);
      }
      m = fmaxf(m, shfl_xor(m, 8));
      m = fmaxf(m, shfl_xor(m, 16));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        x[j] = exp_t<T>(x[j] - m);
        sum += x[j];
      }
      sum += shfl_xor(sum, 8);
      sum += shfl_xor(sum, 16);
      const float inv = 1.f / sum;
#pragma unroll
      for (int j = 0; j < J; ++j) ks[(2 * sp + (j & 1) + 8 * (j >> 1)) * kPitch + sr] = x[j] * inv;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      // the tile's first token is a real one, so the tile max is finite
      constexpr int J = kTileN / kTpc;
      const float* col = qs + min(qc0 + p * (kThreads / kTpc), D - 1) * kPitch + qp;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j) m = fmaxf(m, col[kTpc * j]);
#pragma unroll
      for (int o = 1; o < kTpc; o <<= 1) m = fmaxf(m, shfl_xor(m, o));
      const float m_new = fmaxf(m_run[p], m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) sum += exp_t<T>(col[kTpc * j] - m_new);
#pragma unroll
      for (int o = 1; o < kTpc; o <<= 1) sum += shfl_xor(sum, o);
      s_run[p] = s_run[p] * exp_t<T>(m_run[p] - m_new) + sum;
      m_run[p] = m_new;
    }
    __syncthreads();
    if constexpr (kTensorCores<T, D>) {
      ctx_mma<D>(ks, vs, acc);
    } else {
      ctx_fma<D>(ks, vs, acc);
    }
    __syncthreads();
  }

  float* part = ws + (static_cast<long long>(bh) * S + s) * kWs;
  if constexpr (kTensorCores<T, D>) {
    store_ctx_mma<D>(part, acc);
  } else {
    store_ctx_fma<D>(part, acc, ks);  // the tiles are free after the loop's last barrier
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int qc = qc0 + p * (kThreads / kTpc);
    if (qp == 0 && qc < D) {
      part[D * D + qc] = m_run[p];
      part[D * D + D + qc] = s_run[p];
    }
  }
  __threadfence();  // this block's partial is visible before its arrival is counted
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + bh, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last block of this (batch, head) merges the partials, s = 0 .. S-1,
  // reading them from L2 (__ldcg, past this SM's L1). Every thread sums
  // float4 columns tid, tid + kThreads, ... of ctx (those that exist: at
  // D = 8, 16 and 48 the last round is partial), kGroup rounds per pass over
  // the partials (all of them up to D = 96, four above); beside the first
  // pass, threads tid < D fold the column statistics in one online pass
  // (max, and the sum rescaled to it). The loads of a partial do not wait on
  // the previous one. Each thread writes back only the columns it read.
  float* fin = ws + static_cast<long long>(bh) * S * kWs;  // partial 0 takes the result
  constexpr int kVec4 = D * D / 4;                       // float4s of ctx
  constexpr int kVec = (kVec4 + kThreads - 1) / kThreads;  // rounds over them
  constexpr int kGroup = D > 96 ? 4 : kVec;
  float m = -INFINITY, sum = 0.f;
  for (int g0 = 0; g0 < kVec; g0 += kGroup) {
    float4 c[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) c[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int t = 0; t < S; ++t) {
      const float* p = fin + t * kWs;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (tid + (g0 + u) * kThreads >= kVec4) break;
        const float4 x = __ldcg(reinterpret_cast<const float4*>(p) + tid + (g0 + u) * kThreads);
        c[u].x += x.x;
        c[u].y += x.y;
        c[u].z += x.z;
        c[u].w += x.w;
      }
      if (g0 == 0 && tid < D) {
        const float mt = __ldcg(p + D * D + tid);
        const float st = __ldcg(p + D * D + D + tid);
        const float m_new = fmaxf(m, mt);
        sum = sum * exp_t<T>(m - m_new) + st * exp_t<T>(mt - m_new);
        m = m_new;
      }
    }
    if (g0 == 0) {
      if (tid < D) {
        inv_sum[tid] = 1.f / (sum + 1e-9f);
        fin[D * D + tid] = m;
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (tid + (g0 + u) * kThreads >= kVec4) break;
      const int i = 4 * (tid + (g0 + u) * kThreads);
      const float inv = inv_sum[i / D];  // the 4 columns share row i / D
      reinterpret_cast<float4*>(fin)[tid + (g0 + u) * kThreads] =
          make_float4(c[u].x * inv, c[u].y * inv, c[u].z * inv, c[u].w * inv);
    }
  }
  if (tid == 0) counters[bh] = 0;
}

// Output phase; block (bh, t) writes tokens [64 t, 64 t + 64).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
la_output_kernel(const T* __restrict__ q, const float* __restrict__ ws, T* __restrict__ y,
                 int H, int N, int S, Strides si, Strides so, bool vec_in, bool vec_out) {
  constexpr int kWs = D * D + 2 * D;
  extern __shared__ float4 smem[];  // the D x D context, the D x kTileN q tile
  float* ctx = reinterpret_cast<float*>(smem);
  float* qs = ctx + D * kCtxPitch<D>;  // exp(q - max), then the y tile
  __shared__ float col_m[D];

  const int bh = blockIdx.x;
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const float* fin = ws + static_cast<long long>(bh) * S * kWs;
  for (int i = tid; i < D * D / 4; i += kThreads)
    *reinterpret_cast<float4*>(ctx + i / (D / 4) * kCtxPitch<D> + i % (D / 4) * 4) =
        reinterpret_cast<const float4*>(fin)[i];
  if (tid < D) col_m[tid] = fin[D * D + tid];
  __syncthreads();
  const long long in0 = (bh / H) * si.b + (bh % H) * si.h;
  load_tile<T, D>(qs, q, in0, si, n0, N, vec_in, 0.f,
                  [&](int d, float x) { return exp_t<T>(x - col_m[d]); });
  __syncthreads();

  if constexpr (kTensorCores<T, D>) {
    y_mma<D>(qs, ctx, qs);
  } else {
    y_fma<D>(qs, ctx, qs);
  }
  __syncthreads();
  const long long out0 = (bh / H) * so.b + (bh % H) * so.h;
  store_tile<T, D>(y, qs, out0, so, n0, N, vec_out);
}

struct Args {
  const void *q, *k, *v;
  void* y;
  float* ws;
  int* counters;
  int B, N, H, S, chunk;
  Strides si, so;
  cudaStream_t stream;
  int device;
  const cudaEvent_t* marks = nullptr;  // start, between the launches, end (optional)
};

// Tokens are the unit-stride axis and every 16-byte group of them is aligned and whole.
bool vectorizable(const Strides& st, int N, int V, const void* const* ptrs, int n_ptrs) {
  if (st.n != 1 || N % V || st.d % V || st.h % V || st.b % V) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

template <int D>
constexpr int kContextSmem = 3 * D * kPitch * sizeof(float);
template <int D>
constexpr int kOutputSmem = D * (kCtxPitch<D> + kPitch) * sizeof(float);

// More than 48 KB of dynamic shared memory needs an opt-in, once per kernel
// and device (the context kernel from D = 64, the output kernel from D = 96).
template <typename T, int D>
cudaError_t allow_smem(int device) {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && allowed[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      la_context_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kContextSmem<D>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(la_output_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kOutputSmem<D>);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) allowed[device] = true;
  return err;
}

template <typename T, int D>
cudaError_t context_blocks_per_sm(int device, int* blocks) {
  const cudaError_t err = allow_smem<T, D>(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, la_context_kernel<T, D>, kThreads,
                                                       kContextSmem<D>);
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kSmem = kContextSmem<D>;
  const void* in_ptrs[3] = {a.q, a.k, a.v};
  const void* out_ptrs[1] = {a.y};
  const bool vec_in = vectorizable(a.si, a.N, V, in_ptrs, 3);
  const bool vec_out = vectorizable(a.so, a.N, V, out_ptrs, 1);
  const T* q = static_cast<const T*>(a.q);
  const int tiles = (a.N + kTileN - 1) / kTileN;
  if (a.chunk <= 0 || a.chunk % kTileN || a.S != (a.N + a.chunk - 1) / a.chunk || a.S > 65535 ||
      tiles > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T, D>(a.device);
  if (err == cudaSuccess && a.marks) err = cudaEventRecord(a.marks[0], a.stream);
  if (err != cudaSuccess) return err;
  la_context_kernel<T, D><<<dim3(a.B * a.H, a.S), kThreads, kSmem, a.stream>>>(
      q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.ws, a.counters, a.H, a.N,
      a.S, a.chunk, a.si, vec_in);
  err = cudaGetLastError();
  if (err == cudaSuccess && a.marks) err = cudaEventRecord(a.marks[1], a.stream);
  if (err != cudaSuccess) return err;
  la_output_kernel<T, D><<<dim3(a.B * a.H, tiles), kThreads, kOutputSmem<D>, a.stream>>>(
      q, a.ws, static_cast<T*>(a.y), a.H, a.N, a.S, a.si, a.so, vec_in, vec_out);
  err = cudaGetLastError();
  if (err == cudaSuccess && a.marks) err = cudaEventRecord(a.marks[2], a.stream);
  return err;
}

template <typename T>
cudaError_t launch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 8: return launch<T, 8>(a);
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 48: return launch<T, 48>(a);
    case 64: return launch<T, 64>(a);
    case 96: return launch<T, 96>(a);
    case 128: return launch<T, 128>(a);
    case 192: return launch<T, 192>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t blocks_dim(int head_dim, int device, int* blocks) {
  switch (head_dim) {
    case 8: return context_blocks_per_sm<T, 8>(device, blocks);
    case 16: return context_blocks_per_sm<T, 16>(device, blocks);
    case 32: return context_blocks_per_sm<T, 32>(device, blocks);
    case 48: return context_blocks_per_sm<T, 48>(device, blocks);
    case 64: return context_blocks_per_sm<T, 64>(device, blocks);
    case 96: return context_blocks_per_sm<T, 96>(device, blocks);
    case 128: return context_blocks_per_sm<T, 128>(device, blocks);
    case 192: return context_blocks_per_sm<T, 192>(device, blocks);
  }
  return cudaErrorInvalidValue;
}

// Run f() with `device` current, then make the caller's device current again.
template <typename F>
cudaError_t on_device(int device, F f) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = f();
  if (current != device) {
    const cudaError_t restored = cudaSetDevice(current);
    if (err == cudaSuccess) err = restored;
  }
  return err;
}

}  // namespace

// Blocks of the context kernel that one SM holds at once (the split of N
// aims at one wave of them); a negative cudaError_t on failure.
extern "C" int edgeyolo_la_blocks_per_sm(int dtype, int head_dim, int device) {
  int blocks = 0;
  using bf16 = __nv_bfloat16;
  const cudaError_t err = on_device(device, [&]() -> cudaError_t {
    if (dtype == 0) return blocks_dim<float>(head_dim, device, &blocks);
    if (dtype == 1) return blocks_dim<bf16>(head_dim, device, &blocks);
    return cudaErrorInvalidValue;
  });
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

extern "C" int edgeyolo_la_forward_marked(const void* q, const void* k, const void* v, void* y,
                                          void* workspace, void* counters, void* stream,
                                          const LaShape* shape, void* const* events) {
  const LaShape& p = *shape;
  if (p.B <= 0 || p.N <= 0 || p.H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, y, static_cast<float*>(workspace), static_cast<int*>(counters),
               p.B, p.N, p.H, p.S, p.chunk, Strides{p.in[0], p.in[1], p.in[2], p.in[3]},
               Strides{p.out[0], p.out[1], p.out[2], p.out[3]}, static_cast<cudaStream_t>(stream),
               p.device, reinterpret_cast<const cudaEvent_t*>(events)};
  return static_cast<int>(on_device(p.device, [&]() -> cudaError_t {
    if (p.dtype == 0) return launch_dim<float>(p.head_dim, a);
    if (p.dtype == 1) return launch_dim<__nv_bfloat16>(p.head_dim, a);
    return cudaErrorInvalidValue;
  }));
}

extern "C" int edgeyolo_la_forward(const void* q, const void* k, const void* v, void* y,
                                   void* workspace, void* counters, void* stream,
                                   const LaShape* shape) {
  return edgeyolo_la_forward_marked(q, k, v, y, workspace, counters, stream, shape, nullptr);
}
