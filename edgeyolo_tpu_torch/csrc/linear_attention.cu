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
// Design. The TPU kernel holds a whole (N, D) block in VMEM, which is why it
// could not run N = 6400. Here one thread block owns one (batch, head) and
// sweeps N in tiles of kTileN tokens, twice:
//   pass 1 reads k, v and q tiles; it row-softmaxes k in shared memory,
//          accumulates ctx in registers (a 16 x 16 thread grid, R x R values
//          per thread) and keeps an online max and rescaled sum per column
//          of q;
//   pass 2 folds 1 / (sum + 1e-9) into the rows of ctx, re-reads q, and
//          writes y = exp(q - max) ctx through a shared-memory tile so that
//          the stores are coalesced.
// Accumulation is always f32; inputs and outputs are f32 or bf16.
//
// Layout. Every tensor is addressed through explicit element strides for
// (b, n, h, d), so the kernel reads q, k and v straight out of the NCHW
// output of the qkv 1x1 convolution (channel order [3][heads][head_dim],
// stride 1 along the tokens) and writes y as (B, H*D, N) without transpose
// copies. Tile loads and stores walk the unit-stride axis with neighbouring
// threads.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16). At
// (B, N, H, D) = (128, 400, 2, 64) in bf16 the kernel must read q, k, v and
// write y: 4 x 256 x 400 x 64 x 2 B = 52.4 MB, about 16 us. The two products
// are 4 x B*H x N x D^2 = 1.7 GFLOP, under 2 us at the bf16 tensor rate, so
// the kernel is memory-bound. Pass 2 re-reads q, 1.25x the minimum traffic;
// removing it (keeping q on chip, TMA loads, wgmma for the products) is
// later work.
//
// C interface, bound with ctypes (no PyTorch headers):
//   int edgeyolo_la_forward(int dtype, int head_dim, q, k, v, y, B, N, H,
//                           in strides (b, n, h, d), out strides (b, n, h, d),
//                           stream)
// dtype 0 = float32, 1 = bfloat16; head_dim 32 or 64; q, k and v share one
// set of strides. Returns the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 32;
constexpr int kStatThread0 = 128;  // first thread of the q column statistics

struct Strides {
  long long b, n, h, d;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Element i of a kTileN x D tile as (row r, column c), with neighbouring i on
// the unit-stride axis of the tensor.
template <int D>
__device__ __forceinline__ void tile_coord(int i, bool n_fastest, int& r, int& c) {
  if (n_fastest) {
    r = i % kTileN;
    c = i / kTileN;
  } else {
    r = i / D;
    c = i % D;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
la_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ y, int H, int N, Strides si, Strides so) {
  static_assert(D % 16 == 0 && D <= 64, "head_dim must be 32 or 64");
  static_assert(kStatThread0 + D <= kThreads && kTileN <= kStatThread0, "thread roles overlap");
  constexpr int P = D + 1;            // padded row pitch: a column walk hits distinct banks
  constexpr int R = D / 16;           // ctx rows and columns per thread
  constexpr int RN = kTileN / 16;     // output rows per thread in pass 2
  __shared__ float ks[kTileN * P];    // k' tile; the y tile in pass 2
  __shared__ float vs[kTileN * P];
  __shared__ float qs[kTileN * P];    // q tile; exp(q - max) in pass 2
  __shared__ float ctx[D * P];
  __shared__ float col_m[D];
  __shared__ float col_s[D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long in0 = b * si.b + h * si.h;
  const long long out0 = b * so.b + h * so.h;
  const bool in_n_fastest = si.n == 1;
  const bool out_n_fastest = so.n == 1;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  if (tid < D) {
    col_m[tid] = -INFINITY;
    col_s[tid] = 0.f;
  }
  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  // ---- pass 1: ctx = softmax_D(k)^T v, column max and sum of q ----
  for (int n0 = 0; n0 < N; n0 += kTileN) {
    for (int i = tid; i < kTileN * D; i += kThreads) {
      int r, c;
      tile_coord<D>(i, in_n_fastest, r, c);
      const int n = n0 + r;
      float kv = 0.f, vv = 0.f, qv = -INFINITY;  // rows past N: no weight, no mass
      if (n < N) {
        const long long off = in0 + n * si.n + c * si.d;
        kv = load_f32(k + off);
        vv = load_f32(v + off);
        qv = load_f32(q + off);
      }
      ks[r * P + c] = kv;
      vs[r * P + c] = vv;
      qs[r * P + c] = qv;
    }
    __syncthreads();
    if (tid < kTileN) {
      if (n0 + tid < N) {  // a row past N keeps k' = 0
        float* row = ks + tid * P;
        float m = -INFINITY;
        for (int c = 0; c < D; ++c) m = fmaxf(m, row[c]);
        float s = 0.f;
        for (int c = 0; c < D; ++c) {
          const float e = expf(row[c] - m);
          row[c] = e;
          s += e;
        }
        const float inv = 1.f / s;
        for (int c = 0; c < D; ++c) row[c] *= inv;
      }
    } else if (tid >= kStatThread0 && tid < kStatThread0 + D) {
      // row 0 of every tile is a real token, so the tile max is finite
      const int c = tid - kStatThread0;
      float tm = -INFINITY;
      for (int r = 0; r < kTileN; ++r) tm = fmaxf(tm, qs[r * P + c]);
      const float m_old = col_m[c];
      const float m_new = fmaxf(m_old, tm);
      float s = col_s[c] * expf(m_old - m_new);
      for (int r = 0; r < kTileN; ++r) s += expf(qs[r * P + c] - m_new);
      col_m[c] = m_new;
      col_s[c] = s;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTileN; ++r) {
      float kr[R], vr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) kr[i] = ks[r * P + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < R; ++j) vr[j] = vs[r * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(kr[i], vr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ctx row d scaled by 1 / (sum_N exp(q[:, d] - max) + 1e-9)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int d = ty + 16 * i;
    const float inv = 1.f / (col_s[d] + 1e-9f);
#pragma unroll
    for (int j = 0; j < R; ++j) ctx[d * P + tx + 16 * j] = acc[i][j] * inv;
  }
  __syncthreads();

  // ---- pass 2: y = exp(q - max) ctx ----
  for (int n0 = 0; n0 < N; n0 += kTileN) {
    for (int i = tid; i < kTileN * D; i += kThreads) {
      int r, c;
      tile_coord<D>(i, in_n_fastest, r, c);
      const int n = n0 + r;
      qs[r * P + c] = n < N ? expf(load_f32(q + in0 + n * si.n + c * si.d) - col_m[c]) : 0.f;
    }
    __syncthreads();
    float out[RN][R];
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) out[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float cr[R];
#pragma unroll
      for (int j = 0; j < R; ++j) cr[j] = ctx[c * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const float p = qs[(ty + 16 * i) * P + c];
#pragma unroll
        for (int j = 0; j < R; ++j) out[i][j] = fmaf(p, cr[j], out[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) ks[(ty + 16 * i) * P + tx + 16 * j] = out[i][j];
    __syncthreads();
    for (int i = tid; i < kTileN * D; i += kThreads) {
      int r, c;
      tile_coord<D>(i, out_n_fastest, r, c);
      const int n = n0 + r;
      if (n < N) store_f32(y + out0 + n * so.n + c * so.d, ks[r * P + c]);
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(int head_dim, const void* q, const void* k, const void* v, void* y, int B,
                   int N, int H, Strides si, Strides so, cudaStream_t stream) {
  const dim3 grid(B * H), block(kThreads);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* yp = static_cast<T*>(y);
  if (head_dim == 64) {
    la_fwd_kernel<T, 64><<<grid, block, 0, stream>>>(qp, kp, vp, yp, H, N, si, so);
  } else if (head_dim == 32) {
    la_fwd_kernel<T, 32><<<grid, block, 0, stream>>>(qp, kp, vp, yp, H, N, si, so);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int edgeyolo_la_forward(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, void* y, int B, int N, int H, long long in_b,
                                   long long in_n, long long in_h, long long in_d, long long out_b,
                                   long long out_n, long long out_h, long long out_d,
                                   void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides si{in_b, in_n, in_h, in_d};
  const Strides so{out_b, out_n, out_h, out_d};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(head_dim, q, k, v, y, B, N, H, si, so, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(head_dim, q, k, v, y, B, N, H, si, so, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
