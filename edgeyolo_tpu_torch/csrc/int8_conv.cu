// int8 convolution with int32 accumulation, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the card's counterpart of the XLA op that
// edgeyolo_tpu/nn/quant.py:143 runs for every calibrated conv of the int8
// forward, `lax.conv_general_dilated(int8, int8,
// preferred_element_type=int32)`: PyTorch has no int8 convolution on CUDA,
// torch._int_mm is a dense GEMM (no depthwise or grouped conv), and an f32
// or bf16 convolution of the int8 values is not exact once the reduction is
// deep (3 x 3 x 256 x 127^2 > 2^24), so the sums would not be JAX's.
//
// One call, two launches on the caller's stream:
//   1. quantize: x (N, C, H, W), f32 or bf16, -> int8 codes
//      clip(rint(x * rcp), -127, 127), rcp = f32(1 / sx): the product with
//      the f32 reciprocal is what XLA compiles JAX's `x / sx` to (sx is a
//      constant of the program). Grouped by channel quads for the dp4a path
//      (N, H, W, G, Q, 4), zero-padded to whole quads; left as NCHW int8 for
//      the scalar path.
//   2. conv: the dp4a path (channels per group >= 4) gives each thread one
//      output position and up to 8 output channels of one group, and sums
//      __dp4a(x quad, w quad) over (kh, kw, quads); the scalar path (depthwise
//      and the 3-channel stem) gives each thread one output and sums int8
//      products. Any stride, padding, dilation and group count.
//      Epilogue: __fmul_rn(__int2float_rn(acc), scale[o]) with scale = f32(sx
//      * ws[o]), then __fadd_rn of the bias: rounded product and sum, never
//      contracted into an FMA, so the result is the plain version's to the
//      bit. Stores f32 or bf16 (__float2bfloat16_rn) NCHW.
//
// Bound on the card: the bytes moved (x read once, y written once, the int8
// weights) at 3.35 TB/s, or 2 x MACs at 1,979 int8 TOP/s, whichever is
// larger. This first version reads its operands from L1/L2 per MAC quad and
// uses no tensor core; an mma.sync / wgmma s8 implicit GEMM is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// What one call needs; the Python wrapper (ops/int8_conv.py, `_Shape`) builds
// the same struct. At namespace scope: the extern "C" entry takes it, and a
// type of an anonymous namespace would give the entry internal linkage.
struct I8Shape {
  int N, C, H, W;        // input, NCHW contiguous
  int O, OH, OW;         // output channels and spatial size
  int KH, KW, SH, SW, PH, PW, DH, DW, G;
  int CG, OG;            // input and output channels per group
  int Q;                 // channel quads per group (dp4a path), 0 for the scalar path
  int in_bf16, out_bf16;
  int bias_kind;         // 0 none, 1 f32, 2 bf16
  float rcp;             // f32(1 / sx)
};

namespace {

constexpr int OC_PER_THREAD = 8;
constexpr int QUANT_THREADS = 256;
constexpr int CONV_THREADS = 128;

__device__ __forceinline__ float load_x(const void* x, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
              : static_cast<const float*>(x)[i];
}

__device__ __forceinline__ int quant(float v, float rcp) {
  float r = rintf(__fmul_rn(v, rcp));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int>(r);
}

__device__ __forceinline__ void store_y(void* y, long long i, int acc, float scale,
                                        const void* bias, int o, const I8Shape& s) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (s.bias_kind == 1) {
    v = __fadd_rn(v, static_cast<const float*>(bias)[o]);
  } else if (s.bias_kind == 2) {
    v = __fadd_rn(v, __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[o]));
  }
  if (s.out_bf16) {
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(y)[i] = v;
  }
}

// x (N, C, H, W) -> xq (N, H, W, G, Q) int32 words of 4 channel codes.
// Threads walk (n, g, q, h, w) with w fastest, so the reads of x coalesce.
__global__ void quantize_quads(const void* __restrict__ x, int* __restrict__ xq, I8Shape s) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(s.N) * s.G * s.Q * s.H * s.W;
  if (t >= total) return;
  int w = static_cast<int>(t % s.W);
  long long r = t / s.W;
  int h = static_cast<int>(r % s.H);
  r /= s.H;
  int q = static_cast<int>(r % s.Q);
  r /= s.Q;
  int g = static_cast<int>(r % s.G);
  int n = static_cast<int>(r / s.G);
  unsigned word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int cl = q * 4 + j;
    if (cl < s.CG) {
      int c = g * s.CG + cl;
      long long i = ((static_cast<long long>(n) * s.C + c) * s.H + h) * s.W + w;
      word |= (static_cast<unsigned>(quant(load_x(x, i, s.in_bf16), s.rcp)) & 0xffu) << (8 * j);
    }
  }
  xq[((static_cast<long long>(n) * s.H + h) * s.W + w) * s.G * s.Q + g * s.Q + q] =
      static_cast<int>(word);
}

// x -> int8 codes in x's own NCHW layout (the scalar path).
__global__ void quantize_plain(const void* __restrict__ x, int8_t* __restrict__ xq, I8Shape s) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(s.N) * s.C * s.H * s.W;
  if (t >= total) return;
  xq[t] = static_cast<int8_t>(quant(load_x(x, t, s.in_bf16), s.rcp));
}

// dp4a path. blockIdx.y picks (group, chunk of up to 8 output channels);
// each thread one output position (n, oh, ow), ow fastest.
// wq: (O, KH, KW, Q) int32 words of 4 input-channel codes, zero-padded.
__global__ void conv_dp4a(const int* __restrict__ xq, const int* __restrict__ wq,
                          const float* __restrict__ scale, const void* __restrict__ bias,
                          void* __restrict__ y, I8Shape s) {
  long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(s.N) * s.OH * s.OW;
  if (p >= total) return;
  int chunks = (s.OG + OC_PER_THREAD - 1) / OC_PER_THREAD;
  int g = blockIdx.y / chunks;
  int o0 = g * s.OG + (blockIdx.y % chunks) * OC_PER_THREAD;
  int no = min(OC_PER_THREAD, (g + 1) * s.OG - o0);
  int ow = static_cast<int>(p % s.OW);
  long long r = p / s.OW;
  int oh = static_cast<int>(r % s.OH);
  int n = static_cast<int>(r / s.OH);
  int acc[OC_PER_THREAD];
#pragma unroll
  for (int j = 0; j < OC_PER_THREAD; ++j) acc[j] = 0;
  const long long wstride = static_cast<long long>(s.KH) * s.KW * s.Q;  // one output channel
  for (int ki = 0; ki < s.KH; ++ki) {
    int ih = oh * s.SH - s.PH + ki * s.DH;
    if (ih < 0 || ih >= s.H) continue;
    for (int kj = 0; kj < s.KW; ++kj) {
      int iw = ow * s.SW - s.PW + kj * s.DW;
      if (iw < 0 || iw >= s.W) continue;
      const int* xp = xq + ((static_cast<long long>(n) * s.H + ih) * s.W + iw) * s.G * s.Q +
                      static_cast<long long>(g) * s.Q;
      const int* wp = wq + (static_cast<long long>(o0) * s.KH * s.KW + ki * s.KW + kj) * s.Q;
      for (int q = 0; q < s.Q; ++q) {
        int a = xp[q];
#pragma unroll
        for (int j = 0; j < OC_PER_THREAD; ++j) {
          if (j < no) acc[j] = __dp4a(a, __ldg(wp + j * wstride + q), acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < OC_PER_THREAD; ++j) {
    if (j < no) {
      int o = o0 + j;
      long long i = ((static_cast<long long>(n) * s.O + o) * s.OH + oh) * s.OW + ow;
      store_y(y, i, acc[j], scale[o], bias, o, s);
    }
  }
}

// Scalar path: one thread per output (n, o, oh, ow), ow fastest.
// wq: (O, CG, KH, KW) int8, the PyTorch layout.
__global__ void conv_scalar(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                            const float* __restrict__ scale, const void* __restrict__ bias,
                            void* __restrict__ y, I8Shape s) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(s.N) * s.O * s.OH * s.OW;
  if (t >= total) return;
  int ow = static_cast<int>(t % s.OW);
  long long r = t / s.OW;
  int oh = static_cast<int>(r % s.OH);
  r /= s.OH;
  int o = static_cast<int>(r % s.O);
  int n = static_cast<int>(r / s.O);
  int g = o / s.OG;
  int acc = 0;
  for (int cl = 0; cl < s.CG; ++cl) {
    const int8_t* xp = xq + (static_cast<long long>(n) * s.C + g * s.CG + cl) * s.H * s.W;
    const int8_t* wp = wq + (static_cast<long long>(o) * s.CG + cl) * s.KH * s.KW;
    for (int ki = 0; ki < s.KH; ++ki) {
      int ih = oh * s.SH - s.PH + ki * s.DH;
      if (ih < 0 || ih >= s.H) continue;
      for (int kj = 0; kj < s.KW; ++kj) {
        int iw = ow * s.SW - s.PW + kj * s.DW;
        if (iw < 0 || iw >= s.W) continue;
        acc += static_cast<int>(xp[static_cast<long long>(ih) * s.W + iw]) *
               static_cast<int>(__ldg(wp + ki * s.KW + kj));
      }
    }
  }
  store_y(y, t, acc, scale[o], bias, o, s);
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// Quantize x into `xq` (scratch the caller sized: N*H*W*G*Q int32 words for
// the dp4a path, N*C*H*W bytes for the scalar path), then convolve into y.
// Returns cudaGetLastError() after the two launches (0 on success).
extern "C" int edgeyolo_i8_conv2d(const void* x, void* xq, const void* wq, const float* scale,
                                  const void* bias, void* y, const I8Shape* shape,
                                  void* stream) {
  const I8Shape s = *shape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long outputs = static_cast<long long>(s.N) * s.OH * s.OW;
  if (s.Q > 0) {
    long long words = static_cast<long long>(s.N) * s.G * s.Q * s.H * s.W;
    quantize_quads<<<blocks_for(words, QUANT_THREADS), QUANT_THREADS, 0, st>>>(
        x, static_cast<int*>(xq), s);
    dim3 grid(blocks_for(outputs, CONV_THREADS),
              s.G * ((s.OG + OC_PER_THREAD - 1) / OC_PER_THREAD));
    conv_dp4a<<<grid, CONV_THREADS, 0, st>>>(static_cast<const int*>(xq),
                                             static_cast<const int*>(wq), scale, bias, y, s);
  } else {
    long long elems = static_cast<long long>(s.N) * s.C * s.H * s.W;
    quantize_plain<<<blocks_for(elems, QUANT_THREADS), QUANT_THREADS, 0, st>>>(
        x, static_cast<int8_t*>(xq), s);
    conv_scalar<<<blocks_for(outputs * s.O, CONV_THREADS), CONV_THREADS, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq), scale, bias, y, s);
  }
  return static_cast<int>(cudaGetLastError());
}
