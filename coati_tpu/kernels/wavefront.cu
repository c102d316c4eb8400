// Anti-diagonal pair-HMM DP for NVIDIA Hopper, called from JAX through the
// XLA FFI (coati_tpu/kernels/wavefront_cuda.py builds and registers it).
//
// One thread block fills one pair's DP matrix. The block walks the
// anti-diagonals d = i + j in order; the threads of the block split the
// cells of each diagonal, and one __syncthreads() separates consecutive
// diagonals. The last max(k,2)+1 diagonals of M/D/I live in a ring, in
// shared memory when it fits (a global scratch result otherwise), indexed
// by slot j, so the match recurrence's j-1 shift is a neighbouring ring
// read. Emissions are a direct lookup in the (possibly stacked) [rows, 15]
// table through the read-only cache.
//
// Semantics are those of align/wavefront.py's wavefront_impl, cell for
// cell: the same float32 operation order (adds, then max, the _argmax_mdi
// tie rule), margins from the same formulas with no FMA contraction
// (__fadd_rn/__fmul_rn, and the library is built with -fmad=false), and
// backpointer codes from the traceback's comparison values. Only cells of
// each pair's own (la + k) x (lb + k) rectangle are computed; outputs
// outside it are left unwritten and are never read (the traceback and the
// samplers stay inside the rectangle). A read of a cell outside the
// rectangle returns the LOWEST fill, which is what the XLA scan holds
// there (its shifts fill LOWEST and rows i < 0 carry no margin value).
//
// Modes (one handler each): viterbi (corners + packed 1 B/cell
// backpointers in the [Dtot, B, C] layout traceback_ops_impl walks),
// score (corners only) and forward (log semiring; corners + the M/D/I
// planes [Dtot, B, C]).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kLowest = -3.40282346638528859812e+38f;
constexpr int kViterbi = 0;
constexpr int kScore = 1;
constexpr int kForward = 2;

__device__ __forceinline__ float lse(float a, float b) {
  // wavefront._lse: mx + (y <= -16 ? exp(y) : log1p(exp(min(y, 0))))
  float mx = fmaxf(a, b);
  float y = -fabsf(__fsub_rn(a, b));
  float t = (y <= -16.0f) ? expf(y) : log1pf(expf(fminf(y, 0.0f)));
  return __fadd_rn(mx, t);
}

template <int MODE>
__device__ __forceinline__ float plus2(float a, float b) {
  if (MODE == kForward) return lse(a, b);
  return fmaxf(a, b);
}

__device__ __forceinline__ uint32_t argmax_mdi(float m, float d, float i) {
  uint32_t code = d > m ? 1u : 0u;
  float best = fmaxf(m, d);
  return i > best ? 2u : code;
}

template <int MODE>
__global__ void wavefront_kernel(
    const int32_t* __restrict__ aseq, const int32_t* __restrict__ bseq,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    const float* __restrict__ table, const float* __restrict__ gcs,
    int B, int NA, int NB, int k, int ncols,
    float* __restrict__ corners,  // [3, B] terminal-adjusted (cM, cD, cI)
    uint8_t* __restrict__ bp,     // viterbi: [Dtot, B, C]
    float* __restrict__ outM,     // forward: [Dtot, B, C] each
    float* __restrict__ outD, float* __restrict__ outI,
    float* __restrict__ ring_global) {  // [B, NR, 3, C] or null (shared)
  extern __shared__ float ring_shared[];
  const int b = blockIdx.x;
  const int C = NB + k;
  const int NR = (k > 2 ? k : 2) + 1;
  float* ring = ring_global ? ring_global + (size_t)b * NR * 3 * C
                            : ring_shared;

  const int la = lens_a[b];
  const int lb = lens_b[b];
  const int Rb = la + k;  // rows of this pair's rectangle
  const int Cb = lb + k;  // slots of this pair's rectangle
  const int d_end = Rb + Cb - 1;
  const int corner_d = la + lb + 2 * (k - 1);
  const int corner_j = lb + k - 1;

  const float ng = gcs[0], gs = gcs[1], go = gcs[2], ge = gcs[3];
  const float gek1 = __fmul_rn(ge, (float)(k - 1));
  const float gek = __fmul_rn(ge, (float)k);
  const int32_t* arow = aseq + (size_t)b * NA;
  const int32_t* brow = bseq + (size_t)b * NB;
  const size_t plane = (size_t)B * C;  // one diagonal of the outputs

  for (int d = 0; d < d_end; ++d) {
    float* cur = ring + (size_t)(d % NR) * 3 * C;
    const float* p2 = ring + (size_t)((d + NR - 2) % NR) * 3 * C;
    const float* pk = ring + (size_t)((d + NR - k) % NR) * 3 * C;
    const int j_lo = d - Rb + 1 > 0 ? d - Rb + 1 : 0;
    const int j_hi = Cb - 1 < d ? Cb - 1 : d;
    for (int j = j_lo + (int)threadIdx.x; j <= j_hi; j += blockDim.x) {
      const int i = d - j;
      const bool ok2 = (i >= 1) && (j >= 1);  // (i-1, j-1) in the rectangle
      const bool okd = i >= k;                // (i-k, j)
      const bool oki = j >= k;                // (i, j-k)
      const float p2M = ok2 ? p2[j - 1] : kLowest;
      const float p2D = ok2 ? p2[C + j - 1] : kLowest;
      const float p2I = ok2 ? p2[2 * C + j - 1] : kLowest;
      const float pkM = okd ? pk[j] : kLowest;
      const float pkD = okd ? pk[C + j] : kLowest;
      const float pkI = okd ? pk[2 * C + j] : kLowest;
      const float pkMs = oki ? pk[j - k] : kLowest;
      const float pkIs = oki ? pk[2 * C + j - k] : kLowest;

      float M, D, I;
      if (okd && oki) {  // body cell: i >= k and j >= k
        const float sub =
            __ldg(&table[(size_t)__ldg(&arow[i - k]) * ncols +
                         __ldg(&brow[j - k])]);
        const float m2m = __fadd_rn(__fadd_rn(__fadd_rn(p2M, ng), ng), sub);
        const float d2m = __fadd_rn(__fadd_rn(p2D, gs), sub);
        const float i2m = __fadd_rn(__fadd_rn(__fadd_rn(p2I, gs), ng), sub);
        const float m2d = __fadd_rn(__fadd_rn(__fadd_rn(pkM, ng), go), gek1);
        const float i2d = __fadd_rn(__fadd_rn(__fadd_rn(pkI, gs), go), gek1);
        const float d2d = __fadd_rn(pkD, gek);
        const float m2i = __fadd_rn(__fadd_rn(pkMs, go), gek1);
        const float i2i = __fadd_rn(pkIs, gek);
        M = plus2<MODE>(plus2<MODE>(m2m, d2m), i2m);
        D = plus2<MODE>(plus2<MODE>(m2d, d2d), i2d);
        I = plus2<MODE>(m2i, i2i);
      } else {  // margins (wavefront_impl.margins)
        M = (i == k - 1 && j == k - 1) ? 0.0f : kLowest;
        const bool ins_ok =
            i == k - 1 && j >= 2 * k - 1 && (j - (k - 1)) % k == 0;
        I = ins_ok ? __fadd_rn(go, __fmul_rn(ge, __fsub_rn((float)j, 1.0f)))
                   : kLowest;
        const bool del_ok =
            j == k - 1 && i >= 2 * k - 1 && (i - (k - 1)) % k == 0;
        D = del_ok ? __fadd_rn(__fadd_rn(ng, go),
                               __fmul_rn(ge, __fsub_rn((float)i, 1.0f)))
                   : kLowest;
      }
      cur[j] = M;
      cur[C + j] = D;
      cur[2 * C + j] = I;
      const size_t o = (size_t)d * plane + (size_t)b * C + j;
      if (MODE == kViterbi) {
        const uint32_t bp_m =
            argmax_mdi(__fadd_rn(__fadd_rn(p2M, ng), ng), __fadd_rn(p2D, gs),
                       __fadd_rn(__fadd_rn(p2I, gs), ng));
        const uint32_t bp_d =
            argmax_mdi(__fadd_rn(__fadd_rn(pkM, ng), go), __fadd_rn(pkD, ge),
                       __fadd_rn(__fadd_rn(pkI, gs), go));
        const uint32_t bp_i =
            __fadd_rn(pkMs, go) > __fadd_rn(pkIs, ge) ? 0u : 2u;
        bp[o] = (uint8_t)(bp_m | (bp_d << 2) | (bp_i << 4));
      } else if (MODE == kForward) {
        outM[o] = M;
        outD[o] = D;
        outI[o] = I;
      }
      if (d == corner_d && j == corner_j) {
        // terminal-state adjustment (wavefront_impl, after the scan)
        corners[b] = __fadd_rn(__fadd_rn(M, ng), ng);
        corners[B + b] = __fadd_rn(D, gs);
        corners[2 * B + b] = __fadd_rn(__fadd_rn(I, gs), ng);
      }
    }
    __syncthreads();
  }
}

template <int MODE>
ffi::Error Launch(cudaStream_t stream, ffi::Buffer<ffi::S32> aseq,
                  ffi::Buffer<ffi::S32> bseq, ffi::Buffer<ffi::S32> la,
                  ffi::Buffer<ffi::S32> lb, ffi::Buffer<ffi::F32> table,
                  ffi::Buffer<ffi::F32> gc, float* corners, uint8_t* bp,
                  float* outM, float* outD, float* outI, float* ring_global,
                  int32_t k, int32_t threads, int32_t ring_in_shared) {
  const auto ad = aseq.dimensions();
  const auto bd = bseq.dimensions();
  const auto td = table.dimensions();
  if (ad.size() != 2 || bd.size() != 2 || td.size() != 2 || k < 1) {
    return ffi::Error::InvalidArgument("wavefront: bad operand ranks or k");
  }
  const int B = (int)ad[0], NA = (int)ad[1], NB = (int)bd[1];
  const int C = NB + k;
  const int NR = (k > 2 ? k : 2) + 1;
  const size_t shared = ring_in_shared ? (size_t)NR * 3 * C * sizeof(float)
                                       : 0;
  auto kernel = wavefront_kernel<MODE>;
  if (shared > 48 * 1024) {
    cudaError_t st = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (st != cudaSuccess) {
      return ffi::Error::Internal(std::string("wavefront: ") +
                                  cudaGetErrorString(st));
    }
  }
  if (B > 0) {
    kernel<<<B, threads, shared, stream>>>(
        aseq.typed_data(), bseq.typed_data(), la.typed_data(),
        lb.typed_data(), table.typed_data(), gc.typed_data(), B, NA, NB, k,
        (int)td[1], corners, bp, outM, outD, outI,
        ring_in_shared ? nullptr : ring_global);
  }
  cudaError_t st = cudaGetLastError();
  if (st != cudaSuccess) {
    return ffi::Error::Internal(std::string("wavefront launch: ") +
                                cudaGetErrorString(st));
  }
  return ffi::Error::Success();
}

ffi::Error ViterbiImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> aseq,
                       ffi::Buffer<ffi::S32> bseq, ffi::Buffer<ffi::S32> la,
                       ffi::Buffer<ffi::S32> lb, ffi::Buffer<ffi::F32> table,
                       ffi::Buffer<ffi::F32> gc,
                       ffi::ResultBuffer<ffi::F32> corners,
                       ffi::ResultBuffer<ffi::U8> bp,
                       ffi::ResultBuffer<ffi::F32> ring, int32_t k,
                       int32_t threads, int32_t ring_in_shared) {
  return Launch<kViterbi>(stream, aseq, bseq, la, lb, table, gc,
                          corners->typed_data(), bp->typed_data(), nullptr,
                          nullptr, nullptr, ring->typed_data(), k, threads,
                          ring_in_shared);
}

ffi::Error ScoreImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> aseq,
                     ffi::Buffer<ffi::S32> bseq, ffi::Buffer<ffi::S32> la,
                     ffi::Buffer<ffi::S32> lb, ffi::Buffer<ffi::F32> table,
                     ffi::Buffer<ffi::F32> gc,
                     ffi::ResultBuffer<ffi::F32> corners,
                     ffi::ResultBuffer<ffi::F32> ring, int32_t k,
                     int32_t threads, int32_t ring_in_shared) {
  return Launch<kScore>(stream, aseq, bseq, la, lb, table, gc,
                        corners->typed_data(), nullptr, nullptr, nullptr,
                        nullptr, ring->typed_data(), k, threads,
                        ring_in_shared);
}

ffi::Error ForwardImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> aseq,
                       ffi::Buffer<ffi::S32> bseq, ffi::Buffer<ffi::S32> la,
                       ffi::Buffer<ffi::S32> lb, ffi::Buffer<ffi::F32> table,
                       ffi::Buffer<ffi::F32> gc,
                       ffi::ResultBuffer<ffi::F32> corners,
                       ffi::ResultBuffer<ffi::F32> outM,
                       ffi::ResultBuffer<ffi::F32> outD,
                       ffi::ResultBuffer<ffi::F32> outI,
                       ffi::ResultBuffer<ffi::F32> ring, int32_t k,
                       int32_t threads, int32_t ring_in_shared) {
  return Launch<kForward>(stream, aseq, bseq, la, lb, table, gc,
                          corners->typed_data(), nullptr,
                          outM->typed_data(), outD->typed_data(),
                          outI->typed_data(), ring->typed_data(), k, threads,
                          ring_in_shared);
}

}  // namespace

#define COATI_INPUTS                        \
  .Ctx<ffi::PlatformStream<cudaStream_t>>() \
      .Arg<ffi::Buffer<ffi::S32>>()         \
      .Arg<ffi::Buffer<ffi::S32>>()         \
      .Arg<ffi::Buffer<ffi::S32>>()         \
      .Arg<ffi::Buffer<ffi::S32>>()         \
      .Arg<ffi::Buffer<ffi::F32>>()         \
      .Arg<ffi::Buffer<ffi::F32>>()

#define COATI_ATTRS         \
  .Attr<int32_t>("k")       \
      .Attr<int32_t>("threads") \
      .Attr<int32_t>("ring_in_shared")

XLA_FFI_DEFINE_HANDLER_SYMBOL(CoatiWavefrontViterbi, ViterbiImpl,
                              ffi::Ffi::Bind() COATI_INPUTS
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::F32>>() COATI_ATTRS);

XLA_FFI_DEFINE_HANDLER_SYMBOL(CoatiWavefrontScore, ScoreImpl,
                              ffi::Ffi::Bind() COATI_INPUTS
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>() COATI_ATTRS);

XLA_FFI_DEFINE_HANDLER_SYMBOL(CoatiWavefrontForward, ForwardImpl,
                              ffi::Ffi::Bind() COATI_INPUTS
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>() COATI_ATTRS);
