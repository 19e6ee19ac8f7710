// Fused Kaldi log-mel filterbank for Hopper (sm_90a): (B, W) wav -> (B, T, M).
//
// Replaces the TPU kernel wespeaker_hubert_tpu/ops/fbank_pallas.py:_kernel
// (launched by fbank_pallas).  The same algebra: int16 scaling, DC removal,
// pre-emphasis and the analysis window are linear, so the host folds them in
// float64 into cos/sin DFT matrices E = D^T P^T (diag(win) * DFT)
// (ops/fbank_kernel.py:_effective_matrices).  Per frame the kernel computes
//     power[k] = (x . Ecos[:, k])^2 + (x . Esin[:, k])^2
//     out[m]   = log(max(sum_k power[k] * Mel[k, m], FLT_EPSILON))
// and frames never go to device memory: each block stages the waveform span
// of its frames in shared memory and reads the frames as offsets into it.
//
// What bounds it.  The function needs little arithmetic: per 16 kHz frame
// (L = 400 samples, 512-point FFT, NB = 257 bins, M = 80 mels) a real FFT is
// about 2.5 * 512 * log2(512) = 11.5k FLOP, the triangular mel filters have
// about 2 * 257 nonzeros, and the preprocessing, power and log add about
// 3k: some 15k FLOP against 640 bytes of wav in and 320 bytes of log-mel
// out.  For the served (16, 30 s) bucket (16 x 2998 frames) that is about
// 0.74 GFLOP against 46 MB moved, so at 67 TFLOP/s of float32 and 3.35 TB/s
// it is bound by bytes, at about 0.014 ms.
//
// What this design does.  It computes the dense DFT instead, 2*400*257*2 +
// 2*257*80 = 452k FLOP per frame (21.7 GFLOP for the bucket, 29x what the
// function needs), in float32 FMA, no TF32: the JAX kernel runs its products
// at Precision.HIGHEST and the port holds the kernel to rtol 1e-4 / atol
// 2e-3 of that.  Every E element read from global memory (L2-resident: Ecos
// + Esin are 0.8 MB) feeds TILE frames, and the frame samples are
// shared-memory broadcasts (every thread of a warp reads the same address).
// This simple form is about 84x slower than the bound on an H100; two bins
// per thread and 32-frame tiles were both measured slower (PERF.md).  An FFT
// in shared memory (or a sparse mel product), and tensor cores (3xTF32
// wgmma) with TMA for the dense form, are later work.
//
// Layout: one block per (batch row, tile of TILE frames), one thread per DFT
// bin (blockDim = NB rounded up to a warp), TILE cos and TILE sin
// accumulators per thread.  Shared memory holds the span,
// (TILE - 1) * shift + L samples, then the TILE x NB power tile: 27.6 KB at
// 16 kHz.  It is dynamic shared memory, and the launch raises the block's
// limit above 48 KB when a configuration needs more.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;  // frames per block

__global__ void fbank_logmel_kernel(const float* __restrict__ wav, int W, int T,
                                    const float* __restrict__ ecos,
                                    const float* __restrict__ esin, int L, int NB,
                                    const float* __restrict__ mel, int M,
                                    int shift, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int span_len = (TILE - 1) * shift + L;
  float* span = smem;              // span_len samples
  float* power = smem + span_len;  // TILE x NB

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const float* x = wav + static_cast<size_t>(b) * W;
  const long s0 = static_cast<long>(t0) * shift;

  // coalesced stage of the span; samples past the row end read as 0 and
  // only feed frames >= T, which are never stored
  for (int i = threadIdx.x; i < span_len; i += blockDim.x) {
    const long s = s0 + i;
    span[i] = s < W ? x[s] : 0.f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < NB; k += blockDim.x) {
    float ac[TILE], as[TILE];
#pragma unroll
    for (int f = 0; f < TILE; ++f) {
      ac[f] = 0.f;
      as[f] = 0.f;
    }
    for (int n = 0; n < L; ++n) {
      const float c = __ldg(ecos + static_cast<size_t>(n) * NB + k);
      const float s = __ldg(esin + static_cast<size_t>(n) * NB + k);
      const float* sp = span + n;
#pragma unroll
      for (int f = 0; f < TILE; ++f) {
        const float v = sp[f * shift];
        ac[f] = fmaf(v, c, ac[f]);
        as[f] = fmaf(v, s, as[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < TILE; ++f) {
      power[f * NB + k] = ac[f] * ac[f] + as[f] * as[f];
    }
  }
  __syncthreads();

  const int nf = min(TILE, T - t0);
  for (int i = threadIdx.x; i < nf * M; i += blockDim.x) {
    const int f = i / M;
    const int m = i - f * M;
    const float* p = power + f * NB;
    float acc = 0.f;
    for (int k = 0; k < NB; ++k) {
      acc = fmaf(p[k], __ldg(mel + static_cast<size_t>(k) * M + m), acc);
    }
    out[(static_cast<size_t>(b) * T + t0 + f) * M + m] = logf(fmaxf(acc, FLT_EPSILON));
  }
}

}  // namespace

extern "C" {

// wav (B, W), ecos/esin (L, NB), mel (NB, M), out (B, T, M): contiguous f32
// on the current device.  Launches on `stream` and returns cudaGetLastError().
int fbank_logmel_f32(const float* wav, int B, int W, int T, const float* ecos,
                     const float* esin, int L, int NB, const float* mel, int M,
                     int shift, float* out, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  int threads = ((NB + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem =
      (static_cast<size_t>(TILE - 1) * shift + L + static_cast<size_t>(TILE) * NB) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fbank_logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((T + TILE - 1) / TILE, B);
  fbank_logmel_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, W, T, ecos, esin, L, NB, mel, M, shift, out);
  return static_cast<int>(cudaGetLastError());
}

const char* fbank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
