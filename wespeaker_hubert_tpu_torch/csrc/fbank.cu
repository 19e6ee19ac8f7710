// Fused Kaldi log-mel filterbank for Hopper (sm_90a): (B, W) wav -> (B, T, M).
//
// Replaces the TPU kernel wespeaker_hubert_tpu/ops/fbank_pallas.py:_kernel
// (launched by fbank_pallas).  The TPU kernel folds int16 scaling, DC
// removal, pre-emphasis and the window into dense cos/sin DFT matrices and
// runs them on the matrix unit; this kernel computes the same function with
// an FFT and the mel filters' nonzeros, in float32 throughout (no TF32, no
// fast-math log), per frame of L samples x (times 32768 with
// scale_to_int16):
//   x'    = x - mean (remove_dc_offset);
//   y     = window * (x'[n] - c x'[n-1]), x'[-1] = x'[0] (pre-emphasis c),
//           zero-padded to N = fft_size;
//   out   = log(max(sum_k |Y[k]|^2 Mel[k, m], FLT_EPSILON)) over the nonzero
//           bins of each triangular filter (a CSR built on the host).
// The order of the plain rFFT path (ops/fbank.py, spectrum_impl="fft").
//
// Pre-emphasis after the FFT.  Pre-emphasis leaves the lowest bins about
// 1e-3 of the average power, and a float32 y, or an FFT of it, carries
// rounding noise of about 1e-7 of the frame's energy in every bin; where a
// low filter's energy is small by chance, that is a few 1e-3 in its log
// (the plain rFFT path misses rtol 1e-4 / atol 2e-3 against the plain
// version, which folds the steps into float64 matrices, at the served
// (16, 30 s) shape).  So the kernel transforms u = window * x' and the small
// correction d (d[0] = u[0], d[n] = (window[n] - window[n-1]) x'[n-1] for
// 0 < n < L, d[L mod N] -= u[L-1]), for which y = u - c shift(u) - c d
// exactly, and forms Y[k] = (1 - c W_N^k) U[k] - c D[k]: U's rounding is
// scaled by |1 - c W_N^k|, 0.03 at the lowest bins, as in the folded form.
// u and d go through one N-point complex FFT as z = u + i d, split after it
// into U[k] = (Z[k] + conj Z[N-k]) / 2 and D[k] = (Z[k] - conj Z[N-k]) / 2i.
//
// What bounds it.  Per 16 kHz frame (L = 400, N = 512, 257 bins, 80 mels) a
// real FFT is about 2.5 N log2 N = 11.5k FLOP, the filters have about 2 x
// 257 nonzeros, and the preprocessing, power and log add about 3k: some 15k
// FLOP against 640 bytes of wav in and 320 bytes of log-mel out.  For the
// served (16, 30 s) bucket (16 x 2998 frames) that is 0.74 GFLOP against
// 46 MB: 0.011 ms at 67 TFLOP/s of float32, 0.014 ms at 3.35 TB/s, a byte
// bound (chip_smoke.fbank_bound).  The transform of u and d together costs
// twice the real FFT's operations.
//
// Design.  One warp per frame, the FFT in registers and shared memory: the
// N-point complex FFT runs as Stockham radix-8/4 stages (FftPlan), each lane
// holding N/32 points; a stage reads a lane's butterflies from the warp's
// buffer, twiddles them from a table computed on the host in float64 and
// stored as float32 (W_N^e, e < N), transforms them in registers and writes
// them back in the next stage's order.  The first stage reads no buffer: each
// lane forms its points from the samples; the last writes none: it leaves
// the lane with Z[k] for every k = lane (mod 32), and the split takes
// Z[N - k] from lane 32 - lane by shuffles.  Buffers are padded one point in
// eight, which keeps the strided stage writes apart in the banks.  One lane
// per mel then sums its few bins (6 on average at 80 mels) and stores the
// log.  Every warp walks frames on its
// own: its next frame's L samples come in by cp.async (16-byte copies where
// rows, frames and L are 16-byte aligned, else 4-byte) into the other half
// of a double buffer while it transforms this one, and the power spectrum
// overwrites the samples it was computed from; the block shares only the
// tables (twiddles, the pre-emphasis response, the window and its
// differences, the filters), staged once.  Blocks are persistent.  N
// is a template parameter over the powers of two 256-2048 (8-48 kHz at
// 25 ms); any frame length up to N, shift and mel count.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;

// frames in flight per block, one per warp: fewer at N >= 1024, whose
// buffers are 2-4x those at 512
template <int N> __host__ __device__ constexpr int warps() { return N <= 512 ? 8 : 4; }

// the radix-8/4 stages of the N-point complex FFT (ops/fbank_kernel.py:FFT_RADICES)
template <int N> struct FftPlan;
template <> struct FftPlan<256> { static constexpr int R[4] = {8, 8, 4, 0}; };
template <> struct FftPlan<512> { static constexpr int R[4] = {8, 8, 8, 0}; };
template <> struct FftPlan<1024> { static constexpr int R[4] = {8, 8, 4, 4}; };
template <> struct FftPlan<2048> { static constexpr int R[4] = {8, 8, 8, 4}; };

struct FbankParams {
  const float* wav;      // (B, W)
  float* out;            // (B, T, num_mel)
  const float2* tw;      // (N,) W_N^e = exp(-2 pi i e / N)
  const float2* emph;    // (N/2 + 1,) 1 - c W_N^k, the pre-emphasis response
  const float* window;   // (L,)
  const float* dwindow;  // (L,) window[n] - window[n - 1] (entry 0 unused)
  const int* mel_tab;    // (3, num_mel): first bin, count, offset into mel_w
  const float* mel_w;    // (nnz,)
  int B, W, T, L, shift, num_mel, nnz, vec4, remove_dc;
  float preemph, scale;
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// the dynamic shared memory, in bytes from its base (every part 16-byte
// aligned): the block's tables, then each warp's FFT buffer and its two
// frame buffers (the power spectrum reuses the frame buffer just read)
struct Layout {
  int emph, window, dwindow, mel_tab, mel_w, warp0, warp_bytes, frame, total;
};

__host__ __device__ inline Layout layout(int n, int warps, int L, int num_mel, int nnz) {
  const int pn = n + n / 8;
  Layout s;
  s.emph = n * 8;                                   // after the twiddles
  s.window = s.emph + round4(n / 2 + 1) * 8;
  s.dwindow = s.window + round4(L) * 4;
  s.mel_tab = s.dwindow + round4(L) * 4;
  s.mel_w = s.mel_tab + 3 * round4(num_mel) * 4;
  s.warp0 = s.mel_w + round4(nnz) * 4;
  s.frame = pn * 8;                                 // in a warp's part, after its FFT buffer
  s.warp_bytes = s.frame + 2 * round4(L) * 4;
  s.total = s.warp0 + warps * s.warp_bytes;
  return s;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// in-place DFT of R points, exp(-2 pi i / R), natural order in and out
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  constexpr float C = 0.70710678118654752f;
  float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  o[1] = make_float2(C * (o[1].x + o[1].y), C * (o[1].y - o[1].x));     // W8
  o[2] = mul_mi(o[2]);                                                  // W8^2 = -i
  o[3] = make_float2(C * (o[3].y - o[3].x), -C * (o[3].x + o[3].y));    // W8^3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// one Stockham stage of the N-point FFT: radix R after stages of total
// length NS.  Butterfly j reads points j + r N/R, twiddles point r by
// W_N^(r (j mod NS) N / (NS R)), transforms them and writes point r at
// (j - j mod NS) R + j mod NS + r NS.  NS = 1 takes its points from `load`
// instead of the buffer.
template <int N, int R, int NS, typename Load>
__device__ __forceinline__ void fft_stage(float2* buf, const float2* tw, int lane, Load load) {
  constexpr int NB = N / R, PER = (NB + 31) / 32;
  float2 v[PER][R];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = lane + 32 * i;
    if (NB % 32 == 0 || j < NB) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (NS == 1) v[i][r] = load(j + r * NB);
        else v[i][r] = buf[pad(j + r * NB)];
      }
    }
  }
  __syncwarp();
  // with NS <= 32 every butterfly of the lane has j mod NS = lane mod NS:
  // its twiddles are read once
  constexpr bool SHARED_TW = NS > 1 && NS <= 32;
  float2 t[R];
  if constexpr (SHARED_TW) {
#pragma unroll
    for (int r = 1; r < R; ++r) t[r] = tw[r * (lane & (NS - 1)) * (N / (NS * R))];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = lane + 32 * i;
    if (NB % 32 == 0 || j < NB) {
      const int k = j & (NS - 1);
      if constexpr (SHARED_TW) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[i][r] = cmul(v[i][r], t[r]);
      } else if constexpr (NS > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[i][r] = cmul(v[i][r], tw[r * k * (N / (NS * R))]);
      }
      dft<R>(v[i]);
      const int d = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[pad(d + r * NS)] = v[i][r];
    }
  }
  __syncwarp();
}

// the last stage (NS R = N) into registers: butterfly j = lane + 32 i
// writes point r to Z[j + NS r], so z[i + (NS / 32) r] = Z[lane + 32 m] with
// m = i + (NS / 32) r: the lane holds every Z[k] with k = lane (mod 32)
template <int N, int R, int NS>
__device__ __forceinline__ void fft_last(const float2* buf, const float2* tw, int lane,
                                         float2 (&z)[N / 32]) {
  static_assert(NS * R == N && NS % 32 == 0, "the last stage spans the transform");
  constexpr int NB = N / R, PER = NB / 32;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = lane + 32 * i;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = buf[pad(j + r * NB)];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * j]);
    dft<R>(v);
#pragma unroll
    for (int r = 0; r < R; ++r) z[i + (NS / 32) * r] = v[r];
  }
}

// Z = FFT(u + i d) of one frame, z[m] = Z[lane + 32 m] (fft_last): u =
// window * x', d the pre-emphasis correction (see the top of the file)
template <int N>
__device__ __forceinline__ void fft(float2* buf, const float2* tw, int lane, const float* x,
                                    const float* win, const float* dwin, const FbankParams& p,
                                    float mean, float2 (&z)[N / 32]) {
  using P = FftPlan<N>;
  const int L = p.L;
  const float scale = p.scale;
  auto xd = [&](int n) -> float { return x[n] * scale - mean; };  // x', exact scaling
  auto load = [&](int n) -> float2 {
    float u = 0.f, d = 0.f;
    if (n < L) {
      u = __fmul_rn(win[n], xd(n));
      d = n == 0 ? u : __fmul_rn(dwin[n], xd(n - 1));
    }
    if (n == L % N) d -= __fmul_rn(win[L - 1], xd(L - 1));
    return make_float2(u, d);
  };
  constexpr int R0 = P::R[0], R1 = P::R[1], R2 = P::R[2], R3 = P::R[3];
  fft_stage<N, R0, 1>(buf, tw, lane, load);
  fft_stage<N, R1, R0>(buf, tw, lane, load);
  if constexpr (R3 == 0) {
    fft_last<N, R2, R0 * R1>(buf, tw, lane, z);
  } else {
    fft_stage<N, R2, R0 * R1>(buf, tw, lane, load);
    fft_last<N, R3, R0 * R1 * R2>(buf, tw, lane, z);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// frame f's L samples into dst, issued by the warp's lanes (a frame of
// t < T lies inside its row)
__device__ __forceinline__ void load_frame(float* dst, const FbankParams& p, long long f,
                                           int lane) {
  const float* src = p.wav + (f / p.T) * p.W + (f % p.T) * p.shift;
  if (p.vec4) {  // 16-byte aligned rows and frames, L a multiple of 4
    for (int c = lane; c < p.L / 4; c += 32) cp_async16(dst + 4 * c, src + 4 * c);
  } else {
    for (int i = lane; i < p.L; i += 32) cp_async4(dst + i, src + i);
  }
}

// three blocks per SM at N <= 512 (measured faster than ptxas's own choice)
template <int N>
__global__ void __launch_bounds__(32 * warps<N>(), N <= 512 ? 3 : 1)
    fbank_fft_kernel(const FbankParams p) {
  constexpr int WARPS = warps<N>(), BINS = N / 2 + 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout lay = layout(N, WARPS, p.L, p.num_mel, p.nnz);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* const mine = smem + lay.warp0 + warp * lay.warp_bytes;
  float2* const buf = reinterpret_cast<float2*>(mine);
  float* const frames = reinterpret_cast<float*>(mine + lay.frame);  // two of round4(L)
  const long long n_frames = static_cast<long long>(p.B) * p.T;
  const int stride = gridDim.x * WARPS;
  long long f = static_cast<long long>(blockIdx.x) * WARPS + warp;
  // the warp's first frame is on its way while the block stages its tables
  if (f < n_frames) load_frame(frames, p, f, lane);
  cp_async_commit();

  float2* const tw = reinterpret_cast<float2*>(smem);
  float2* const emph = reinterpret_cast<float2*>(smem + lay.emph);
  float* const win = reinterpret_cast<float*>(smem + lay.window);
  float* const dwin = reinterpret_cast<float*>(smem + lay.dwindow);
  int* const mel_tab = reinterpret_cast<int*>(smem + lay.mel_tab);
  float* const mel_w = reinterpret_cast<float*>(smem + lay.mel_w);
  for (int i = threadIdx.x; i < N; i += blockDim.x) tw[i] = p.tw[i];
  for (int i = threadIdx.x; i < BINS; i += blockDim.x) emph[i] = p.emph[i];
  for (int i = threadIdx.x; i < p.L; i += blockDim.x) {
    win[i] = p.window[i];
    dwin[i] = p.dwindow[i];
  }
  for (int i = threadIdx.x; i < 3 * p.num_mel; i += blockDim.x)
    mel_tab[(i / p.num_mel) * round4(p.num_mel) + i % p.num_mel] = p.mel_tab[i];
  for (int i = threadIdx.x; i < p.nnz; i += blockDim.x) mel_w[i] = p.mel_w[i];
  __syncthreads();  // the only block-wide barrier
  const int* first = mel_tab;
  const int* count = mel_tab + round4(p.num_mel);
  const int* offset = mel_tab + 2 * round4(p.num_mel);
  const float c = p.preemph;

  for (int it = 0; f < n_frames; f += stride, ++it) {
    float* const xf = frames + (it & 1) * round4(p.L);
    // the next frame arrives while this one is transformed
    if (f + stride < n_frames) load_frame(frames + ((it + 1) & 1) * round4(p.L), p, f + stride, lane);
    cp_async_commit();
    cp_async_wait1();
    __syncwarp();
    float mean = 0.f;
    if (p.remove_dc) {
      float sum = 0.f;
      for (int n = lane; n < p.L; n += 32) sum += xf[n] * p.scale;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      mean = sum / p.L;
    }
    float2 z[N / 32];
    fft<N>(buf, tw, lane, xf, win, dwin, p, mean, z);
    // U[k] and D[k] from Z[k] and Z[N - k]; Y[k] = (1 - c W^k) U[k] - c D[k].
    // Z[N - k] of k = lane + 32 m is z[N/32 - 1 - m] of lane 32 - lane (lane
    // 0: its own z[(N/32 - m) mod N/32]).  The power goes where the frame's
    // samples were (BINS <= L)
    float* const power = xf;
    constexpr int NP = N / 32;
#pragma unroll
    for (int m = 0; m <= NP / 2; ++m) {
      const float2 mirror = z[NP - 1 - m];
      float2 bb = make_float2(__shfl_sync(0xffffffffu, mirror.x, (32 - lane) & 31),
                              __shfl_sync(0xffffffffu, mirror.y, (32 - lane) & 31));
      if (lane == 0) bb = z[(NP - m) % NP];
      const int k = lane + 32 * m;
      if (k < BINS) {
        const float2 a = z[m];
        const float2 u = make_float2(0.5f * (a.x + bb.x), 0.5f * (a.y - bb.y));
        const float2 d = make_float2(0.5f * (a.y + bb.y), -0.5f * (a.x - bb.x));
        const float2 y = csub(cmul(emph[k], u), make_float2(c * d.x, c * d.y));
        power[k] = __fadd_rn(__fmul_rn(y.x, y.x), __fmul_rn(y.y, y.y));
      }
    }
    __syncwarp();
    float* orow = p.out + f * p.num_mel;
    for (int m = lane; m < p.num_mel; m += 32) {
      const float* w = mel_w + offset[m];
      const float* pw = power + first[m];
      float acc = 0.f;
      for (int j = 0; j < count[m]; ++j) acc = fmaf(w[j], pw[j], acc);
      orow[m] = logf(fmaxf(acc, FLT_EPSILON));
    }
    __syncwarp();  // the buffers are read before the next frames land in them
  }
}

template <int N>
int launch(const FbankParams& base, void* stream) {
  constexpr int WARPS = warps<N>();
  static int smem_set[MAX_DEVICES] = {}, sms[MAX_DEVICES] = {}, optin[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  FbankParams p = base;
  const Layout lay = layout(N, WARPS, p.L, p.num_mel, p.nnz);
  if (lay.total > optin[dev]) return static_cast<int>(cudaErrorInvalidValue);
  if (lay.total > 48 * 1024 && lay.total > smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fbank_fft_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = lay.total;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fbank_fft_kernel<N>, 32 * WARPS,
                                                lay.total);
  // persistent blocks: as many as the card holds, each warp walking frames
  const long long blocks = (static_cast<long long>(p.B) * p.T + WARPS - 1) / WARPS;
  const int resident = sms[dev] * (per_sm > 0 ? per_sm : 1);
  const dim3 grid(static_cast<int>(blocks < resident ? blocks : resident));
  fbank_fft_kernel<N><<<grid, 32 * WARPS, lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// wav (B, W), out (B, T, num_mel): contiguous float32 on the current device.
// The tables (ops/fbank_kernel.py:kernel_tables): tw (n_fft, 2) float32
// twiddles W_n^e; emph (n_fft / 2 + 1, 2) the pre-emphasis response
// 1 - preemph W_n^k; window (L,) and dwindow (L,) its differences; mel_tab
// (3, num_mel) int32: each filter's first bin, count and offset into mel_w
// (nnz,).  n_fft one of 256, 512, 1024, 2048, with L <= n_fft.  flags: bit
// 0 scale by 32768, bit 1 remove the DC offset.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for an FFT size or a
// configuration it does not take).
int fbank_logmel_f32(const float* wav, int B, int W, int T, int L, int shift, int n_fft,
                     const float* tw, const float* emph, const float* window,
                     const float* dwindow, const int* mel_tab, const float* mel_w, int num_mel,
                     int nnz, float preemph, int flags, float* out, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (L <= 0 || L > n_fft || shift <= 0 || num_mel <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FbankParams p;
  p.wav = wav;
  p.out = out;
  p.tw = reinterpret_cast<const float2*>(tw);
  p.emph = reinterpret_cast<const float2*>(emph);
  p.window = window;
  p.dwindow = dwindow;
  p.mel_tab = mel_tab;
  p.mel_w = mel_w;
  p.B = B;
  p.W = W;
  p.T = T;
  p.L = L;
  p.shift = shift;
  p.num_mel = num_mel;
  p.nnz = nnz;
  p.vec4 = reinterpret_cast<uintptr_t>(wav) % 16 == 0 && W % 4 == 0 && shift % 4 == 0 &&
           L % 4 == 0;
  p.remove_dc = (flags >> 1) & 1;
  p.preemph = preemph;
  p.scale = (flags & 1) ? 32768.f : 1.f;
  switch (n_fft) {
    case 256: return launch<256>(p, stream);
    case 512: return launch<512>(p, stream);
    case 1024: return launch<1024>(p, stream);
    case 2048: return launch<2048>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fbank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
