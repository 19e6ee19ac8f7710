// Flash-attention forward for Hopper (sm_90a), head dim 64:
//     out = softmax(q k^T * scale + bias, keys >= key_len masked) v
// per (batch, head), with q, k, v and out in the JAX layout (B, T, h, 64),
// read and written through their strides (no transposes).
//
// Replaces the TPU kernel that wespeaker_hubert_tpu/frontend/ssl_encoder.py
// :_flash_mha reaches: the upstream Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention (its forward,
// _flash_attention_impl).  There, padded keys are masked by an additive
// -1e9 in `ab` or by SegmentIds and T is padded to a multiple of 128; here a
// per-row key length masks them (the same softmax: exp(-1e9 - max) is 0 in
// float32) and the last tile is masked in place, so nothing is padded.
//
// What bounds it.  WavLM-Large at 16 x 10 s (B = 16, T = 499, h = 16, bf16)
// does 4 B h T^2 64 = 16.3 GFLOP per launch, 0.0165 ms at 989 TFLOP/s of
// dense bf16, and moves q, k, v and out (65.4 MB) plus the materialized
// (B, h, T, T) gated position bias (127.5 MB): 0.0576 ms at 3.35 TB/s.  So
// as it is called it is bound by bytes, and by the bias above all; forming
// the gated bias in the kernel from the (h, T, T) table and a (B, h, T) gate
// would cut the bytes to about 73 MB (0.022 ms).  In float32 the products run
// in FP32 FMA (no TF32: the JAX flash path does not round to TF32), 0.24 ms at
// 67 TFLOP/s, bound by operations.
//
// What this design does.  One block per (64-query tile, head, batch row).
// The block stages the tile's queries, then walks the key tiles below the
// row's key length: each tile of keys and values is staged in shared memory,
// the scores and the running max and sum of the online softmax stay in
// registers in float32, and only the output is written (with, when training,
// each row's log-sum-exp for csrc/flash_attention_bwd.cu).  The bias is read
// once per valid (query, key) pair, with arbitrary (broadcast) strides.
//   bf16: 4 warps, 16 query rows each; Q K^T and P V run on the tensor cores
//         as mma.sync m16n8k16 (bf16 in, float32 accumulators).  The scores'
//         accumulator layout is the A-operand layout of P V, so P goes from
//         registers to the tensor cores without shared memory.
//   f32:  one thread per query row (q row and output row in registers), 32
//         keys per tile read as shared-memory broadcasts, FP32 FMA.
// TMA, wgmma, a pipelined K/V ring and the in-kernel gated bias are later
// work; this is the simple form, held against its plain PyTorch version
// (ops/flash_attention.py:flash_attention_reference).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int HD = 64;       // head dim, the kernel's only one
constexpr int BM = 64;       // query rows per block
constexpr int BN = 64;       // keys per shared-memory tile, bf16
constexpr int BN_F32 = 32;   // keys per shared-memory tile, f32
constexpr int LDS = HD + 8;  // bf16 row stride in shared memory (144 B): the
                             // 8 rows a fragment load touches fall on
                             // distinct banks
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;     // null: no bias
  const int* key_len;   // null: every key is valid
  void* out;
  float* lse;           // null: not written; else (B, h, T) row log-sum-exp
  // element strides of the (B, T, h) axes; the head dim is contiguous
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  // element strides of the bias over (B, h, query, key); 0 broadcasts
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  int T;
  float scale;
};

// the natural-log log-sum-exp of a row for the backward (ops/flash_attention
// .py:flash_attention_bwd); -inf for a row with no valid key
__device__ __forceinline__ void store_lse(const Params& p, int b, int h, int t, float lse) {
  if (p.lse != nullptr && t < p.T) p.lse[((long long)b * gridDim.y + h) * p.T + t] = lse;
}

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  if (p.key_len == nullptr) return p.T;
  return min(max(p.key_len[b], 0), p.T);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// two bf16 in one register, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16 x 16, row major) * b (16 x 8, column major); bf16 in, f32 out.
// Lane l holds, with g = l / 4 and c = 2 * (l % 4):
//   a: {A[g][c..c+1], A[g+8][c..c+1], A[g][c+8..c+9], A[g+8][c+8..c+9]}
//   b: {B[c..c+1][g], B[c+8..c+9][g]}
//   d: {D[g][c], D[g][c+1], D[g+8][c], D[g+8][c+1]}
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(128) flash_fwd_bf16(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 sq[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 sk[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 sv[BN * LDS];

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int T = p.T;
  const int kv_len = valid_keys(p, b);
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
  if (bias != nullptr) bias += b * p.bias_sb + h * p.bias_sh;

  // the query tile, 16 bytes per load; rows past T are zero
  for (int c = tid; c < BM * HD / 8; c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < T) val = *reinterpret_cast<const uint4*>(q + (q0 + r) * p.q_st + col);
    *reinterpret_cast<uint4*>(sq + r * LDS + col) = val;
  }
  __syncthreads();

  // this thread's rows of the tile: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  uint32_t qa[4][4];  // A fragments of the 4 k-steps over the head dim
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const __nv_bfloat16* base = sq + r0 * LDS + ks * 16 + c2;
    qa[ks][0] = ld_u32(base);
    qa[ks][1] = ld_u32(base + 8 * LDS);
    qa[ks][2] = ld_u32(base + 8);
    qa[ks][3] = ld_u32(base + 8 * LDS + 8);
  }
  // bias rows (a tail row past T reads row T - 1; it is never stored)
  const long long brow[2] = {min(q0 + r0, T - 1) * p.bias_sq,
                             min(q0 + r0 + 8, T - 1) * p.bias_sq};

  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  const float scale2 = p.scale * LOG2E;  // scores in the log2 domain

  for (int k0 = 0; k0 < kv_len; k0 += BN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < BN * HD / 8; c += blockDim.x) {
      const int r = c >> 3, col = (c & 7) * 8;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (k0 + r < T) {
        kk = *reinterpret_cast<const uint4*>(k + (k0 + r) * p.k_st + col);
        vv = *reinterpret_cast<const uint4*>(v + (k0 + r) * p.v_st + col);
      }
      *reinterpret_cast<uint4*>(sk + r * LDS + col) = kk;
      *reinterpret_cast<uint4*>(sv + r * LDS + col) = vv;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* kp = sk + (nt * 8 + g) * LDS + ks * 16 + c2;
        mma_16816(s[nt], qa[ks], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // scale, bias and key mask; the tile's row max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + nt * 8 + c2 + (e & 1);
        float x = -CUDART_INF_F;
        if (key < kv_len) {
          x = s[nt][e] * scale2;
          if (bias != nullptr)
            x = fmaf(__bfloat162float(bias[brow[i] + key * p.bias_sk]), LOG2E, x);
        }
        s[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    // a row's 64 columns are spread over the 4 lanes of its quad; key k0 is
    // valid, so the max is finite
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = exp2f(m[i] - mx[i]);  // 0 on the first tile
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];  // this lane's part of the row sum
      }
    }

    // O += P V: the score tiles 2 ks and 2 ks + 1 are the A fragment of keys
    // 16 ks .. 16 ks + 15
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * ks][0], s[2 * ks][1]), pack_f32(s[2 * ks][2], s[2 * ks][3]),
          pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* vp = sv + (ks * 16 + c2) * LDS + dt * 8 + g;
        mma_16816(o[dt], pa, pack_bf16(vp[0], vp[LDS]),
                  pack_bf16(vp[8 * LDS], vp[9 * LDS]));
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no valid key: 0
    const int t = q0 + r0 + 8 * i;
    // m is in the log2 domain; one lane of the quad writes the row's value
    if ((lane & 3) == 0)
      store_lse(p, b, h, t, l[i] > 0.f ? (m[i] + log2f(l[i])) / LOG2E : -CUDART_INF_F);
    if (t < T) {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(out + t * p.o_st + dt * 8 + c2) =
            __floats2bfloat162_rn(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
      }
    }
  }
}

__global__ void __launch_bounds__(BM) flash_fwd_f32(const Params p) {
  __shared__ __align__(16) float sk[BN_F32 * HD];
  __shared__ __align__(16) float sv[BN_F32 * HD];

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t = q0 + tid;
  const int T = p.T;
  const int kv_len = valid_keys(p, b);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias = static_cast<const float*>(p.bias);
  if (bias != nullptr) bias += b * p.bias_sb + h * p.bias_sh + min(t, T - 1) * p.bias_sq;

  float qr[HD], o[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) x = *reinterpret_cast<const float4*>(q + t * p.q_st + d);
    qr[d] = x.x;
    qr[d + 1] = x.y;
    qr[d + 2] = x.z;
    qr[d + 3] = x.w;
    o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += BN_F32) {
    __syncthreads();
    for (int c = tid; c < BN_F32 * HD / 4; c += blockDim.x) {
      const int r = c / (HD / 4), col = (c % (HD / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + r < T) {
        kk = *reinterpret_cast<const float4*>(k + (k0 + r) * p.k_st + col);
        vv = *reinterpret_cast<const float4*>(v + (k0 + r) * p.v_st + col);
      }
      *reinterpret_cast<float4*>(sk + r * HD + col) = kk;
      *reinterpret_cast<float4*>(sv + r * HD + col) = vv;
    }
    __syncthreads();

    float s[BN_F32];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BN_F32; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(sk + j * HD + d);
        acc = fmaf(qr[d], kk.x, acc);
        acc = fmaf(qr[d + 1], kk.y, acc);
        acc = fmaf(qr[d + 2], kk.z, acc);
        acc = fmaf(qr[d + 3], kk.w, acc);
      }
      const int key = k0 + j;
      float x = -CUDART_INF_F;
      if (key < kv_len) {
        x = acc * p.scale;
        if (bias != nullptr) x += bias[key * p.bias_sk];
      }
      s[j] = x;
      mx = fmaxf(mx, x);  // key k0 is valid: finite
    }
    const float alpha = expf(m - mx);  // 0 on the first tile
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN_F32; ++j) {
      const float pj = expf(s[j] - mx);
      l += pj;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(sv + j * HD + d);
        o[d] = fmaf(pj, vv.x, o[d]);
        o[d + 1] = fmaf(pj, vv.y, o[d + 1]);
        o[d + 2] = fmaf(pj, vv.z, o[d + 2]);
        o[d + 3] = fmaf(pj, vv.w, o[d + 3]);
      }
    }
  }

  store_lse(p, b, h, t, l > 0.f ? m + logf(l) : -CUDART_INF_F);
  if (t < T) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no valid key: 0
    float* out = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh + t * p.o_st;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      *reinterpret_cast<float4*>(out + d) =
          make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
    }
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v, bias and out alike).  q, k, v, out
// (B, T, H, 64) with a contiguous head dim; `strides` (host memory) holds
// the element strides q_sb, q_st, q_sh, k_*, v_*, out_*, then the bias's
// (b, h, query, key) strides.  bias and key_len (B int32) may be null; so
// may lse, a contiguous (B, H, T) float32 output of each row's log-sum-exp
// (natural log) for the backward.  Launches on `stream` and returns
// cudaGetLastError().
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        const void* bias, const int* key_len, void* out, float* lse,
                        int B, int T, int H, const long long* strides, float scale,
                        void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.key_len = key_len;
  p.out = out;
  p.lse = lse;
  p.q_sb = strides[0];
  p.q_st = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_st = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_st = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_st = strides[10];
  p.o_sh = strides[11];
  p.bias_sb = strides[12];
  p.bias_sh = strides[13];
  p.bias_sq = strides[14];
  p.bias_sk = strides[15];
  p.T = T;
  p.scale = scale;
  const dim3 grid((T + BM - 1) / BM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash_fwd_bf16<<<grid, 128, 0, s>>>(p);
  } else if (dtype == 0) {
    flash_fwd_f32<<<grid, BM, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
