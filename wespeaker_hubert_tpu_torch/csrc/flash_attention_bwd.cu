// Flash-attention backward for Hopper (sm_90a), head dim 64: the gradients of
//     out = softmax(q k^T * scale + bias, keys >= key_len masked) v
// with respect to q, k, v and the additive bias, per (batch, head), in the
// JAX layout (B, T, h, 64) read through strides; dq, dk, dv are written
// contiguous (B, T, h, 64), dbias contiguous (B, h, T, T).
//
// Replaces the backward of the upstream Pallas TPU kernel that
// wespeaker_hubert_tpu/frontend/ssl_encoder.py:_flash_mha reaches
// (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_bwd
// :254 wires _flash_attention_bwd_dkv :941, body _flash_attention_dkv_kernel
// :796, and _flash_attention_bwd_dq :1287, body _flash_attention_dq_kernel
// :1146, which also writes `ds`, the bias gradient, in the bias's dtype).
// The same two-kernel split: each kernel recomputes the scores and
//     P  = exp(s - lse)              (lse from the forward, csrc/flash_attention.cu)
//     dS = P * (dO v^T - D)          (D = rowsum(out * dO), from the wrapper)
// and accumulates one side, so nothing needs atomics and the result is the
// same from run to run:
//   dkv: one block per (64-key tile, head, batch), a loop over query tiles:
//        dV = P^T dO, dK = scale * dS^T q;
//   dq:  one block per (64-query tile, head, batch), a loop over key tiles:
//        dQ = scale * dS k, and dBias = dS where the bias needs a gradient.
// A key at or past key_len has P = 0, so dS = 0 there and its dK, dV are 0;
// a row with no valid key (lse = -inf) gets 0 everywhere, as its forward
// output is 0.  Key tiles at or past key_len are skipped (dBias is written 0).
//
// What bounds it.  WavLM-Large training (B = 64, T = 75, h = 16, bf16) must
// read q, k, v, out, dO and write dq, dk, dv (8 x 9.83 MB) and read the
// materialized gated bias and write its gradient (2 x 11.52 MB): 101.7 MB,
// 0.0304 ms at 3.35 TB/s.  The work it needs is 10 T^2 64 per (b, h): 3.69
// GFLOP, 0.0037 ms at 989 TFLOP/s of dense bf16.  So it is set by bytes, a
// quarter of them the bias and its gradient.  At extraction's 16 x 10 s shape
// (16, 499, 16, 64) the bound is 385.8 MB, 0.115 ms, two thirds of it bias.
// What this design does about it: each input tile is read from device memory
// once per block that needs it (q, dO once per key tile, k, v once per query
// tile), the scores, P and dS never leave registers, and the bias is read and
// its gradient written once per valid (query, key) pair.  It recomputes S and
// dO v^T in both kernels (14 T^2 64 operations against the 10 needed), which
// costs nothing at a byte bound.  TMA, wgmma, a pipelined tile ring and
// coalesced dBias stores are later work; this is the simple form, held
// against its plain PyTorch version
// (ops/flash_attention.py:flash_attention_bwd_reference).
//   bf16: 4 warps, 16 rows of the block's tile each; all five products run
//         on the tensor cores as mma.sync m16n8k16 (bf16 in, float32
//         accumulators); P and dS are rounded to bf16 as the A operand of
//         their products, as the TPU kernel casts them to dO's dtype.
//   f32:  one thread per row of the block's tile, FP32 FMA (no TF32); the
//         thread's own q / dO (or k / v) row in padded shared memory, the
//         other side's tile read as shared-memory broadcasts.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int HD = 64;       // head dim, the kernel's only one
constexpr int BM = 64;       // rows (queries or keys) per block
constexpr int LDS = HD + 8;  // bf16 row stride in shared memory (144 B)
constexpr int F32_TILE = 16; // the other side's rows per shared tile, f32
constexpr int LDF = HD + 1;  // f32 row stride of a thread's own row: the
                             // 32 rows a warp reads fall on distinct banks
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;     // null: no bias
  const int* key_len;   // null: every key is valid
  const void* dout;
  const float* lse;     // (B, H, T), natural log
  const float* delta;   // (B, H, T), rowsum(out * dout)
  void* dq;             // (B, T, H, 64) contiguous
  void* dk;
  void* dv;
  void* dbias;          // null: not written; else (B, H, T, T) contiguous
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;  // of dout
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  int T;
  int H;
  float scale;
};

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  if (p.key_len == nullptr) return p.T;
  return min(max(p.key_len[b], 0), p.T);
}

// offset of row t of (b, h) in a contiguous (B, T, H, 64) output
__device__ __forceinline__ long long out_row(const Params& p, int b, int t, int h) {
  return ((static_cast<long long>(b) * p.T + t) * p.H + h) * HD;
}

// offset of (b, h, t) in a contiguous (B, H, T) row statistic
__device__ __forceinline__ long long stat_row(const Params& p, int b, int h, int t) {
  return (static_cast<long long>(b) * p.H + h) * p.T + t;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

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

// rows [r0, r0 + 64) of a (T, 64) bf16 slab into shared memory, 16 bytes per
// load; rows past T are zero
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long st, int r0, int T) {
  for (int c = threadIdx.x; c < BM * HD / 8; c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + col);
    *reinterpret_cast<uint4*>(dst + r * LDS + col) = val;
  }
}

// the A fragments of this warp's 16 rows (r0 and r0 + 8) of a staged tile,
// over the 4 k-steps of the head dim
__device__ __forceinline__ void row_fragments(uint32_t (&a)[4][4], const __nv_bfloat16* tile,
                                              int r0, int c2) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const __nv_bfloat16* base = tile + r0 * LDS + ks * 16 + c2;
    a[ks][0] = ld_u32(base);
    a[ks][1] = ld_u32(base + 8 * LDS);
    a[ks][2] = ld_u32(base + 8);
    a[ks][3] = ld_u32(base + 8 * LDS + 8);
  }
}

// acc[nt] (16 rows x 8 columns each) = rows(a) . tile^T over the head dim:
// the tile's rows are the 64 columns
__device__ __forceinline__ void rows_times_tile_t(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                                  const __nv_bfloat16* tile, int g, int c2) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const __nv_bfloat16* bp = tile + (nt * 8 + g) * LDS + ks * 16 + c2;
      mma_16816(acc[nt], a[ks], ld_u32(bp), ld_u32(bp + 8));
    }
  }
}

// out[dt] += x . tile, with x (16 rows x 64 tile rows) from registers in the
// accumulator layout (rounded to bf16) and the tile (64 rows x 64 dims)
__device__ __forceinline__ void acc_times_tile(float (&out)[8][4], const float (&x)[8][4],
                                               const __nv_bfloat16* tile, int g, int c2) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t a[4] = {pack_f32(x[2 * ks][0], x[2 * ks][1]),
                           pack_f32(x[2 * ks][2], x[2 * ks][3]),
                           pack_f32(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                           pack_f32(x[2 * ks + 1][2], x[2 * ks + 1][3])};
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const __nv_bfloat16* tp = tile + (ks * 16 + c2) * LDS + dt * 8 + g;
      mma_16816(out[dt], a, pack_bf16(tp[0], tp[LDS]), pack_bf16(tp[8 * LDS], tp[9 * LDS]));
    }
  }
}

__device__ __forceinline__ void store_rows_bf16(const Params& p, void* dst, const float (&x)[8][4],
                                                int b, int h, int t0, int c2, float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 8 * i;
    if (t >= p.T) continue;
    __nv_bfloat16* row = static_cast<__nv_bfloat16*>(dst) + out_row(p, b, t, h);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + c2) =
          __floats2bfloat162_rn(x[dt][2 * i] * mul, x[dt][2 * i + 1] * mul);
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 sq[BM * LDS];   // K, then Q tiles
  __shared__ __align__(16) __nv_bfloat16 sdo[BM * LDS];  // V, then dO tiles
  __shared__ float slse[BM], sdelta[BM];

  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int T = p.T;
  const int kv_len = valid_keys(p, b);
  const int r0 = warp * 16 + g;  // this thread's key rows: k0 + r0, k0 + r0 + 8

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  if (k0 < kv_len) {  // else every key of the tile is masked: dK = dV = 0
    const __nv_bfloat16* q =
        static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dout =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
    if (bias != nullptr) bias += b * p.bias_sb + h * p.bias_sh;

    // the tile's keys and values, kept as A fragments for the whole loop
    stage_tile(sq, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh,
               p.k_st, k0, T);
    stage_tile(sdo, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh,
               p.v_st, k0, T);
    __syncthreads();
    uint32_t ka[4][4], va[4][4];
    row_fragments(ka, sq, r0, c2);
    row_fragments(va, sdo, r0, c2);
    const int key[2] = {k0 + r0, k0 + r0 + 8};
    const float scale2 = p.scale * LOG2E;

    for (int q0 = 0; q0 < T; q0 += BM) {
      __syncthreads();  // every warp is done with the previous tiles
      stage_tile(sq, q, p.q_st, q0, T);
      stage_tile(sdo, dout, p.o_st, q0, T);
      for (int r = tid; r < BM; r += blockDim.x) {
        const bool in = q0 + r < T;
        slse[r] = in ? p.lse[stat_row(p, b, h, q0 + r)] * LOG2E : -CUDART_INF_F;
        sdelta[r] = in ? p.delta[stat_row(p, b, h, q0 + r)] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
      float s[8][4], ds[8][4];
      rows_times_tile_t(s, ka, sq, g, c2);
      rows_times_tile_t(ds, va, sdo, g, c2);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = nt * 8 + c2 + (e & 1);
          const float lse2 = slse[col];  // -inf past T and for an empty row
          float pr = 0.f;
          if (key[i] < kv_len && lse2 != -CUDART_INF_F) {
            float x = s[nt][e] * scale2;
            if (bias != nullptr)
              x = fmaf(__bfloat162float(bias[(q0 + col) * p.bias_sq + key[i] * p.bias_sk]),
                       LOG2E, x);
            pr = exp2f(x - lse2);
          }
          s[nt][e] = pr;                           // P^T
          ds[nt][e] = pr * (ds[nt][e] - sdelta[col]);  // dS^T
        }
      }
      acc_times_tile(dv, s, sdo, g, c2);   // dV += P^T dO
      acc_times_tile(dk, ds, sq, g, c2);   // dK += dS^T Q
    }
  }
  store_rows_bf16(p, p.dk, dk, b, h, k0 + r0, c2, p.scale);
  store_rows_bf16(p, p.dv, dv, b, h, k0 + r0, c2, 1.f);
}

__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 sk[BM * LDS];  // Q, then K tiles
  __shared__ __align__(16) __nv_bfloat16 sv[BM * LDS];  // dO, then V tiles

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int T = p.T;
  const int kv_len = valid_keys(p, b);
  const int r0 = warp * 16 + g;  // this thread's query rows: q0 + r0, q0 + r0 + 8
  const int row[2] = {q0 + r0, q0 + r0 + 8};
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
  if (bias != nullptr) bias += b * p.bias_sb + h * p.bias_sh;
  __nv_bfloat16* dbias = static_cast<__nv_bfloat16*>(p.dbias);

  stage_tile(sk, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh,
             p.q_st, q0, T);
  stage_tile(sv, static_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh,
             p.o_st, q0, T);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  row_fragments(qa, sk, r0, c2);
  row_fragments(da, sv, r0, c2);

  float lse2[2], delta[2];
  long long brow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < T;
    lse2[i] = in ? p.lse[stat_row(p, b, h, row[i])] * LOG2E : -CUDART_INF_F;
    delta[i] = in ? p.delta[stat_row(p, b, h, row[i])] : 0.f;
    brow[i] = min(row[i], T - 1) * p.bias_sq;
    drow[i] = stat_row(p, b, h, min(row[i], T - 1)) * T;
  }
  const float scale2 = p.scale * LOG2E;

  float dq[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BM) {
    if (k0 >= kv_len) {  // every key masked: dS = 0 (uniform over the block)
      if (dbias != nullptr) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row[i] >= T) continue;
          for (int c = c2; c < BM; c += 8) {
            const int key = k0 + c;
            if (key < T) dbias[drow[i] + key] = __float2bfloat16(0.f);
            if (key + 1 < T) dbias[drow[i] + key + 1] = __float2bfloat16(0.f);
          }
        }
      }
      continue;
    }
    __syncthreads();  // every warp is done with the previous tiles (or Q, dO)
    stage_tile(sk, k, p.k_st, k0, T);
    stage_tile(sv, v, p.v_st, k0, T);
    __syncthreads();

    float s[8][4], ds[8][4];
    rows_times_tile_t(s, qa, sk, g, c2);   // S = Q K^T
    rows_times_tile_t(ds, da, sv, g, c2);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + nt * 8 + c2 + (e & 1);
        float pr = 0.f;
        if (key < kv_len && lse2[i] != -CUDART_INF_F) {
          float x = s[nt][e] * scale2;
          if (bias != nullptr)
            x = fmaf(__bfloat162float(bias[brow[i] + key * p.bias_sk]), LOG2E, x);
          pr = exp2f(x - lse2[i]);
        }
        ds[nt][e] = pr * (ds[nt][e] - delta[i]);
        if (dbias != nullptr && row[i] < T && key < T)
          dbias[drow[i] + key] = __float2bfloat16(ds[nt][e]);
      }
    }
    acc_times_tile(dq, ds, sk, g, c2);  // dQ += dS K
  }
  store_rows_bf16(p, p.dq, dq, b, h, q0 + r0, c2, p.scale);
}

// f32, dK / dV: thread tid owns key k0 + tid; its k and v rows sit in padded
// shared memory, dK and dV in registers; query tiles of F32_TILE rows are
// read as broadcasts
__global__ void __launch_bounds__(BM) flash_bwd_dkv_f32(const Params p) {
  __shared__ float sk[BM * LDF], sv[BM * LDF];
  __shared__ __align__(16) float sq[F32_TILE * HD], sdo[F32_TILE * HD];
  __shared__ float slse[F32_TILE], sdelta[F32_TILE];

  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, key = k0 + tid;
  const int T = p.T;
  const int kv_len = valid_keys(p, b);
  float dk[HD], dv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dk[d] = dv[d] = 0.f;

  if (k0 < kv_len) {
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
    const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
    const float* dout = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const float* bias = static_cast<const float*>(p.bias);
    if (bias != nullptr) bias += b * p.bias_sb + h * p.bias_sh + min(key, T - 1) * p.bias_sk;
    for (int c = tid; c < BM * HD / 4; c += blockDim.x) {
      const int r = c / (HD / 4), col = (c % (HD / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + r < T) {
        kk = *reinterpret_cast<const float4*>(k + (k0 + r) * p.k_st + col);
        vv = *reinterpret_cast<const float4*>(v + (k0 + r) * p.v_st + col);
      }
      float* kd = sk + r * LDF + col;
      float* vd = sv + r * LDF + col;
      kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    const float* kr = sk + tid * LDF;
    const float* vr = sv + tid * LDF;
    const bool valid = key < kv_len;

    for (int q0 = 0; q0 < T; q0 += F32_TILE) {
      __syncthreads();
      for (int c = tid; c < F32_TILE * HD / 4; c += blockDim.x) {
        const int r = c / (HD / 4), col = (c % (HD / 4)) * 4;
        float4 qq = make_float4(0.f, 0.f, 0.f, 0.f), oo = qq;
        if (q0 + r < T) {
          qq = *reinterpret_cast<const float4*>(q + (q0 + r) * p.q_st + col);
          oo = *reinterpret_cast<const float4*>(dout + (q0 + r) * p.o_st + col);
        }
        *reinterpret_cast<float4*>(sq + r * HD + col) = qq;
        *reinterpret_cast<float4*>(sdo + r * HD + col) = oo;
      }
      for (int r = tid; r < F32_TILE; r += blockDim.x) {
        const bool in = q0 + r < T;
        slse[r] = in ? p.lse[stat_row(p, b, h, q0 + r)] : -CUDART_INF_F;
        sdelta[r] = in ? p.delta[stat_row(p, b, h, q0 + r)] : 0.f;
      }
      __syncthreads();
      if (!valid) continue;  // a masked key: P = 0 for every query
      for (int j = 0; j < F32_TILE; ++j) {
        const float lse = slse[j];
        if (lse == -CUDART_INF_F) continue;  // past T or an empty row
        const float* qj = sq + j * HD;
        const float* oj = sdo + j * HD;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          s = fmaf(kr[d], qj[d], s);
          dp = fmaf(vr[d], oj[d], dp);
        }
        float x = s * p.scale;
        if (bias != nullptr) x += bias[(q0 + j) * p.bias_sq];
        const float pr = expf(x - lse);
        const float ds = pr * (dp - sdelta[j]);
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dv[d] = fmaf(pr, oj[d], dv[d]);
          dk[d] = fmaf(ds, qj[d], dk[d]);
        }
      }
    }
  }
  if (key < T) {
    float* dkr = static_cast<float*>(p.dk) + out_row(p, b, key, h);
    float* dvr = static_cast<float*>(p.dv) + out_row(p, b, key, h);
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      *reinterpret_cast<float4*>(dkr + d) = make_float4(
          dk[d] * p.scale, dk[d + 1] * p.scale, dk[d + 2] * p.scale, dk[d + 3] * p.scale);
      *reinterpret_cast<float4*>(dvr + d) = make_float4(dv[d], dv[d + 1], dv[d + 2], dv[d + 3]);
    }
  }
}

// f32, dQ (+ dBias): thread tid owns query q0 + tid; its q and dO rows sit in
// padded shared memory, dQ in registers; key tiles of F32_TILE rows are read
// as broadcasts
__global__ void __launch_bounds__(BM) flash_bwd_dq_f32(const Params p) {
  __shared__ float sq[BM * LDF], sdo[BM * LDF];
  __shared__ __align__(16) float sk[F32_TILE * HD], sv[F32_TILE * HD];

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t = q0 + tid;
  const int T = p.T;
  const int kv_len = valid_keys(p, b);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* bias = static_cast<const float*>(p.bias);
  if (bias != nullptr) bias += b * p.bias_sb + h * p.bias_sh + min(t, T - 1) * p.bias_sq;
  float* dbias = static_cast<float*>(p.dbias);
  if (dbias != nullptr) dbias += stat_row(p, b, h, min(t, T - 1)) * T;

  for (int c = tid; c < BM * HD / 4; c += blockDim.x) {
    const int r = c / (HD / 4), col = (c % (HD / 4)) * 4;
    float4 qq = make_float4(0.f, 0.f, 0.f, 0.f), oo = qq;
    if (q0 + r < T) {
      qq = *reinterpret_cast<const float4*>(q + (q0 + r) * p.q_st + col);
      oo = *reinterpret_cast<const float4*>(dout + (q0 + r) * p.o_st + col);
    }
    float* qd = sq + r * LDF + col;
    float* od = sdo + r * LDF + col;
    qd[0] = qq.x; qd[1] = qq.y; qd[2] = qq.z; qd[3] = qq.w;
    od[0] = oo.x; od[1] = oo.y; od[2] = oo.z; od[3] = oo.w;
  }
  const float* qr = sq + tid * LDF;
  const float* dor = sdo + tid * LDF;
  const bool in = t < T;
  const float lse = in ? p.lse[stat_row(p, b, h, t)] : -CUDART_INF_F;
  const float delta = in ? p.delta[stat_row(p, b, h, t)] : 0.f;
  const bool live = lse != -CUDART_INF_F;

  float dq[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dq[d] = 0.f;

  for (int k0 = 0; k0 < T; k0 += F32_TILE) {
    if (k0 >= kv_len) {  // masked keys: dS = 0
      if (dbias != nullptr && in)
        for (int j = k0; j < min(k0 + F32_TILE, T); ++j) dbias[j] = 0.f;
      continue;
    }
    __syncthreads();
    for (int c = tid; c < F32_TILE * HD / 4; c += blockDim.x) {
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
    for (int j = 0; j < F32_TILE; ++j) {
      const int key = k0 + j;
      if (key >= T) break;
      float ds = 0.f;
      if (live && key < kv_len) {
        const float* kj = sk + j * HD;
        const float* vj = sv + j * HD;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          s = fmaf(qr[d], kj[d], s);
          dp = fmaf(dor[d], vj[d], dp);
        }
        float x = s * p.scale;
        if (bias != nullptr) x += bias[key * p.bias_sk];
        ds = expf(x - lse) * (dp - delta);
#pragma unroll
        for (int d = 0; d < HD; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
      }
      if (dbias != nullptr && in) dbias[key] = ds;
    }
  }
  if (in) {
    float* dqr = static_cast<float*>(p.dq) + out_row(p, b, t, h);
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(dqr + d) = make_float4(
          dq[d] * p.scale, dq[d + 1] * p.scale, dq[d + 2] * p.scale, dq[d + 3] * p.scale);
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   const int* key_len, const void* dout, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv, void* dbias, int T,
                   int H, const long long* strides, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.key_len = key_len;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dbias = dbias;
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
  p.H = H;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v, bias, dout and the gradients
// alike).  q, k, v, dout (B, T, H, 64) with a contiguous head dim; `strides`
// (host memory) holds the element strides q_sb, q_st, q_sh, k_*, v_*,
// dout_*, then the bias's (b, h, query, key) strides.  lse and delta are
// contiguous (B, H, T) float32; dk, dv contiguous (B, T, H, 64).  bias and
// key_len may be null.  Launches on `stream`; returns cudaGetLastError().
int flash_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* bias, const int* key_len, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            int B, int T, int H, const long long* strides, float scale,
                            void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  const Params p = make_params(q, k, v, bias, key_len, dout, lse, delta, nullptr, dk, dv,
                               nullptr, T, H, strides, scale);
  const dim3 grid((T + BM - 1) / BM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash_bwd_dkv_bf16<<<grid, 128, 0, s>>>(p);
  } else if (dtype == 0) {
    flash_bwd_dkv_f32<<<grid, BM, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As flash_attention_bwd_dkv, writing dq (B, T, H, 64) and, unless null,
// dbias (B, H, T, T), both contiguous and in the inputs' dtype.
int flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* bias, const int* key_len, const void* dout,
                           const float* lse, const float* delta, void* dq, void* dbias,
                           int B, int T, int H, const long long* strides, float scale,
                           void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  const Params p = make_params(q, k, v, bias, key_len, dout, lse, delta, dq, nullptr,
                               nullptr, dbias, T, H, strides, scale);
  const dim3 grid((T + BM - 1) / BM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash_bwd_dq_bf16<<<grid, 128, 0, s>>>(p);
  } else if (dtype == 0) {
    flash_bwd_dq_f32<<<grid, BM, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
