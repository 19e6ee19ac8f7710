// Flash-attention backward for Hopper (sm_90a), head dim 64: the gradients of
//     out = softmax(q k^T * scale + bias, keys >= key_len masked) v
// with respect to q, k, v and the additive bias, per (batch, head), in the
// JAX layout (B, T, h, 64) read through strides; dq, dk, dv are written
// contiguous (B, T, h, 64), dbias (dS) contiguous (B, h, T, T8) with T8 = T
// rounded up to a multiple of 8 (the wrapper returns the [..., :T] view).
//
// Replaces the backward of the upstream Pallas TPU kernel that
// wespeaker_hubert_tpu/frontend/ssl_encoder.py:_flash_mha reaches
// (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_bwd
// :254 wires _flash_attention_bwd_dkv :941, body _flash_attention_dkv_kernel
// :796, and _flash_attention_bwd_dq :1287, pallas_call :1456, body
// _flash_attention_dq_kernel :1146, which also writes `ds`, the bias
// gradient, in the bias's dtype).  The same two-kernel split, each kernel
// recomputing the scores and
//     P  = exp(s - lse)              (lse from the forward, csrc/flash_attention.cu)
//     dS = P * (dO v^T - D),  D = rowsum(out * dO)
// and accumulating one side, so nothing needs atomics and the result is the
// same from run to run.  dQ runs first and computes D for its rows (JAX
// computes it outside its kernels); dK/dV, next on the same stream, reads it:
//   dq:  per (64-query tile, head, batch), a loop over key tiles:
//        D, dQ = scale * dS k, dBias = dS where the bias needs a gradient,
//        and with a gate the gate's gradient sum_k dS * table;
//   dkv: per (64-key tile, head, batch), a loop over query tiles:
//        dV = P^T dO, dK = scale * dS^T q.
// A key at or past key_len has P = 0, so dS = 0 there and its dK, dV are 0;
// a row with no valid key (lse = -inf) gets 0 everywhere, as its forward
// output is 0.  Key tiles at or past key_len are skipped (dBias is written 0).
//
// The bias is anything that broadcasts to (B, h, T, T) or, for WavLM, the
// factored gated bias: a (h, T, T) table and a (B, h, T) gate, the effective
// bias round(gate * table) formed in the kernels as in the forward.  dbias is
// then dS, the gradient of the effective bias, from which the wrapper sums
// the table's gradient (sum over b of dS * gate: a reduction across blocks);
// the gate's gradient is a sum over one row's keys, which the dQ block walks
// whole, so it is formed in the kernel.
//
// What bounds it.  WavLM-Large training (B = 64, T = 75, h = 16, bf16) with
// the factored bias: dK/dV must read q, k, v, dO (4 x 9.83 MB), lse and D
// (2 x 0.31 MB), the table (0.18 MB) and the gate (0.15 MB) and write dk, dv
// (2 x 9.83 MB): about 60 MB, 0.018 ms at 3.35 TB/s.  dQ reads q, k, v, dO
// and out, lse, the table and gate, and writes dq, D, the gate's gradient and
// dS (B h T^2 x 2 bytes, 11.5 MB): about 71 MB, 0.021 ms.  Against that, 4
// or 3 T^2 64-products per (b, h) (at most 1.5 GFLOP, 0.0015 ms at 989
// TFLOP/s): both kernels are bound by bytes.
//
// Both bf16 kernels are persistent blocks (as many as the card holds at
// once, two per SM) walking work items, one 64-row tile of one (batch row,
// head) each: a consumer warpgroup owns the item's 64 rows (wgmma's M), a
// producer warp runs its TMA loads ahead of it through mbarrier rings.  At
// the training shape an item is one tile of the other side, so a block per
// item would spend its life waiting on its loads; the rings overlap them with
// the previous item.  Products run as wgmma from 128B-swizzled shared memory;
// P and dS stay in registers (the accumulator layout is wgmma's A-register
// layout, flash_sm90.cuh), rounded to bf16 as the TPU kernel casts them to
// dO's dtype.  The other side's tile width is a compile-time choice made per
// T (ops/flash_attention.py:key_tile): 80 for T <= 80, so the training
// shape's 75 are one tile, else 64.  wgmma's 64-row M leaves 53 of 128 rows
// empty at T = 75 (0.59 of M used).
//
// dQ, bf16 (flash_bwd_dq_bf16_sm90).  The producer loads Q, dO and out for
// the item's rows into a 2-slot ring (the next item's arrive while this one
// computes), then K, V and the bias block (64 queries x BK keys) per key
// tile into a 2-stage ring.  The consumers form D from out and dO in shared
// memory (a quad of lanes per row pair, float32), run S = Q K^T and
// dP = dO V^T with K, V as K-major B operands, and dQ += dS K with dS from
// registers and K as the MN-major B of the same tile.  dS (bf16) is written
// back over the bias block it was formed from, each thread over the pairs it
// read, and leaves by one TMA store per tile (dS rows are 150 bytes at
// T = 75: 2-byte scalar stores wasted most of each write; the padded T8 rows
// are what TMA's 16-byte strides need).  The gate's gradient accumulates per
// row in float32 from the same bf16 pairs and is written once per row.  dQ
// leaves through the out tile by a TMA store.
// dK/dV, bf16 (flash_bwd_dkv_bf16_sm90).  K and V into a 2-slot ring, query
// tiles into a 2-stage ring: Q, dO and the bias block (BQ queries x 64
// keys) by TMA, each row's lse, D and gate loaded by the producer warp's 32
// lanes into the same stage.  S^T = K Q^T and dP^T = V dO^T (K, V the A
// operands); dV += P^T dO and dK += dS^T Q with dO and Q the MN-major B.  The
// bias block is read transposed from shared memory (128B-swizzled rows of 64
// keys: the four query rows a load touches fall on distinct banks).  dK and
// dV go out by TMA stores through shared memory.
// f32 (the checking path): one thread per row of the block's tile, FP32 FMA
// (no TF32); the thread's own q / dO (or k / v) row in padded shared memory,
// the other side's tile read as shared-memory broadcasts; the dQ kernel
// writes D and the gate's gradient as the bf16 one does.  Every version is
// held against the plain PyTorch backward
// (ops/flash_attention.py:flash_attention_bwd_reference).

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "flash_sm90.cuh"

namespace {

constexpr int HD = 64;       // head dim, the kernel's only one
constexpr int BM = 64;       // rows (queries or keys) per block
constexpr int F32_TILE = 16; // the other side's rows per shared tile, f32
constexpr int LDF = HD + 1;  // f32 row stride of a thread's own row: the
                             // 32 rows a warp reads fall on distinct banks
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;     // null: no bias
  const void* gate;     // null: the bias is used as it is
  const int* key_len;   // null: every key is valid
  const void* dout;
  const void* out;      // the forward's output, read by dQ for D
  const float* lse;     // (B, H, T), natural log
  float* delta;         // (B, H, T), rowsum(out * dout): dQ writes it, dK/dV reads it
  void* dq;             // (B, T, H, 64) contiguous
  void* dk;
  void* dv;
  void* dbias;          // null: not written; else (B, H, T, ds_stride) contiguous
  void* dgate;          // null: not written; else (B, H, T) contiguous
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;  // of dout
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  long long gate_sb, gate_sh, gate_st;
  long long out_sb, out_st, out_sh;
  long long ds_stride;  // dbias's row stride, T rounded up to a multiple of 8
  int T;
  int H;
  float scale;
};

// the gate of query row t of (b, h), 1 without a gate
template <typename E>
__device__ __forceinline__ float gate_of(const Params& p, int b, int h, int t) {
  if (p.gate == nullptr) return 1.f;
  const E x = static_cast<const E*>(p.gate)[b * p.gate_sb + h * p.gate_sh + t * p.gate_st];
  if constexpr (sizeof(E) == 2) return __bfloat162float(x);
  else return x;
}

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

// f32, dK / dV: thread tid owns key k0 + tid; its k and v rows sit in padded
// shared memory, dK and dV in registers; query tiles of F32_TILE rows are
// read as broadcasts
__global__ void __launch_bounds__(BM) flash_bwd_dkv_f32(const Params p) {
  __shared__ float sk[BM * LDF], sv[BM * LDF];
  __shared__ __align__(16) float sq[F32_TILE * HD], sdo[F32_TILE * HD];
  __shared__ float slse[F32_TILE], sdelta[F32_TILE], sgate[F32_TILE];

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
        sgate[r] = in ? gate_of<float>(p, b, h, q0 + r) : 1.f;
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
        if (bias != nullptr) x += sgate[j] * bias[(q0 + j) * p.bias_sq];
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

// f32, dQ (+ dBias, D, the gate's gradient): thread tid owns query q0 + tid;
// its q and dO rows sit in padded shared memory, dQ in registers; key tiles
// of F32_TILE rows are read as broadcasts.  It writes its row's D for the
// dK/dV kernel, which runs after it on the same stream.
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
  if (dbias != nullptr) dbias += stat_row(p, b, h, min(t, T - 1)) * p.ds_stride;

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
  __syncthreads();  // the rows are staged by every thread
  const float* qr = sq + tid * LDF;
  const float* dor = sdo + tid * LDF;
  const bool in = t < T;
  const float lse = in ? p.lse[stat_row(p, b, h, t)] : -CUDART_INF_F;
  // D = rowsum(out * dO) of this row
  float delta = 0.f;
  if (in) {
    const float* o = static_cast<const float*>(p.out) + b * p.out_sb + h * p.out_sh + t * p.out_st;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 oo = *reinterpret_cast<const float4*>(o + d);
      delta = fmaf(oo.x, dor[d], delta);
      delta = fmaf(oo.y, dor[d + 1], delta);
      delta = fmaf(oo.z, dor[d + 2], delta);
      delta = fmaf(oo.w, dor[d + 3], delta);
    }
    p.delta[stat_row(p, b, h, t)] = delta;
  }
  const float gate = gate_of<float>(p, b, h, min(t, T - 1));
  const bool live = lse != -CUDART_INF_F;
  float dgate = 0.f;  // sum over keys of dS * table

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
        const float tab = bias != nullptr ? bias[key * p.bias_sk] : 0.f;
        x += gate * tab;
        ds = expf(x - lse) * (dp - delta);
        dgate = fmaf(ds, tab, dgate);
#pragma unroll
        for (int d = 0; d < HD; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
      }
      if (dbias != nullptr && in) dbias[key] = ds;
    }
  }
  if (in && p.dgate != nullptr) static_cast<float*>(p.dgate)[stat_row(p, b, h, t)] = dgate;
  if (in) {
    float* dqr = static_cast<float*>(p.dq) + out_row(p, b, t, h);
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(dqr + d) = make_float4(
          dq[d] * p.scale, dq[d + 1] * p.scale, dq[d + 2] * p.scale, dq[d + 3] * p.scale);
  }
}

// ------------------------------------------------ dK / dV, bf16 (TMA, wgmma)
struct DkvParams {
  CUtensorMap tq, tk, tv, tdo, tbias, tdk, tdv;
  const __nv_bfloat16* gate;  // null: the bias is used as it is
  long long gate_sb, gate_sh, gate_st;
  const int* key_len;         // null: every key is valid
  const float* lse;           // (B, H, T), natural log
  const float* delta;         // (B, H, T)
  int B, T, H;
  int has_bias, bias_bcast_b, bias_bcast_h;
  float scale;
};

template <int BQ>
struct DkvTile {
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BM * 128;    // 64 keys of K or V
  static constexpr int KV_SLOT = 2 * KV_BYTES; // K then V of one work item
  static constexpr int OUT_BYTES = 2 * KV_BYTES;  // dK then dV, staged for the stores
  static constexpr int Q_BYTES = BQ * 128;     // a query tile of Q or dO
  static constexpr int BIAS_BYTES = BQ * 128;  // BQ queries x 64 keys
  static constexpr int STAT_BYTES = 1024;      // lse (log2), D, gate: 3 x BQ floats
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + BIAS_BYTES + STAT_BYTES;
  static constexpr int SMEM = 1024 + 2 * KV_SLOT + OUT_BYTES + STAGES * STAGE_BYTES;
  static constexpr int NACC = BQ / 2;
};

// a work item: one 64-key tile of one (batch row, head)
struct DkvItem {
  int k0, h, b, kv_len;
};

__device__ __forceinline__ DkvItem dkv_item(const DkvParams& p, int item, int n_kt) {
  DkvItem it;
  it.k0 = (item % n_kt) * BM;
  it.h = (item / n_kt) % p.H;
  it.b = item / (n_kt * p.H);
  it.kv_len = p.key_len == nullptr ? p.T : min(max(p.key_len[it.b], 0), p.T);
  return it;
}

// two blocks per SM: left to itself ptxas takes 183 registers at BQ = 80,
// and the card then holds one block per SM, too few to hide each work item's
// latency
template <int BQ>
__global__ void __launch_bounds__(160, 2) flash_bwd_dkv_bf16_sm90(const __grid_constant__ DkvParams p) {
  using C = DkvTile<BQ>;
  static_assert(3 * BQ * 4 <= C::STAT_BYTES, "row statistics overflow their slot");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::STAGES], empty_bar[C::STAGES];
  __shared__ __align__(8) uint64_t kv_full[2], kv_empty[2];
  uint8_t* const kv = sm90::align1024(smem_raw);  // two slots of K, V
  uint8_t* const so = kv + 2 * C::KV_SLOT;        // dK, dV on their way out
  uint8_t* const ring = so + C::OUT_BYTES;

  const int T = p.T;
  const int n_kt = (T + BM - 1) / BM, n_items = n_kt * p.H * p.B;
  const int n_q = (T + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 128);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full_bar[s], 1 + 32);  // the copies' bytes + the warp's statistics
      sm90::mbar_init(&empty_bar[s], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: lane 0 issues the copies,
                             // every lane loads row statistics
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      sm90::prefetch_map(&p.tk);
      sm90::prefetch_map(&p.tv);
      sm90::prefetch_map(&p.tq);
      sm90::prefetch_map(&p.tdo);
      if (p.has_bias) sm90::prefetch_map(&p.tbias);
    }
    const uint32_t bytes = 2 * C::Q_BYTES + (p.has_bias ? C::BIAS_BYTES : 0);
    int n_live = 0, gi = 0;  // live items and query tiles issued so far
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const DkvItem it = dkv_item(p, item, n_kt);
      if (it.k0 >= it.kv_len) continue;  // a masked tile: nothing to load
      const int slot = n_live & 1;
      sm90::mbar_wait(&kv_empty[slot], ((n_live >> 1) & 1) ^ 1);
      ++n_live;
      if (lane == 0) {
        uint8_t* dst = kv + slot * C::KV_SLOT;
        sm90::mbar_arrive_expect_tx(&kv_full[slot], C::KV_SLOT);
        sm90::tma_load_4d(dst, &p.tk, &kv_full[slot], 0, it.h, it.k0, it.b);
        sm90::tma_load_4d(dst + C::KV_BYTES, &p.tv, &kv_full[slot], 0, it.h, it.k0, it.b);
      }
      const int bb = p.bias_bcast_b ? 0 : it.b, bh = p.bias_bcast_h ? 0 : it.h;
      const long long srow = (static_cast<long long>(it.b) * p.H + it.h) * T;
      const __nv_bfloat16* gp =
          p.gate == nullptr ? nullptr : p.gate + it.b * p.gate_sb + it.h * p.gate_sh;
      for (int i = 0; i < n_q; ++i, ++gi) {
        const int s = gi % C::STAGES;
        uint8_t* st = ring + s * C::STAGE_BYTES;
        // every load first, then the stores: the loads' latencies overlap
        constexpr int PER_LANE = (BQ + 31) / 32;
        float lse2[PER_LANE], delta[PER_LANE], gate[PER_LANE];
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          const int r = lane + 32 * j, t = i * BQ + r;
          const bool in = r < BQ && t < T;
          lse2[j] = in ? __ldg(p.lse + srow + t) * LOG2E : -CUDART_INF_F;  // past T: P = 0
          delta[j] = in ? __ldg(p.delta + srow + t) : 0.f;
          gate[j] = gp != nullptr && in ? __bfloat162float(gp[t * p.gate_st]) : 1.f;
        }
        sm90::mbar_wait(&empty_bar[s], ((gi / C::STAGES) & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full_bar[s], bytes);
          sm90::tma_load_4d(st, &p.tq, &full_bar[s], 0, it.h, i * BQ, it.b);
          sm90::tma_load_4d(st + C::Q_BYTES, &p.tdo, &full_bar[s], 0, it.h, i * BQ, it.b);
          if (p.has_bias)
            sm90::tma_load_4d(st + 2 * C::Q_BYTES, &p.tbias, &full_bar[s], it.k0, i * BQ, bh, bb);
        }
        float* stats = reinterpret_cast<float*>(st + 2 * C::Q_BYTES + C::BIAS_BYTES);
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          const int r = lane + 32 * j;
          if (r < BQ) {
            stats[r] = lse2[j];
            stats[BQ + r] = delta[j];
            stats[2 * BQ + r] = gate[j];
          }
        }
        sm90::mbar_arrive(&full_bar[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: key rows r0 and r0 + 8 of each item's tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = warp * 16 + g;
  const float scale2 = p.scale * LOG2E;
  int n_live = 0, gi = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const DkvItem it = dkv_item(p, item, n_kt);
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    if (it.k0 < it.kv_len) {  // else every key of the tile is masked: dK = dV = 0
      const int slot = n_live & 1;
      sm90::mbar_wait(&kv_full[slot], (n_live >> 1) & 1);
      ++n_live;
      const bool valid[2] = {it.k0 + r0 < it.kv_len, it.k0 + r0 + 8 < it.kv_len};
      const uint64_t kdesc = sm90::desc_k(kv + slot * C::KV_SLOT);
      const uint64_t vdesc = sm90::desc_k(kv + slot * C::KV_SLOT + C::KV_BYTES);
      for (int i = 0; i < n_q; ++i, ++gi) {
        const int s = gi % C::STAGES;
        const uint8_t* sq = ring + s * C::STAGE_BYTES;
        const uint8_t* sdo = sq + C::Q_BYTES;
        const uint8_t* sb = sq + 2 * C::Q_BYTES;
        const float* stats = reinterpret_cast<const float*>(sb + C::BIAS_BYTES);
        sm90::mbar_wait(&full_bar[s], (gi / C::STAGES) & 1);

        // S^T = K Q^T and dP^T = V dO^T (64 keys x BQ queries)
        float st[C::NACC], dp[C::NACC];
#pragma unroll
        for (int j = 0; j < C::NACC; ++j) st[j] = dp[j] = 0.f;
        const uint64_t qdesc = sm90::desc_k(sq), dodesc = sm90::desc_k(sdo);
        sm90::fence_regs(st);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_ss<BQ>(st, kdesc + ks * sm90::K_STEP, qdesc + ks * sm90::K_STEP, ks);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_ss<BQ>(dp, vdesc + ks * sm90::K_STEP, dodesc + ks * sm90::K_STEP, ks);
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_regs(st);
        sm90::fence_regs(dp);
        if (i == n_q - 1) sm90::mbar_arrive(&kv_empty[slot]);  // K and V are read

        // P^T = exp(S^T + bias^T - lse), dS^T = P^T (dP^T - D); the bias tile
        // (queries x keys) read transposed
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ii = e >> 1, col = 8 * j + c2 + (e & 1);
            const float lse2 = stats[col];  // -inf past T and for an empty row
            float pr = 0.f;
            if (valid[ii] && lse2 != -CUDART_INF_F) {
              float x = st[4 * j + e] * scale2;
              if (p.has_bias) {
                float bv = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                    sb + sm90::swz128(col, r0 + 8 * ii)));
                if (p.gate != nullptr) bv = sm90::gated(stats[2 * BQ + col], bv);
                x = fmaf(bv, LOG2E, x);
              }
              pr = exp2f(x - lse2);
            }
            st[4 * j + e] = pr;
            dp[4 * j + e] = pr * (dp[4 * j + e] - stats[BQ + col]);
          }
        }

        // dV += P^T dO, dK += dS^T Q: the A operands from registers (rounded
        // to bf16), dO and Q as the MN-major B
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks) {
          sm90::acc_to_a(pa[ks], st, ks);
          sm90::acc_to_a(da[ks], dp, ks);
        }
        const uint64_t qdesc_t = sm90::desc_mn(sq), dodesc_t = sm90::desc_mn(sdo);
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks) {
          sm90::wgmma_rs_t64(dv, pa[ks], dodesc_t + ks * sm90::MN_STEP);
          sm90::wgmma_rs_t64(dk, da[ks], qdesc_t + ks * sm90::MN_STEP);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::fence_regs(pa);
        sm90::fence_regs(da);
        sm90::mbar_arrive(&empty_bar[s]);
      }
    }

    // dK, dV through shared memory and TMA stores, which clip rows past T;
    // the previous item's stores must have read the staging tiles first
    if (tid == 0) sm90::tma_store_wait_read();
    sm90::named_barrier(1, 128);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = r0 + 8 * ii;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(so + sm90::swz128(r, 8 * j + c2)) =
            __floats2bfloat162_rn(dk[4 * j + 2 * ii] * p.scale, dk[4 * j + 2 * ii + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(so + C::KV_BYTES + sm90::swz128(r, 8 * j + c2)) =
            __floats2bfloat162_rn(dv[4 * j + 2 * ii], dv[4 * j + 2 * ii + 1]);
      }
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1, 128);
    if (tid == 0) {
      sm90::tma_store_4d(&p.tdk, so, 0, it.h, it.k0, it.b);
      sm90::tma_store_4d(&p.tdv, so + C::KV_BYTES, 0, it.h, it.k0, it.b);
      sm90::tma_store_commit();
    }
  }
  if (tid == 0) sm90::tma_store_wait_read();
}

template <int BQ>
int launch_dkv_bf16(DkvParams& p, const void* q, const void* k, const void* v, const void* dout,
                    const void* bias, void* dk, void* dv, int B, int T, int H,
                    const long long* s, cudaStream_t stream) {
  const long long out_strides[3] = {static_cast<long long>(T) * H * HD, H * HD, HD};
  int rc = sm90_host::encode_rows(&p.tq, q, B, T, H, s + 0, BQ);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tk, k, B, T, H, s + 3, BM);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tv, v, B, T, H, s + 6, BM);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tdo, dout, B, T, H, s + 9, BQ);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tdk, dk, B, T, H, out_strides, BM);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tdv, dv, B, T, H, out_strides, BM);
  if (rc == 0 && bias != nullptr)
    rc = sm90_host::encode_bias(&p.tbias, bias, B, T, H, s + 12, BQ, BM);
  if (rc != 0) return rc;
  using C = DkvTile<BQ>;
  static int resident[sm90_host::MAX_DEVICES] = {};  // blocks each card holds at once
  const int dev = sm90_host::current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16_sm90<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_bwd_dkv_bf16_sm90<BQ>, 160,
                                                  C::SMEM);
    resident[dev] = std::max(1, sms * per_sm);
  }
  // persistent blocks, each walking work items (key tile, head, batch row)
  const long long items = static_cast<long long>((T + BM - 1) / BM) * H * B;
  const int grid = static_cast<int>(std::min<long long>(items, resident[dev]));
  flash_bwd_dkv_bf16_sm90<BQ><<<grid, 160, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- dQ + dS + D + dGate, bf16 (TMA, wgmma)
struct DqParams {
  CUtensorMap tq, tk, tv, tdo, tout, tbias, tds, tdq;
  const __nv_bfloat16* gate;  // null: the bias is used as it is
  long long gate_sb, gate_sh, gate_st;
  const int* key_len;         // null: every key is valid
  const float* lse;           // (B, H, T), natural log
  float* delta;               // (B, H, T), written: rowsum(out * dO)
  __nv_bfloat16* dgate;       // null: not written; else (B, H, T)
  __nv_bfloat16* ds;          // null: dS not written; else (B, H, T, ds_stride)
  long long ds_stride;
  int B, T, H;
  int has_bias, bias_bcast_b, bias_bcast_h;
  float scale;
};

template <int BK>
struct DqTile {
  static constexpr int STAGES = 2;
  static constexpr int ROWS_BYTES = BM * 128;     // 64 rows of Q, dO or out
  static constexpr int SLOT = 3 * ROWS_BYTES;     // Q, dO, out of one work item
  static constexpr int KV_BYTES = BK * 128;       // BK keys of K or V
  static constexpr int BIAS_BYTES = BM * BK * 2;  // 64 queries x BK keys; dS leaves from here
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + BIAS_BYTES;
  static constexpr int SMEM = 1024 + 2 * SLOT + STAGES * STAGE_BYTES;
  static constexpr int NACC = BK / 2;
};

// a work item: one 64-query tile of one (batch row, head)
struct DqItem {
  int q0, h, b, kv_len;
};

__device__ __forceinline__ DqItem dq_item(const DqParams& p, int item, int n_qt) {
  DqItem it;
  it.q0 = (item % n_qt) * BM;
  it.h = (item / n_qt) % p.H;
  it.b = item / (n_qt * p.H);
  it.kv_len = p.key_len == nullptr ? p.T : min(max(p.key_len[it.b], 0), p.T);
  return it;
}

// sum over 8 columns of out * dO, both 8 bf16 in one 16-byte chunk
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// two blocks per SM (as dK/dV): a block's shared memory (109 KB at BK = 80)
// and registers leave room for a second, which hides one block's loads
// behind the other's products
template <int BK>
__global__ void __launch_bounds__(160, 2) flash_bwd_dq_bf16_sm90(const __grid_constant__ DqParams p) {
  using C = DqTile<BK>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::STAGES], empty_bar[C::STAGES];
  __shared__ __align__(8) uint64_t rows_full[2], rows_empty[2];
  uint8_t* const rows = sm90::align1024(smem_raw);  // two slots of Q, dO, out
  uint8_t* const ring = rows + 2 * C::SLOT;

  const int T = p.T;
  const int n_qt = (T + BM - 1) / BM, n_items = n_qt * p.H * p.B;
  const int n_kt = (T + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&rows_full[s], 1);
      sm90::mbar_init(&rows_empty[s], 128);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full_bar[s], 1);
      sm90::mbar_init(&empty_bar[s], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp; one lane issues the copies
    if (threadIdx.x == 128) {
      sm90::prefetch_map(&p.tq);
      sm90::prefetch_map(&p.tdo);
      sm90::prefetch_map(&p.tout);
      sm90::prefetch_map(&p.tk);
      sm90::prefetch_map(&p.tv);
      if (p.has_bias) sm90::prefetch_map(&p.tbias);
      const uint32_t bytes = 2 * C::KV_BYTES + (p.has_bias ? C::BIAS_BYTES : 0);
      int n = 0, gi = 0;  // items and key tiles issued so far
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const DqItem it = dq_item(p, item, n_qt);
        const int slot = n & 1;
        sm90::mbar_wait(&rows_empty[slot], ((n >> 1) & 1) ^ 1);
        uint8_t* dst = rows + slot * C::SLOT;
        sm90::mbar_arrive_expect_tx(&rows_full[slot], C::SLOT);
        sm90::tma_load_4d(dst, &p.tq, &rows_full[slot], 0, it.h, it.q0, it.b);
        sm90::tma_load_4d(dst + C::ROWS_BYTES, &p.tdo, &rows_full[slot], 0, it.h, it.q0, it.b);
        sm90::tma_load_4d(dst + 2 * C::ROWS_BYTES, &p.tout, &rows_full[slot], 0, it.h, it.q0, it.b);
        const int bb = p.bias_bcast_b ? 0 : it.b, bh = p.bias_bcast_h ? 0 : it.h;
        const int n_live = (it.kv_len + BK - 1) / BK;  // key tiles with a valid key
        for (int i = 0; i < n_live; ++i, ++gi) {
          const int s = gi % C::STAGES;
          uint8_t* st = ring + s * C::STAGE_BYTES;
          sm90::mbar_wait(&empty_bar[s], ((gi / C::STAGES) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full_bar[s], bytes);
          sm90::tma_load_4d(st, &p.tk, &full_bar[s], 0, it.h, i * BK, it.b);
          sm90::tma_load_4d(st + C::KV_BYTES, &p.tv, &full_bar[s], 0, it.h, i * BK, it.b);
          if (p.has_bias)
            sm90::tma_load_4d(st + 2 * C::KV_BYTES, &p.tbias, &full_bar[s], i * BK, it.q0, bh, bb);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: query rows r0 and r0 + 8 of each item's tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, quad = lane & 3, c2 = quad * 2;
  const int r0 = warp * 16 + g;
  const float scale2 = p.scale * LOG2E;
  const bool write_ds = p.ds != nullptr;
  int n = 0, gi = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const DqItem it = dq_item(p, item, n_qt);
    const int slot = n & 1;
    const long long srow = (static_cast<long long>(it.b) * p.H + it.h) * T;
    // the rows' statistics, loaded while the item's tiles arrive
    float lse2[2], gate[2] = {1.f, 1.f};
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int t = it.q0 + r0 + 8 * ii;
      lse2[ii] = t < T ? __ldg(p.lse + srow + t) * LOG2E : -CUDART_INF_F;  // past T: P = 0
      if (p.gate != nullptr && t < T)
        gate[ii] = __bfloat162float(p.gate[it.b * p.gate_sb + it.h * p.gate_sh + t * p.gate_st]);
    }
    sm90::mbar_wait(&rows_full[slot], (n >> 1) & 1);
    uint8_t* const sq = rows + slot * C::SLOT;
    uint8_t* const sdo = sq + C::ROWS_BYTES;
    uint8_t* const sout = sq + 2 * C::ROWS_BYTES;

    // D = rowsum(out * dO) in float32: lane `quad` of the row's quad sums
    // its 16 columns (two swizzled 16-byte chunks), then the quad adds up
    float delta[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = r0 + 8 * ii;
      float acc = 0.f;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const uint32_t off = r * 128 + ((((2 * quad + cc) ^ r) & 7) << 4);
        acc += dot8(*reinterpret_cast<const uint4*>(sout + off),
                    *reinterpret_cast<const uint4*>(sdo + off));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      delta[ii] = acc;
      if (quad == 0 && it.q0 + r < T) p.delta[srow + it.q0 + r] = acc;
    }

    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    float dg[2] = {0.f, 0.f};  // this lane's part of sum_k bf16(dS) * table
    const uint64_t qdesc = sm90::desc_k(sq), dodesc = sm90::desc_k(sdo);
    const int n_live = (it.kv_len + BK - 1) / BK;
    for (int i = 0; i < n_live; ++i, ++gi) {
      const int s = gi % C::STAGES;
      uint8_t* const st = ring + s * C::STAGE_BYTES;
      uint8_t* const sb = st + 2 * C::KV_BYTES;
      sm90::mbar_wait(&full_bar[s], (gi / C::STAGES) & 1);

      // S = Q K^T and dP = dO V^T (64 queries x BK keys)
      float sacc[C::NACC], dp[C::NACC];
#pragma unroll
      for (int j = 0; j < C::NACC; ++j) sacc[j] = dp[j] = 0.f;
      const uint64_t kdesc = sm90::desc_k(st), vdesc = sm90::desc_k(st + C::KV_BYTES);
      sm90::fence_regs(sacc);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        sm90::wgmma_ss<BK>(sacc, qdesc + ks * sm90::K_STEP, kdesc + ks * sm90::K_STEP, ks);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        sm90::wgmma_ss<BK>(dp, dodesc + ks * sm90::K_STEP, vdesc + ks * sm90::K_STEP, ks);
      sm90::wgmma_commit();
      // this thread's bias pairs, read while the products run
      uint32_t bv[BK / 8][2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
          bv[j][ii] = p.has_bias ? *reinterpret_cast<const uint32_t*>(
                                       sb + sm90::bias_off<BK>(r0 + 8 * ii, 8 * j + c2))
                                 : 0u;
      sm90::wgmma_wait0();
      sm90::fence_regs(sacc);
      sm90::fence_regs(dp);

      // P = exp(S + bias - lse), dS = P (dP - D), in dp
      const int k0 = i * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = e >> 1, key = k0 + 8 * j + c2 + (e & 1);
          float pr = 0.f;
          if (key < it.kv_len && lse2[ii] != -CUDART_INF_F) {
            float x = sacc[4 * j + e] * scale2;
            if (p.has_bias) {
              const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&bv[j][ii]);
              float bias = __bfloat162float((e & 1) ? pair.y : pair.x);
              if (p.gate != nullptr) bias = sm90::gated(gate[ii], bias);
              x = fmaf(bias, LOG2E, x);
            }
            pr = exp2f(x - lse2[ii]);
          }
          dp[4 * j + e] = pr * (dp[4 * j + e] - delta[ii]);
        }
      }

      // dS rounded to bf16 (as the TPU kernel casts it): the A operand of
      // dQ += dS K, the gate's gradient against the table pair, and dS out
      // through the bias tile (each thread overwrites the pairs it read)
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) sm90::acc_to_a(da[ks], dp, ks);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const uint32_t d2 = da[j >> 1][(j & 1) * 2 + ii];
          if (p.gate != nullptr) {
            const float2 dsf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d2));
            const float2 tab = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[j][ii]));
            dg[ii] = fmaf(dsf.x, tab.x, fmaf(dsf.y, tab.y, dg[ii]));
          }
          if (write_ds)
            *reinterpret_cast<uint32_t*>(sb + sm90::bias_off<BK>(r0 + 8 * ii, 8 * j + c2)) = d2;
        }
      }
      if (write_ds) sm90::fence_proxy_async();
      // dQ += dS K: K as the MN-major B of the same swizzled tile
      const uint64_t kdesc_t = sm90::desc_mn(st);
      sm90::fence_regs(dq);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) sm90::wgmma_rs_t64(dq, da[ks], kdesc_t + ks * sm90::MN_STEP);
      sm90::wgmma_commit();
      if (write_ds) {  // every pair of the tile is in place: one TMA store (clips past T)
        sm90::named_barrier(1, 128);
        if (tid == 0) {
          sm90::tma_store_4d(&p.tds, sb, k0, it.q0, it.h, it.b);
          sm90::tma_store_commit();
        }
      }
      sm90::wgmma_wait0();
      sm90::fence_regs(dq);
      sm90::fence_regs(da);
      // the stage is free once K and V are read and the store has read dS
      if (tid == 0 && write_ds) sm90::tma_store_wait_read();
      sm90::mbar_arrive(&empty_bar[s]);
    }
    // key tiles past key_len: dS is 0 there (plain 16-byte stores, through
    // the row padding)
    if (write_ds && n_live < n_kt) {
      const int c0 = n_live * BK, chunks = static_cast<int>((p.ds_stride - c0) / 8);
      __nv_bfloat16* base = p.ds + (srow + it.q0) * p.ds_stride + c0;
      for (int idx = tid; idx < BM * chunks; idx += 128) {
        const int r = idx / chunks, c = idx - r * chunks;
        if (it.q0 + r < T)
          *reinterpret_cast<uint4*>(base + r * p.ds_stride + 8 * c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // the gate's gradient: the quad's four parts, one store per row
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      dg[ii] += __shfl_xor_sync(0xffffffffu, dg[ii], 1);
      dg[ii] += __shfl_xor_sync(0xffffffffu, dg[ii], 2);
      const int t = it.q0 + r0 + 8 * ii;
      if (p.dgate != nullptr && quad == 0 && t < T) p.dgate[srow + t] = __float2bfloat16(dg[ii]);
    }
    // dQ through the out tile (read only for D, by this quad) and a TMA
    // store, which clips rows past T
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = r0 + 8 * ii;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(sout + sm90::swz128(r, 8 * j + c2)) =
            __floats2bfloat162_rn(dq[4 * j + 2 * ii] * p.scale, dq[4 * j + 2 * ii + 1] * p.scale);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1, 128);
    if (tid == 0) {
      sm90::tma_store_4d(&p.tdq, sout, 0, it.h, it.q0, it.b);
      sm90::tma_store_commit_and_wait();  // the slot is reloaded after this
    }
    sm90::mbar_arrive(&rows_empty[slot]);
  }
}

template <int BK>
int launch_dq_bf16(DqParams& p, const void* q, const void* k, const void* v, const void* dout,
                   const void* out, const void* bias, void* dq, int B, int T, int H,
                   const long long* s, cudaStream_t stream) {
  const long long dq_strides[3] = {static_cast<long long>(T) * H * HD, H * HD, HD};
  int rc = sm90_host::encode_rows(&p.tq, q, B, T, H, s + 0, BM);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tk, k, B, T, H, s + 3, BK);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tv, v, B, T, H, s + 6, BK);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tdo, dout, B, T, H, s + 9, BM);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tout, out, B, T, H, s + 19, BM);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tdq, dq, B, T, H, dq_strides, BM);
  if (rc == 0 && bias != nullptr)
    rc = sm90_host::encode_bias(&p.tbias, bias, B, T, H, s + 12, BM, BK);
  if (rc == 0 && p.ds != nullptr) {
    const long long ds_bhqk[4] = {static_cast<long long>(H) * T * p.ds_stride,
                                  static_cast<long long>(T) * p.ds_stride, p.ds_stride, 1};
    rc = sm90_host::encode_bias(&p.tds, p.ds, B, T, H, ds_bhqk, BM, BK);
  }
  if (rc != 0) return rc;
  using C = DqTile<BK>;
  static int resident[sm90_host::MAX_DEVICES] = {};  // blocks each card holds at once
  const int dev = sm90_host::current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_bf16_sm90<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_bwd_dq_bf16_sm90<BK>, 160,
                                                  C::SMEM);
    resident[dev] = std::max(1, sms * per_sm);
  }
  // persistent blocks, each walking work items (query tile, head, batch row)
  const long long items = static_cast<long long>((T + BM - 1) / BM) * H * B;
  const int grid = static_cast<int>(std::min<long long>(items, resident[dev]));
  flash_bwd_dq_bf16_sm90<BK><<<grid, 160, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   const void* gate, const int* key_len, const void* dout, const void* out,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, void* dbias,
                   void* dgate, int T, int H, const long long* strides, long long ds_stride,
                   float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.gate = bias != nullptr ? gate : nullptr;
  p.key_len = key_len;
  p.dout = dout;
  p.out = out;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dbias = dbias;
  p.dgate = p.gate != nullptr ? dgate : nullptr;
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
  p.gate_sb = strides[16];
  p.gate_sh = strides[17];
  p.gate_st = strides[18];
  p.out_sb = out != nullptr ? strides[19] : 0;
  p.out_st = out != nullptr ? strides[20] : 0;
  p.out_sh = out != nullptr ? strides[21] : 0;
  p.ds_stride = ds_stride;
  p.T = T;
  p.H = H;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v, bias, gate, dout and the
// gradients alike).  q, k, v, dout (B, T, H, 64) with a contiguous head dim;
// `strides` (host memory) holds the element strides q_sb, q_st, q_sh, k_*,
// v_*, dout_*, then the bias's (b, h, query, key) strides (0 broadcasts),
// then the gate's (b, h, query).  With a gate the effective bias is
// round(gate * bias).  lse and delta are contiguous (B, H, T) float32; dk, dv
// contiguous (B, T, H, 64).  bias, gate and key_len may be null.  bf16 needs
// what TMA takes (csrc/flash_attention.cu:flash_attention_fwd).  `tile` is
// the bf16 kernel's query-tile width, 64 or 80 (ops/flash_attention.py:
// key_tile); float32 ignores it.  Launches on `stream`; returns
// cudaGetLastError() or an encoding error.
int flash_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* bias, const void* gate, const int* key_len,
                            const void* dout, const float* lse, const float* delta, void* dk,
                            void* dv, int B, int T, int H, const long long* strides,
                            float scale, int tile, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    DkvParams p;
    p.gate = static_cast<const __nv_bfloat16*>(bias != nullptr ? gate : nullptr);
    p.gate_sb = strides[16];
    p.gate_sh = strides[17];
    p.gate_st = strides[18];
    p.key_len = key_len;
    p.lse = lse;
    p.delta = delta;
    p.B = B;
    p.T = T;
    p.H = H;
    p.has_bias = bias != nullptr;
    p.bias_bcast_b = strides[12] == 0;
    p.bias_bcast_h = strides[13] == 0;
    p.scale = scale;
    if (tile == 80)
      return launch_dkv_bf16<80>(p, q, k, v, dout, bias, dk, dv, B, T, H, strides, s);
    if (tile == 64)
      return launch_dkv_bf16<64>(p, q, k, v, dout, bias, dk, dv, B, T, H, strides, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, bias, gate, key_len, dout, nullptr, lse,
                               const_cast<float*>(delta), nullptr, dk, dv, nullptr, nullptr, T, H,
                               strides, 0, scale);
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_bwd_dkv_f32<<<grid, BM, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The first of the two backward launches; dK/dV, launched after it on the
// same stream, reads the D it writes.  As flash_attention_bwd_dkv, with
// `out` (the forward's output, (B, T, H, 64), its element strides at
// strides[19..21]) in place of D and these outputs: dq (B, T, H, 64)
// contiguous; delta (B, H, T) float32, D = rowsum(out * dout); unless null,
// dbias (B, H, T, ds_stride) contiguous, ds_stride a multiple of 8 >= T:
// dS, the gradient of the effective bias, in the inputs' dtype, its first T
// columns written (bf16: TMA stores, which need the 16-byte rows); unless
// null or without a gate, dgate (B, H, T) contiguous in the gate's dtype:
// sum over keys of dS * bias, the gate's gradient (dS rounded to bf16 first
// in bf16).  bf16 needs what TMA takes of out, as of dout.
int flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* bias, const void* gate, const int* key_len,
                           const void* dout, const void* out, const float* lse, float* delta,
                           void* dq, void* dbias, void* dgate, int B, int T, int H,
                           const long long* strides, long long ds_stride, float scale, int tile,
                           void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (dbias != nullptr && (ds_stride < T || ds_stride % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    DqParams p;
    p.gate = static_cast<const __nv_bfloat16*>(bias != nullptr ? gate : nullptr);
    p.gate_sb = strides[16];
    p.gate_sh = strides[17];
    p.gate_st = strides[18];
    p.key_len = key_len;
    p.lse = lse;
    p.delta = delta;
    p.dgate = p.gate != nullptr ? static_cast<__nv_bfloat16*>(dgate) : nullptr;
    p.ds = static_cast<__nv_bfloat16*>(dbias);
    p.ds_stride = ds_stride;
    p.B = B;
    p.T = T;
    p.H = H;
    p.has_bias = bias != nullptr;
    p.bias_bcast_b = strides[12] == 0;
    p.bias_bcast_h = strides[13] == 0;
    p.scale = scale;
    if (tile == 80)
      return launch_dq_bf16<80>(p, q, k, v, dout, out, bias, dq, B, T, H, strides, s);
    if (tile == 64)
      return launch_dq_bf16<64>(p, q, k, v, dout, out, bias, dq, B, T, H, strides, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, bias, gate, key_len, dout, out, lse, delta, dq, nullptr,
                               nullptr, dbias, dgate, T, H, strides, ds_stride, scale);
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_bwd_dq_f32<<<grid, BM, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_bwd_error_string(int code) {
  if (code == sm90_host::ERR_NO_ENCODER)
    return "the driver has no cuTensorMapEncodeTiled (TMA needs a Hopper driver)";
  if (code == sm90_host::ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
