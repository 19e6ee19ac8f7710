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
// dK/dV, f32 (flash_bwd_dkv_f32_sm90): 3xTF32 on wgmma (flash_sm90.cuh), for
// float32 accuracy with TF32 off.  Whisper's joint fine-tuning (16, 251, 20)
// needs 1.03e10 FLOP: 0.154 ms on the CUDA cores, 0.063 ms as three tf32
// products at 495 TFLOP/s, against 0.037 ms of bytes: the operations bound
// it.  One block per (64-key tile, head, batch row): a consumer warpgroup
// owns the 64 keys, a producer warp loads K and V once (by TMA, split in
// place into hi and lo) and query tiles of 32 rows of Q and dO into a
// 2-stage ring, with each row's lse (log2) and D and gate in the same stage.
// The split pass writes Q and dO hi / lo as loaded (the B operands of
// S^T = K Q^T and dP^T = V dO^T) and transposed (64 rows of d x 32 queries,
// permuted per perm8: the B operands of dV += P^T dO and dK += dS^T Q, which
// contract over queries); then the stage is released.  Each product runs as
// the three wgmma passes lo x hi, hi x lo, hi x hi; P^T and dS^T are split
// in registers as the A operands.  32 query rows per stage keep shared
// memory at 163 KB (64 rows would need 128 KB of split query tiles alone).
// The bias and gate are read with plain loads through their strides (off
// Whisper's path).  dK and dV leave by plain float2 stores; a key tile wholly
// past key_len writes zeros and loads nothing.
// dQ, f32 (flash_bwd_dq_f32_sm90): 3xTF32 on wgmma as well.  One block per
// (64-query tile, head, batch row): a consumer warpgroup owns the 64 rows,
// a producer warp loads Q and dO once (split in place) and raw K and V
// tiles of 64 keys into a 2-stage ring.  The split pass writes K and V
// hi / lo as loaded (the B operands of S = Q K^T and dP = dO V^T) and K
// transposed (64 rows of d x 64 keys, perm8: the B operand of dQ += dS K);
// dS is split in registers as the A operand.  S runs in the forward's passes
// and k8 steps on the forward's key tiles, so P = exp(S - lse) is formed
// from the very scores lse was: a score rounded otherwise (as FP32 FMA rounds
// it) moves P by its error times |S| and, where dP - D cancels, moved dQ by
// 2.9e-4 at max |S| = 40.  D comes from out and dO by plain loads, 16
// columns per lane of a row's quad; dS and the bias are read and written by
// plain loads and float2 stores.  224 KB of shared memory.  Every version is
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
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------ dK / dV, f32 (3xTF32 wgmma)
struct DkvF32Params {
  CUtensorMap tq, tk, tv, tdo;
  const float* bias;    // null: no bias; else read through its strides
  const float* gate;    // null: the bias is used as it is
  const int* key_len;   // null: every key is valid
  const float* lse;     // (B, H, T), natural log
  const float* delta;   // (B, H, T)
  float* dk;            // (B, T, H, 64) contiguous
  float* dv;
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  long long gate_sb, gate_sh, gate_st;
  int T, H;
  float scale;
};

struct DkvF32Tile {
  static constexpr int BQ = 32;                 // query rows per stage
  static constexpr int KV_BYTES = BM * HD * 4;  // K or V (64 keys), hi or lo: 16 KB
  static constexpr int QT_BYTES = BQ * HD * 4;  // a query tile of Q or dO, any layout: 8 KB
  static constexpr int STAT_BYTES = 1024;       // lse (log2), D, gate: 3 x BQ floats
  static constexpr int STAGES = 2;
  static constexpr int STAGE_BYTES = 2 * QT_BYTES + STAT_BYTES;  // raw Q, raw dO, statistics
  static constexpr int SMEM = 1024 + 4 * KV_BYTES + STAGES * STAGE_BYTES + 8 * QT_BYTES;
};

__global__ void __launch_bounds__(160, 1)
    flash_bwd_dkv_f32_sm90(const __grid_constant__ DkvF32Params p) {
  using C = DkvF32Tile;
  using sm90::desc_k;
  using sm90::K_STEP;
  using sm90::wgmma_tf32_rs64;
  static_assert(3 * C::BQ * 4 <= C::STAT_BYTES, "row statistics overflow their slot");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::STAGES], empty_bar[C::STAGES], kv_bar;
  uint8_t* const khi = sm90::align1024(smem_raw);  // K as loaded, then its hi part
  uint8_t* const klo = khi + C::KV_BYTES;
  uint8_t* const vhi = klo + C::KV_BYTES;
  uint8_t* const vlo = vhi + C::KV_BYTES;
  uint8_t* const ring = vlo + C::KV_BYTES;
  uint8_t* const qhi = ring + C::STAGES * C::STAGE_BYTES;
  uint8_t* const qlo = qhi + C::QT_BYTES;
  uint8_t* const qthi = qlo + C::QT_BYTES;   // Q^T: 64 rows of d x 32 queries
  uint8_t* const qtlo = qthi + C::QT_BYTES;
  uint8_t* const dohi = qtlo + C::QT_BYTES;
  uint8_t* const dolo = dohi + C::QT_BYTES;
  uint8_t* const dothi = dolo + C::QT_BYTES;
  uint8_t* const dotlo = dothi + C::QT_BYTES;

  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int T = p.T;
  const int kv_len = p.key_len == nullptr ? T : min(max(p.key_len[b], 0), T);
  const int n_q = (T + C::BQ - 1) / C::BQ;

  if (k0 >= kv_len) {  // every key of the tile is masked: dK = dV = 0
    for (int u = threadIdx.x; u < BM * HD / 4; u += blockDim.x) {
      const int key = k0 + u / (HD / 4), col = (u % (HD / 4)) * 4;
      if (key >= T) break;
      const long long off = ((static_cast<long long>(b) * T + key) * p.H + h) * HD + col;
      *reinterpret_cast<float4*>(p.dk + off) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(p.dv + off) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(&kv_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full_bar[s], 1 + 32);  // the copies' bytes + the warp's statistics
      sm90::mbar_init(&empty_bar[s], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: lane 0 issues the copies,
                             // every lane loads one row's statistics
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      sm90::prefetch_map(&p.tk);
      sm90::prefetch_map(&p.tv);
      sm90::prefetch_map(&p.tq);
      sm90::prefetch_map(&p.tdo);
      sm90::mbar_arrive_expect_tx(&kv_bar, 2 * C::KV_BYTES);
      for (int kc = 0; kc < 2; ++kc) {
        sm90::tma_load_4d(khi + kc * BM * 128, &p.tk, &kv_bar, 32 * kc, h, k0, b);
        sm90::tma_load_4d(vhi + kc * BM * 128, &p.tv, &kv_bar, 32 * kc, h, k0, b);
      }
    }
    const long long srow = (static_cast<long long>(b) * p.H + h) * T;
    const float* gp = p.gate == nullptr ? nullptr : p.gate + b * p.gate_sb + h * p.gate_sh;
    for (int i = 0; i < n_q; ++i) {
      const int s = i % C::STAGES;
      uint8_t* st = ring + s * C::STAGE_BYTES;
      const int t = i * C::BQ + lane;
      const bool in = t < T;
      const float lse2 = in ? __ldg(p.lse + srow + t) * LOG2E : -CUDART_INF_F;  // past T: P = 0
      const float delta = in ? __ldg(p.delta + srow + t) : 0.f;
      const float gate = gp != nullptr && in ? gp[t * p.gate_st] : 1.f;
      sm90::mbar_wait(&empty_bar[s], ((i / C::STAGES) & 1) ^ 1);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full_bar[s], 2 * C::QT_BYTES);
        for (int kc = 0; kc < 2; ++kc) {
          sm90::tma_load_4d(st + kc * C::BQ * 128, &p.tq, &full_bar[s], 32 * kc, h, i * C::BQ, b);
          sm90::tma_load_4d(st + C::QT_BYTES + kc * C::BQ * 128, &p.tdo, &full_bar[s], 32 * kc,
                            h, i * C::BQ, b);
        }
      }
      float* stats = reinterpret_cast<float*>(st + 2 * C::QT_BYTES);
      stats[lane] = lse2;
      stats[C::BQ + lane] = delta;
      stats[2 * C::BQ + lane] = gate;
      sm90::mbar_arrive(&full_bar[s]);
    }
    return;
  }

  // ---- the consumer warpgroup: key rows r0 and r0 + 8 of the tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = warp * 16 + g;
  const bool valid[2] = {k0 + r0 < kv_len, k0 + r0 + 8 < kv_len};
  const float* bcol[2] = {nullptr, nullptr};  // this thread's keys' column of the bias
  if (p.bias != nullptr) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
      bcol[ii] = p.bias + b * p.bias_sb + h * p.bias_sh + min(k0 + r0 + 8 * ii, T - 1) * p.bias_sk;
  }
  const float scale2 = p.scale * LOG2E;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  sm90::mbar_wait(&kv_bar, 0);
  sm90::split_tile(khi, khi, klo, C::KV_BYTES / 16, tid, 128);
  sm90::split_tile(vhi, vhi, vlo, C::KV_BYTES / 16, tid, 128);
  for (int i = 0; i < n_q; ++i) {
    const int s = i % C::STAGES;
    const uint8_t* st = ring + s * C::STAGE_BYTES;
    sm90::mbar_wait(&full_bar[s], (i / C::STAGES) & 1);
    sm90::split_tile(st, qhi, qlo, C::QT_BYTES / 16, tid, 128);
    sm90::split_transposed<C::BQ>(st, qthi, qtlo, tid, 128);
    sm90::split_tile(st + C::QT_BYTES, dohi, dolo, C::QT_BYTES / 16, tid, 128);
    sm90::split_transposed<C::BQ>(st + C::QT_BYTES, dothi, dotlo, tid, 128);
    // this thread's query columns' statistics: 8 j + c2 + e -> [2 j + e]
    const float* stats = reinterpret_cast<const float*>(st + 2 * C::QT_BYTES);
    float lse2[8], dlt[8], gt[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c2 + e;
        lse2[2 * j + e] = stats[col];
        dlt[2 * j + e] = stats[C::BQ + col];
        gt[2 * j + e] = stats[2 * C::BQ + col];
      }
    sm90::mbar_arrive(&empty_bar[s]);
    sm90::fence_proxy_async();  // the split tiles, written by threads, read by wgmma
    sm90::named_barrier(1, 128);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 32 queries), three passes
    // each.  S^T's passes are the forward's (Q_lo K_hi, Q_hi K_lo, Q_hi K_hi)
    // in the same k8 steps, so each score is the one the forward's lse was
    // formed from: at large logits a score rounded otherwise moves P by its
    // error times |S|
    float sacc[16], dp[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sacc[j] = dp[j] = 0.f;
    sm90::fence_regs(sacc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint8_t* ka = term == 1 ? klo : khi;
      const uint8_t* qb = term == 0 ? qlo : qhi;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        sm90::wgmma_tf32_ss<C::BQ>(sacc, desc_k(ka + (ks >> 2) * BM * 128) + (ks & 3) * K_STEP,
                                   desc_k(qb + (ks >> 2) * C::BQ * 128) + (ks & 3) * K_STEP);
    }
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint8_t* va = term == 0 ? vlo : vhi;
      const uint8_t* ob = term == 1 ? dolo : dohi;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        sm90::wgmma_tf32_ss<C::BQ>(dp, desc_k(va + (ks >> 2) * BM * 128) + (ks & 3) * K_STEP,
                                   desc_k(ob + (ks >> 2) * C::BQ * 128) + (ks & 3) * K_STEP);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(sacc);
    sm90::fence_regs(dp);

    // P^T = exp(S^T + bias^T - lse), dS^T = P^T (dP^T - D)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1, idx = 2 * j + (e & 1);
        float pr = 0.f;
        if (valid[ii] && lse2[idx] != -CUDART_INF_F) {  // lse2 is -inf past T
          float x = sacc[4 * j + e] * scale2;
          if (bcol[ii] != nullptr) {
            const int t = i * C::BQ + 8 * j + c2 + (e & 1);
            x = fmaf(gt[idx] * bcol[ii][t * p.bias_sq], LOG2E, x);
          }
          pr = exp2f(x - lse2[idx]);
        }
        sacc[4 * j + e] = pr;
        dp[4 * j + e] = pr * (dp[4 * j + e] - dlt[idx]);
      }
    }

    // dV += P^T dO, dK += dS^T Q: A split in registers, dO^T and Q^T (hi,
    // lo) as the K-major B, one chunk of 32 queries (4 k8 steps)
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm90::acc_to_a_tf32(ph[ks], pl[ks], sacc, ks);
      sm90::acc_to_a_tf32(sh[ks], sl[ks], dp, ks);
    }
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs64(dv, pl[ks], desc_k(dothi) + ks * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs64(dv, ph[ks], desc_k(dotlo) + ks * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs64(dv, ph[ks], desc_k(dothi) + ks * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs64(dk, sl[ks], desc_k(qthi) + ks * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs64(dk, sh[ks], desc_k(qtlo) + ks * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs64(dk, sh[ks], desc_k(qthi) + ks * K_STEP);
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_regs(ph);
    sm90::fence_regs(pl);
    sm90::fence_regs(sh);
    sm90::fence_regs(sl);
    sm90::named_barrier(1, 128);  // the split query tiles are read
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int key = k0 + r0 + 8 * ii;
    if (key >= T) continue;
    const long long off = ((static_cast<long long>(b) * T + key) * p.H + h) * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(p.dk + off + 8 * j + c2) =
          make_float2(dk[4 * j + 2 * ii] * p.scale, dk[4 * j + 2 * ii + 1] * p.scale);
      *reinterpret_cast<float2*>(p.dv + off + 8 * j + c2) =
          make_float2(dv[4 * j + 2 * ii], dv[4 * j + 2 * ii + 1]);
    }
  }
}

// ------------------------------------------------ dQ, f32 (3xTF32 wgmma)
struct DqF32Params {
  CUtensorMap tq, tk, tv, tdo;
  const float* bias;    // null: no bias; else read through its strides
  const float* gate;    // null: the bias is used as it is
  const int* key_len;   // null: every key is valid
  const float* out;     // the forward's output, for D
  const float* dout;    // dO, for D (the products read it by TMA)
  const float* lse;     // (B, H, T), natural log
  float* delta;         // (B, H, T): D = rowsum(out * dO), which dK/dV reads
  float* dq;            // (B, T, H, 64) contiguous
  float* dbias;         // null: not written; else (B, H, T, ds_stride) contiguous
  float* dgate;         // null: not written; else (B, H, T) contiguous
  long long o_sb, o_st, o_sh;        // dO's element strides
  long long out_sb, out_st, out_sh;  // out's
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  long long gate_sb, gate_sh, gate_st;
  long long ds_stride;
  int T, H;
  float scale;
};

struct DqF32Tile {
  static constexpr int BN = 64;                   // keys per tile
  static constexpr int TILE_BYTES = BM * HD * 4;  // 64 rows of Q, dO, K or V, hi or lo: 16 KB
  static constexpr int STAGES = 2;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // raw K, then raw V
  static constexpr int SMEM = 1024 + 4 * TILE_BYTES + STAGES * STAGE_BYTES + 6 * TILE_BYTES;
};

__global__ void __launch_bounds__(160, 1)
    flash_bwd_dq_f32_sm90(const __grid_constant__ DqF32Params p) {
  using C = DqF32Tile;
  using sm90::desc_k;
  using sm90::K_STEP;
  using sm90::wgmma_tf32_rs64;
  using sm90::wgmma_tf32_ss;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::STAGES], empty_bar[C::STAGES], q_bar;
  uint8_t* const qhi = sm90::align1024(smem_raw);  // Q as loaded, then its hi part
  uint8_t* const qlo = qhi + C::TILE_BYTES;
  uint8_t* const dohi = qlo + C::TILE_BYTES;       // dO as loaded, then its hi part
  uint8_t* const dolo = dohi + C::TILE_BYTES;
  uint8_t* const ring = dolo + C::TILE_BYTES;
  uint8_t* const khi = ring + C::STAGES * C::STAGE_BYTES;
  uint8_t* const klo = khi + C::TILE_BYTES;
  uint8_t* const vhi = klo + C::TILE_BYTES;
  uint8_t* const vlo = vhi + C::TILE_BYTES;
  uint8_t* const kthi = vlo + C::TILE_BYTES;       // K^T: 64 rows of d x 64 keys
  uint8_t* const ktlo = kthi + C::TILE_BYTES;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int T = p.T;
  const int kv_len = p.key_len == nullptr ? T : min(max(p.key_len[b], 0), T);
  const int n_tiles = (kv_len + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_bar, 1);
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
      sm90::prefetch_map(&p.tk);
      sm90::prefetch_map(&p.tv);
      sm90::mbar_arrive_expect_tx(&q_bar, 2 * C::TILE_BYTES);
      for (int kc = 0; kc < 2; ++kc) {
        sm90::tma_load_4d(qhi + kc * BM * 128, &p.tq, &q_bar, 32 * kc, h, q0, b);
        sm90::tma_load_4d(dohi + kc * BM * 128, &p.tdo, &q_bar, 32 * kc, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        uint8_t* st = ring + s * C::STAGE_BYTES;
        sm90::mbar_wait(&empty_bar[s], ((i / C::STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full_bar[s], C::STAGE_BYTES);
        for (int kc = 0; kc < 2; ++kc) {
          sm90::tma_load_4d(st + kc * C::BN * 128, &p.tk, &full_bar[s], 32 * kc, h, i * C::BN, b);
          sm90::tma_load_4d(st + C::TILE_BYTES + kc * C::BN * 128, &p.tv, &full_bar[s], 32 * kc,
                            h, i * C::BN, b);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: query rows r0 and r0 + 8 of the tile; a
  // row's 64 keys of a tile are spread over the 4 lanes of its quad
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = warp * 16 + g;
  const long long srow = (static_cast<long long>(b) * p.H + h) * T;
  float lse2[2], dlt[2], gate[2] = {1.f, 1.f};
  const float* brow[2] = {nullptr, nullptr};  // this thread's rows of the bias
  float* dsrow[2] = {nullptr, nullptr};       // and of dS
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int t = q0 + r0 + 8 * ii;
    const bool in = t < T;
    lse2[ii] = in ? p.lse[srow + t] * LOG2E : -CUDART_INF_F;  // past T: P = 0
    // D = rowsum(out * dO), 16 columns per lane of the quad
    float d = 0.f;
    if (in) {
      const float* o = p.out + b * p.out_sb + h * p.out_sh + t * p.out_st + 16 * (lane & 3);
      const float* od = p.dout + b * p.o_sb + h * p.o_sh + t * p.o_st + 16 * (lane & 3);
#pragma unroll
      for (int c = 0; c < 16; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(o + c);
        const float4 y = *reinterpret_cast<const float4*>(od + c);
        d = fmaf(x.x, y.x, d);
        d = fmaf(x.y, y.y, d);
        d = fmaf(x.z, y.z, d);
        d = fmaf(x.w, y.w, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    dlt[ii] = d;
    if (in && (lane & 3) == 0) p.delta[srow + t] = d;
    if (p.bias != nullptr) {
      const int tt = min(t, T - 1);
      brow[ii] = p.bias + b * p.bias_sb + h * p.bias_sh + tt * p.bias_sq;
      if (p.gate != nullptr) gate[ii] = p.gate[b * p.gate_sb + h * p.gate_sh + tt * p.gate_st];
    }
    if (p.dbias != nullptr && in) dsrow[ii] = p.dbias + (srow + t) * p.ds_stride;
  }
  const float scale2 = p.scale * LOG2E;  // scores in the log2 domain, as the forward's
  float dq[32], dgate[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) dq[j] = 0.f;

  sm90::mbar_wait(&q_bar, 0);
  sm90::split_tile(qhi, qhi, qlo, C::TILE_BYTES / 16, tid, 128);
  sm90::split_tile(dohi, dohi, dolo, C::TILE_BYTES / 16, tid, 128);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::STAGES;
    const uint8_t* st = ring + s * C::STAGE_BYTES;
    sm90::mbar_wait(&full_bar[s], (i / C::STAGES) & 1);
    sm90::split_tile(st, khi, klo, C::TILE_BYTES / 16, tid, 128);
    sm90::split_transposed<C::BN>(st, kthi, ktlo, tid, 128);
    sm90::split_tile(st + C::TILE_BYTES, vhi, vlo, C::TILE_BYTES / 16, tid, 128);
    sm90::mbar_arrive(&empty_bar[s]);
    sm90::fence_proxy_async();  // the split tiles, written by threads, read by wgmma
    sm90::named_barrier(1, 128);

    // S = Q K^T in the forward's passes (Q_lo K_hi, Q_hi K_lo, Q_hi K_hi)
    // and k8 steps on the same 64-key tiles, so each score is the one the
    // forward's lse was formed from; dP = dO V^T, three passes as well
    float sacc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sacc[j] = dp[j] = 0.f;
    sm90::fence_regs(sacc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint8_t* a = term == 0 ? qlo : qhi;
      const uint8_t* kb = term == 1 ? klo : khi;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_tf32_ss<64>(sacc, desc_k(a + (ks >> 2) * BM * 128) + (ks & 3) * K_STEP,
                          desc_k(kb + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
    }
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint8_t* a = term == 0 ? dolo : dohi;
      const uint8_t* vb = term == 1 ? vlo : vhi;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_tf32_ss<64>(dp, desc_k(a + (ks >> 2) * BM * 128) + (ks & 3) * K_STEP,
                          desc_k(vb + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(sacc);
    sm90::fence_regs(dp);

    // P = exp(S + bias - lse) as the forward forms it, dS = P (dP - D) into
    // dp; the gate's gradient sums dS * bias
    const int k0 = i * C::BN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1;
        const int key = k0 + 8 * j + c2 + (e & 1);
        float ds = 0.f;
        if (key < kv_len && lse2[ii] != -CUDART_INF_F) {
          float x = sacc[4 * j + e] * scale2;
          if (brow[ii] != nullptr) {
            const float tab = brow[ii][key * p.bias_sk];
            x = fmaf(gate[ii] * tab, LOG2E, x);
            ds = exp2f(x - lse2[ii]) * (dp[4 * j + e] - dlt[ii]);
            dgate[ii] = fmaf(ds, tab, dgate[ii]);
          } else {
            ds = exp2f(x - lse2[ii]) * (dp[4 * j + e] - dlt[ii]);
          }
        }
        dp[4 * j + e] = ds;
      }
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      if (dsrow[ii] == nullptr) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * j + c2;  // even, and T8 is a multiple of 8
        if (key < T)
          *reinterpret_cast<float2*>(dsrow[ii] + key) =
              make_float2(dp[4 * j + 2 * ii], dp[4 * j + 2 * ii + 1]);
      }
    }

    // dQ += dS K: dS split in registers, K^T (hi, lo) as the K-major B
    uint32_t sh[8][4], sl[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) sm90::acc_to_a_tf32(sh[ks], sl[ks], dp, ks);
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_tf32_rs64(dq, sl[ks], desc_k(kthi + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_tf32_rs64(dq, sh[ks], desc_k(ktlo + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_tf32_rs64(dq, sh[ks], desc_k(kthi + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_regs(dq);
    sm90::fence_regs(sh);
    sm90::fence_regs(sl);
    sm90::named_barrier(1, 128);  // the split tiles are read
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {  // a row's sum over the 4 lanes of its quad
    dgate[ii] += __shfl_xor_sync(0xffffffffu, dgate[ii], 1);
    dgate[ii] += __shfl_xor_sync(0xffffffffu, dgate[ii], 2);
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int t = q0 + r0 + 8 * ii;
    if (t >= T) continue;
    if (dsrow[ii] != nullptr)  // keys past the last tile read (past key_len): dS = 0
      for (int key = n_tiles * C::BN + (lane & 3); key < T; key += 4) dsrow[ii][key] = 0.f;
    if (p.dgate != nullptr && (lane & 3) == 0) p.dgate[srow + t] = dgate[ii];
    float* dqr = p.dq + ((static_cast<long long>(b) * T + t) * p.H + h) * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dqr + 8 * j + c2) =
          make_float2(dq[4 * j + 2 * ii] * p.scale, dq[4 * j + 2 * ii + 1] * p.scale);
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

int launch_dkv_f32(DkvF32Params& p, const void* q, const void* k, const void* v,
                   const void* dout, int B, int T, int H, const long long* s,
                   cudaStream_t stream) {
  using C = DkvF32Tile;
  int rc = sm90_host::encode_rows_f32(&p.tq, q, B, T, H, s + 0, C::BQ);
  if (rc == 0) rc = sm90_host::encode_rows_f32(&p.tk, k, B, T, H, s + 3, BM);
  if (rc == 0) rc = sm90_host::encode_rows_f32(&p.tv, v, B, T, H, s + 6, BM);
  if (rc == 0) rc = sm90_host::encode_rows_f32(&p.tdo, dout, B, T, H, s + 9, C::BQ);
  if (rc != 0) return rc;
  static bool smem_set[sm90_host::MAX_DEVICES] = {};  // per device
  const int dev = sm90_host::current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_f32_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_bwd_dkv_f32_sm90<<<grid, 160, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_f32(DqF32Params& p, const void* q, const void* k, const void* v,
                  const void* dout, int B, int T, int H, const long long* s,
                  cudaStream_t stream) {
  using C = DqF32Tile;
  int rc = sm90_host::encode_rows_f32(&p.tq, q, B, T, H, s + 0, BM);
  if (rc == 0) rc = sm90_host::encode_rows_f32(&p.tk, k, B, T, H, s + 3, C::BN);
  if (rc == 0) rc = sm90_host::encode_rows_f32(&p.tv, v, B, T, H, s + 6, C::BN);
  if (rc == 0) rc = sm90_host::encode_rows_f32(&p.tdo, dout, B, T, H, s + 9, BM);
  if (rc != 0) return rc;
  static bool smem_set[sm90_host::MAX_DEVICES] = {};  // per device
  const int dev = sm90_host::current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_f32_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_bwd_dq_f32_sm90<<<grid, 160, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v, bias, gate, dout and the
// gradients alike).  q, k, v, dout (B, T, H, 64) with a contiguous head dim;
// `strides` (host memory) holds the element strides q_sb, q_st, q_sh, k_*,
// v_*, dout_*, then the bias's (b, h, query, key) strides (0 broadcasts),
// then the gate's (b, h, query).  With a gate the effective bias is
// round(gate * bias).  lse and delta are contiguous (B, H, T) float32; dk, dv
// contiguous (B, T, H, 64).  bias, gate and key_len may be null.  q, k, v
// and dout need what TMA takes (csrc/flash_attention.cu:flash_attention_fwd);
// the float32 kernel reads the bias and gate through any strides.  `tile` is
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
  DkvF32Params p;
  p.bias = static_cast<const float*>(bias);
  p.gate = static_cast<const float*>(bias != nullptr ? gate : nullptr);
  p.key_len = key_len;
  p.lse = lse;
  p.delta = delta;
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.bias_sb = strides[12];
  p.bias_sh = strides[13];
  p.bias_sq = strides[14];
  p.bias_sk = strides[15];
  p.gate_sb = strides[16];
  p.gate_sh = strides[17];
  p.gate_st = strides[18];
  p.T = T;
  p.H = H;
  p.scale = scale;
  return launch_dkv_f32(p, q, k, v, dout, B, T, H, strides, s);
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
  DqF32Params p;
  p.bias = static_cast<const float*>(bias);
  p.gate = static_cast<const float*>(bias != nullptr ? gate : nullptr);
  p.key_len = key_len;
  p.out = static_cast<const float*>(out);
  p.dout = static_cast<const float*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<float*>(dq);
  p.dbias = static_cast<float*>(dbias);
  p.dgate = p.gate != nullptr ? static_cast<float*>(dgate) : nullptr;
  p.o_sb = strides[9];
  p.o_st = strides[10];
  p.o_sh = strides[11];
  p.out_sb = strides[19];
  p.out_st = strides[20];
  p.out_sh = strides[21];
  p.bias_sb = strides[12];
  p.bias_sh = strides[13];
  p.bias_sq = strides[14];
  p.bias_sk = strides[15];
  p.gate_sb = strides[16];
  p.gate_sh = strides[17];
  p.gate_st = strides[18];
  p.ds_stride = ds_stride;
  p.T = T;
  p.H = H;
  p.scale = scale;
  return launch_dq_f32(p, q, k, v, dout, B, T, H, strides, s);
}

const char* flash_attention_bwd_error_string(int code) {
  if (code == sm90_host::ERR_NO_ENCODER)
    return "the driver has no cuTensorMapEncodeTiled (TMA needs a Hopper driver)";
  if (code == sm90_host::ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
