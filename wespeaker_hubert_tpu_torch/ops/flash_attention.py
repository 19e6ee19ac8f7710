"""Flash attention: wrappers of the CUDA kernels (csrc/flash_attention.cu,
the forward, and csrc/flash_attention_bwd.cu, the backward) and their plain
PyTorch versions, joined by a `torch.autograd.Function`.

Counterpart of `wespeaker_hubert_tpu/frontend/ssl_encoder.py:_flash_mha`,
which runs the upstream Pallas TPU kernel
`jax.experimental.pallas.ops.tpu.flash_attention` and, under autodiff, its
custom VJP (`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`).  Per
(batch, head):

    out = softmax(q k^T * scale + bias, keys >= key_len masked) v

q, k, v: (B, T, h, hd) as the projections give them (the JAX layout);
bias: optional and finite, anything that broadcasts to (B, h, T, T), such
as a -1e9 padding bias (B, 1, 1, T);
bias_gate: optional (B, h, T) or (B, h, T, 1), WavLM's gate: the effective
bias is then round_to_bias_dtype(bias_gate[..., None] * bias), which the
kernels form per (query, key) pair from the (h, T, T) position-bias table
(`bias`), so the (B, h, T, T) gated bias is never materialized (the product
of two bf16 values is exact in float32, so this is bit for bit the bias
`gate_output * position_bias[None]` computes);
key_len: optional (B,) valid key counts.  Masking keys past key_len gives
the softmax of the JAX path's -1e9 additive padding bias.  Query rows past
key_len are computed like any other, as in JAX.  A row with no valid key
gives 0, and gradients of 0.

`flash_attention` takes a CPU tensor to the plain versions and a CUDA
tensor to the kernels, which it launches or raises on.  When a gradient is
needed it goes through `FlashAttention` (an autograd Function): the forward
also writes each row's log-sum-exp, and the backward launches the dQ kernel
and then the dK/dV kernel.  The dQ kernel writes D = rowsum(out * dout) for
dK/dV, dS, the effective bias's gradient, in the bias's dtype (as JAX
returns `ds` in `ab`'s dtype) into rows padded to a multiple of 8 (the
wrappers hand on the [..., :T] view), and with a gate the gate's gradient
(the sum of dS * table over each row's keys).  The Function sums dS to the
bias's (broadcast) shape or, with a gate, to the table's gradient
(`factored_bias_grads`).  `LAUNCHES`, `LAUNCHES_BWD_DKV` and
`LAUNCHES_BWD_DQ` count kernel launches.  The kernels take head dim 64,
float32 or bf16, a bias and gate of the inputs' dtype, and a contiguous
head dim.  The bf16 kernels read through TMA: q, k and v need 16-byte
aligned bases and strides of multiples of 16 bytes (else the wrapper
raises; dout and out that break the rule are copied), and a bias TMA cannot
read as it is (a row stride that is not a multiple of 16 bytes, a broadcast
query or key axis) is copied once into a padded layout, counted by
`BIAS_RELAYOUTS` (`frontend/ssl_encoder.py` builds WavLM's table padded, so
its path makes none).  Scores and the softmax are float32 in every version;
outputs have the inputs' dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "BIAS_RELAYOUTS",
    "BwdGrads",
    "LAUNCHES",
    "LAUNCHES_BWD_DKV",
    "LAUNCHES_BWD_DQ",
    "HEAD_DIM",
    "FlashAttention",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_reference",
    "effective_bias",
    "factored_bias_grads",
    "kernel_strides",
    "key_tile",
]

LAUNCHES = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_DQ = 0
BIAS_RELAYOUTS = 0
HEAD_DIM = 64

_SOURCES = ["flash_attention.cu"]
_BWD_SOURCES = ["flash_attention_bwd.cu"]
_N_STRIDES = 19  # q, k, v, out or dout (3 each), bias (4), gate (3)
_N_BWD_STRIDES = 22  # q, k, v, dout (3 each), bias (4), gate (3), out (3)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def key_tile(t: int) -> int:
    """The tile width the bf16 forward takes over keys and the bf16 dK/dV
    over queries for T frames (the kernels' `tile` argument; they take 64
    or 80): one tile of 80 when it holds every frame, else 64."""
    return 80 if t <= 80 else 64


def _gate4(bias_gate: torch.Tensor) -> torch.Tensor:
    return bias_gate if bias_gate.dim() == 4 else bias_gate[..., None]


def effective_bias(bias: Optional[torch.Tensor], bias_gate: Optional[torch.Tensor]):
    """The additive bias the kernels see: `bias`, or with a gate
    round_to_bias_dtype(bias_gate[..., None] * bias), the product taken in
    float32 (exact for two bf16 values)."""
    if bias_gate is None or bias is None:
        return bias
    return (_gate4(bias_gate).float() * bias.float()).to(bias.dtype)


def factored_bias_grads(ds, bias, bias_gate):
    """The gradient of `bias` (the table) from dS, the effective bias's
    gradient (B, h, T, T), by the expression autograd uses for
    `gate * table`: (dS * gate) summed to the table's shape.  It sums over
    the batch, across the dQ kernel's blocks; the gate's gradient, a sum over
    one row's keys, comes from the kernel (`BwdGrads.dgate`)."""
    return (ds * _gate4(bias_gate)).sum_to_size(bias.shape)


class BwdGrads(NamedTuple):
    """The backward's outputs, from the kernels or the plain version: dq,
    dk, dv in the inputs' dtype; dbias dS (B, h, T, T) in the bias's dtype,
    or None (no bias, or not asked for); dgate the gate's gradient (B, h, T)
    in its dtype, sum over keys of dS * bias, or None without a gate; delta
    D = rowsum(out * dout) (B, h, T) float32."""

    dq: torch.Tensor
    dk: torch.Tensor
    dv: torch.Tensor
    dbias: Optional[torch.Tensor]
    dgate: Optional[torch.Tensor]
    delta: torch.Tensor


def _reference_scores(q, k, bias, key_len, scale):
    """float32 scores (B, h, T, T) with the bias added and masked keys at
    -inf."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if key_len is not None:
        valid = torch.arange(k.shape[1], device=q.device)[None, :] < key_len.to(q.device)[:, None]
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    return s


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
    bias_gate: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the forward kernel: float32 scores, the
    (effective) bias, key mask, float32 softmax; the probabilities in the
    inputs' dtype times v.  With `return_lse`, also each row's float32
    log-sum-exp (B, h, T) (-inf for a row with no valid key), as the kernel
    writes it for the backward."""
    s = _reference_scores(q, k, effective_bias(bias, bias_gate), key_len, _scale(q, scale))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # no valid key: 0
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    key_len: Optional[torch.Tensor],
    scale: Optional[float],
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    bias_gate: Optional[torch.Tensor] = None,
) -> BwdGrads:
    """Plain PyTorch version of the backward kernels, their algebra step by
    step in float32 (Bias the effective bias, gated when `bias_gate` is
    given):

        P  = exp(S - lse)  (0 at masked keys and in rows with lse = -inf)
        D  = rowsum(out * dout)
        dV = P^T dout,  dS = P * (dout v^T - D)
        dQ = scale * dS k,  dK = scale * dS^T q,  dBias = dS
        dGate = sum over keys of round(dS) * bias  (dS in the bias's dtype)

    Returns `BwdGrads` in the inputs' dtypes; dbias is dS (B, h, T, T) in
    the bias's dtype, or None without a bias."""
    scale = _scale(q, scale)
    s = _reference_scores(q, k, effective_bias(bias, bias_gate), key_len, scale)
    lse = lse.float()[..., None]
    p = torch.where(torch.isinf(lse), torch.zeros_like(s), torch.exp(s - lse))
    do = dout.float()
    delta = (out.float() * do).sum(-1).transpose(1, 2)[..., None]  # (B, h, T, 1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dbias = ds.to(bias.dtype) if bias is not None else None
    dgate = None
    if bias_gate is not None and bias is not None:
        dgate = (dbias.float() * bias.float()).sum(-1).to(bias_gate.dtype)  # (B, h, T)
    return BwdGrads(dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, dgate,
                    delta[..., 0])


def kernel_strides(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_len: Optional[torch.Tensor] = None,
    bias_gate: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Tuple[int, ...]]:
    """The kernels' checks: raises on what they do not take.  q, k and v
    need 16-byte aligned bases and strides of multiples of 16 bytes (TMA's
    rule, and the float32 kernel's vector loads).  Returns the bias expanded
    to (B, h, T, T) (a view, broadcast strides 0) and the element strides
    of q, k, v over (B, T, h) and of the bias over (B, h, query, key)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, h, hd), got {tuple(q.shape)}")
    b, t, h, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"the flash-attention kernel takes head dim {HEAD_DIM}, got {hd}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must have one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash-attention kernel takes float32 or bf16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        _check_rows(name, x)
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {h} exceed the kernel's grid (65535)")
    if bias is not None:
        if bias.dtype != q.dtype:
            raise TypeError(f"bias is {bias.dtype}, q is {q.dtype}")
        if bias.device != q.device:
            raise ValueError(f"bias is on {bias.device}, q on {q.device}")
        bias = bias.expand(b, h, t, t)
    if bias_gate is not None:
        if bias is None:
            raise ValueError("bias_gate gates a bias: pass the table as `bias`")
        if tuple(_gate4(bias_gate).shape) != (b, h, t, 1):
            raise ValueError(f"bias_gate must be ({b}, {h}, {t}) or ({b}, {h}, {t}, 1), "
                             f"got {tuple(bias_gate.shape)}")
        if bias_gate.dtype != q.dtype or bias_gate.device != q.device:
            raise TypeError(f"bias_gate is {bias_gate.dtype} on {bias_gate.device}, "
                            f"q {q.dtype} on {q.device}")
    if key_len is not None:
        if key_len.shape != (b,):
            raise ValueError(f"key_len must be ({b},), got {tuple(key_len.shape)}")
        if key_len.device != q.device:
            raise ValueError(f"key_len is on {key_len.device}, q on {q.device}")
        if key_len.dtype.is_floating_point or key_len.dtype == torch.bool:
            raise TypeError(f"key_len must be an integer tensor, got {key_len.dtype}")
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    strides += bias.stride() if bias is not None else (0, 0, 0, 0)
    return bias, strides


def _check_rows(name: str, x: torch.Tensor) -> None:
    """TMA's rule for a (B, T, h, 64) operand: a unit head-dim stride, a
    16-byte aligned base, strides of multiples of 16 bytes."""
    vec = 16 // x.element_size()
    if x.stride(3) != 1:
        raise ValueError(f"{name} needs a contiguous head dim (stride {x.stride(3)})")
    if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned in every row (strides {x.stride()})")


def _tma_rows(x: torch.Tensor) -> torch.Tensor:
    """A (B, T, h, 64) tensor as TMA reads it: itself, or a fresh contiguous
    copy when its head dim, base or strides break `_check_rows`' rule."""
    vec = 16 // x.element_size()
    if x.stride(3) != 1 or x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _tma_bias(bias: torch.Tensor) -> torch.Tensor:
    """A (B, h, T, T) bias view TMA reads as it is (unit key stride, other
    strides multiples of 16 bytes or 0 on the batch and head axes, a 16-byte
    aligned base), or a padded copy of it: the bf16 kernels' bias."""
    global BIAS_RELAYOUTS
    vec = 16 // bias.element_size()
    sb, sh, sq, sk = bias.stride()
    if (sk == 1 and sq > 0 and sq % vec == 0 and sh % vec == 0 and sb % vec == 0
            and bias.data_ptr() % 16 == 0):
        return bias
    b, h, t, _ = bias.shape
    rows = bias[: 1 if sb == 0 else b, : 1 if sh == 0 else h]
    padded = torch.empty((*rows.shape[:3], -(-t // vec) * vec), dtype=bias.dtype,
                         device=bias.device)[..., :t]
    padded.copy_(rows)
    BIAS_RELAYOUTS += 1
    return padded.expand(b, h, t, t)


def _operands(q, k, v, bias, key_len, bias_gate):
    """`kernel_strides`, then the bias as the kernels read it (`_tma_bias`
    for bf16) and the gate as a (B, h, T) view: (bias, gate, the strides of
    q, k, v, the strides of the bias and the gate)."""
    bias, strides = kernel_strides(q, k, v, bias, key_len, bias_gate)
    if bias is not None and q.dtype == torch.bfloat16:
        bias = _tma_bias(bias)
    b, t, h, _ = q.shape
    gate = None if bias_gate is None else _gate4(bias_gate)[..., 0].expand(b, h, t)
    bias_strides = bias.stride() if bias is not None else (0, 0, 0, 0)
    gate_strides = gate.stride() if gate is not None else (0, 0, 0)
    return bias, gate, strides[:9], (*bias_strides, *gate_strides)


_LIB = None
_BWD_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from ..utils.cuda_build import load_library

        lib = load_library("flash_attention", _SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, ptr,
        ]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bwd_library():
    global _BWD_LIB
    if _BWD_LIB is None:
        from ..utils.cuda_build import load_library

        lib = load_library("flash_attention_bwd", _BWD_SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        # dtype, q, k, v, bias, gate, key_len, dout, lse, delta, dk, dv, B, T, H,
        # strides, scale, tile, stream
        lib.flash_attention_bwd_dkv.argtypes = [
            i32, *[ptr] * 11, i32, i32, i32, strides, ctypes.c_float, i32, ptr]
        # dtype, q, k, v, bias, gate, key_len, dout, out, lse, delta, dq, dbias,
        # dgate, B, T, H, strides, ds_stride, scale, tile, stream
        lib.flash_attention_bwd_dq.argtypes = [
            i32, *[ptr] * 13, i32, i32, i32, strides, ctypes.c_longlong, ctypes.c_float,
            i32, ptr]
        lib.flash_attention_bwd_dkv.restype = lib.flash_attention_bwd_dq.restype = i32
        lib.flash_attention_bwd_error_string.argtypes = [i32]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


def _raise_on(rc: int, what: str, error_string) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error_string(rc).decode()}")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
    bias_gate: Optional[torch.Tensor] = None,
):
    """The forward kernel on CUDA tensors: (B, T, h, hd) attention output
    and, with `return_lse`, each row's float32 log-sum-exp (B, h, T)."""
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError("flash_attention_fwd launches the CUDA kernel: q is on the CPU")
    bias, gate, qkv_strides, bias_strides = _operands(q, k, v, bias, key_len, bias_gate)
    b, t, h, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if return_lse else None
    if key_len is not None:
        key_len = key_len.to(torch.int32).contiguous()
    all_strides = (*qkv_strides, *out.stride()[:3], *bias_strides)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(gate),
            _ptr(key_len), out.data_ptr(), _ptr(lse), b, t, h,
            (ctypes.c_longlong * _N_STRIDES)(*all_strides), _scale(q, scale), key_tile(t),
            stream,
        )
    _raise_on(rc, "flash-attention", lib.flash_attention_error_string)
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    key_len: Optional[torch.Tensor],
    scale: Optional[float],
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    bias_grad: bool = True,
    bias_gate: Optional[torch.Tensor] = None,
) -> BwdGrads:
    """The backward kernels on CUDA tensors, dQ first, then dK/dV on the
    same stream: `BwdGrads` with dq/dk/dv contiguous (B, T, h, hd); dbias
    dS, the effective bias's gradient, in the bias's dtype, a (B, h, T, T)
    view of rows padded to a multiple of 8, or None without a bias or when
    `bias_grad` is False; dgate (B, h, T) with a gate; delta, D =
    rowsum(out * dout) in float32, which the dQ kernel computes for dK/dV
    (JAX computes it outside its kernels)."""
    global LAUNCHES_BWD_DKV, LAUNCHES_BWD_DQ
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd launches the CUDA kernels: q is on the CPU")
    bias, gate, qkv_strides, bias_strides = _operands(q, k, v, bias, key_len, bias_gate)
    b, t, h, hd = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(
            f"dout must match q: {tuple(dout.shape)} {dout.dtype} {dout.device} against "
            f"{tuple(q.shape)} {q.dtype} {q.device}"
        )
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(
            f"out must match q: {tuple(out.shape)} {out.dtype} {out.device} against "
            f"{tuple(q.shape)} {q.dtype} {q.device}"
        )
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be ({b}, {h}, {t}) float32 on {q.device}")
    # the incoming gradient and the forward's output, laid out as TMA reads them
    dout, out = _tma_rows(dout), _tma_rows(out)
    lse = lse.contiguous()
    if key_len is not None:
        key_len = key_len.to(torch.int32).contiguous()
    dq = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dgate = None if gate is None else torch.empty((b, h, t), dtype=gate.dtype, device=q.device)
    ds_stride = t + (-t % 8)  # 16-byte rows: dS leaves by TMA stores
    ds = None
    if bias is not None and bias_grad:
        ds = torch.empty((b, h, t, ds_stride), dtype=bias.dtype, device=q.device)
    all_strides = (ctypes.c_longlong * _N_BWD_STRIDES)(
        *qkv_strides, *dout.stride()[:3], *bias_strides, *out.stride()[:3])
    dt, sc, tile = _DTYPES[q.dtype], _scale(q, scale), key_tile(t)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(gate),
                  _ptr(key_len), dout.data_ptr())
        rc = lib.flash_attention_bwd_dq(dt, *inputs, out.data_ptr(), lse.data_ptr(),
                                        delta.data_ptr(), dq.data_ptr(), _ptr(ds), _ptr(dgate),
                                        b, t, h, all_strides, ds_stride, sc, tile, stream)
        _raise_on(rc, "flash-attention dQ", lib.flash_attention_bwd_error_string)
        LAUNCHES_BWD_DQ += 1
        rc = lib.flash_attention_bwd_dkv(dt, *inputs, lse.data_ptr(), delta.data_ptr(),
                                         dk.data_ptr(), dv.data_ptr(), b, t, h, all_strides, sc,
                                         tile, stream)
        _raise_on(rc, "flash-attention dK/dV", lib.flash_attention_bwd_error_string)
        LAUNCHES_BWD_DKV += 1
    return BwdGrads(dq, dk, dv, None if ds is None else ds[..., :t], dgate, delta)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the kernels on CUDA tensors, the
    plain versions on CPU tensors.  The backward never falls back to the
    plain path or to autograd through the plain forward.  Gradients: q, k,
    v, and the bias summed to its shape or, with a gate, the table's and
    the gate's (`factored_bias_grads`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_len, scale, bias_gate=None):
        if q.is_cuda:
            out, lse = flash_attention_fwd(q, k, v, bias, key_len, scale, return_lse=True,
                                           bias_gate=bias_gate)
        else:
            out, lse = flash_attention_reference(q, k, v, bias, key_len, scale, return_lse=True,
                                                 bias_gate=bias_gate)
        ctx.save_for_backward(q, k, v, bias, key_len, out, lse, bias_gate)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, key_len, out, lse, bias_gate = ctx.saved_tensors
        need_bias = bias is not None and ctx.needs_input_grad[3]
        need_gate = bias_gate is not None and ctx.needs_input_grad[6]
        if q.is_cuda:
            g = flash_attention_bwd(q, k, v, bias, key_len, ctx.scale, out, lse, dout,
                                    bias_grad=need_bias, bias_gate=bias_gate)
        else:
            g = flash_attention_bwd_reference(q, k, v, bias, key_len, ctx.scale, out, lse, dout,
                                              bias_gate=bias_gate)
        dbias = dgate = None
        if need_bias:  # the table's gradient, or a broadcast bias's
            dbias = (factored_bias_grads(g.dbias, bias, bias_gate) if bias_gate is not None
                     else g.dbias.sum_to_size(bias.shape))
        if need_gate:
            dgate = g.dgate.reshape(bias_gate.shape)
        return g.dq, g.dk, g.dv, dbias, None, None, dgate


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    bias_gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T, h, hd) q, k, v -> (B, T, h, hd) attention output.  CPU
    tensors run the plain versions; CUDA tensors launch the kernels.  When
    autograd needs a gradient of q, k, v, the bias or the gate, the call
    goes through `FlashAttention`."""
    needs_grad = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (q, k, v, bias, bias_gate)
    )
    if needs_grad:
        return FlashAttention.apply(q, k, v, bias, key_len, scale, bias_gate)
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, bias, key_len, scale, bias_gate=bias_gate)
    return flash_attention_fwd(q, k, v, bias, key_len, scale, bias_gate=bias_gate)
