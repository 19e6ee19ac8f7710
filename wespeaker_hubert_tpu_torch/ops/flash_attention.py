"""Flash-attention forward: wrapper of the CUDA kernel
(csrc/flash_attention.cu) and its plain PyTorch version.

Counterpart of `wespeaker_hubert_tpu/frontend/ssl_encoder.py:_flash_mha`,
which runs the upstream Pallas TPU kernel
`jax.experimental.pallas.ops.tpu.flash_attention`.  Per (batch, head):

    out = softmax(q k^T * scale + bias, keys >= key_len masked) v

q, k, v: (B, T, h, hd) as the projections give them (the JAX layout);
bias: optional and finite, anything that broadcasts to (B, h, T, T), such
as WavLM's gated position bias (B, h, T, T) or a -1e9 padding bias
(B, 1, 1, T);
key_len: optional (B,) valid key counts.  Masking keys past key_len gives
the softmax of the JAX path's -1e9 additive padding bias.  Query rows past
key_len are computed like any other, as in JAX.  A row with no valid key
gives 0.

`flash_attention` takes a CPU tensor to the plain version and a CUDA tensor
to the kernel, which it launches or raises on; `LAUNCHES` counts kernel
launches.  The kernel takes head dim 64, float32 or bf16, a bias of the
inputs' dtype, and a contiguous head dim.  Scores and the softmax are
float32 in both versions; the output has the inputs' dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = [
    "LAUNCHES",
    "HEAD_DIM",
    "flash_attention",
    "flash_attention_reference",
    "kernel_strides",
]

LAUNCHES = 0
HEAD_DIM = 64

_SOURCES = ["flash_attention.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: float32 scores, bias, key mask,
    float32 softmax; the probabilities in the inputs' dtype times v."""
    b, t, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if key_len is not None:
        valid = torch.arange(k.shape[1], device=q.device)[None, :] < key_len.to(q.device)[:, None]
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num_(0.0)  # no valid key: 0
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def kernel_strides(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_len: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Tuple[int, ...]]:
    """The kernel's checks: raises on what it does not take.  Returns the
    bias expanded to (B, h, T, T) (a view, broadcast strides 0) and the
    element strides of q, k, v over (B, T, h) and of the bias over
    (B, h, query, key)."""
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
    # 16-byte vector loads: 8 bf16 or 4 float32 elements
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dim (stride {x.stride(3)})")
        if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned in every row (strides {x.stride()})")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {h} exceed the kernel's grid (65535)")
    if bias is not None:
        if bias.dtype != q.dtype:
            raise TypeError(f"bias is {bias.dtype}, q is {q.dtype}")
        if bias.device != q.device:
            raise ValueError(f"bias is on {bias.device}, q on {q.device}")
        bias = bias.expand(b, h, t, t)
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


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from ..utils.cuda_build import load_library

        lib = load_library("flash_attention", _SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ptr,
        ]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, T, h, hd) q, k, v -> (B, T, h, hd) attention output.  CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, bias, key_len, scale)
    bias, strides = kernel_strides(q, k, v, bias, key_len)
    b, t, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if key_len is not None:
        key_len = key_len.to(torch.int32).contiguous()
    all_strides = (*strides[:9], *out.stride()[:3], *strides[9:])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            key_len.data_ptr() if key_len is not None else None,
            out.data_ptr(), b, t, h,
            (ctypes.c_longlong * 16)(*all_strides), scale, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash-attention kernel launch failed: "
            f"{lib.flash_attention_error_string(rc).decode()}"
        )
    LAUNCHES += 1
    return out
