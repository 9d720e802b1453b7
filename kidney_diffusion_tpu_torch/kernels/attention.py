"""Fused attention over (B, N, H, D): CUDA kernel, plain version, wrapper.

Port of `kidney_diffusion_tpu/kernels/attention.py`. The function is the
JAX reference `xla_attention`: softmax((q * D^-1/2) k^T) v with fp32 scores
and the softmax weights cast to v's dtype before the product with v. Keys
may outnumber queries (context tokens appended to self-attention) and
cross-attention has as few as 2 keys.

`attention` runs the plain version for tensors on the CPU and the CUDA
kernel (`csrc/attention.cu`) for tensors on the card — every call on the
card, whatever its shape (the v5e dispatch gate of the JAX module is a TPU
measurement and is not carried over).

Gradients: JAX has no VJP of its own for attention and differentiates
`xla_attention`; so while autograd records, `attention` runs the same
forward inside `AttentionFunction`, whose backward is autograd through
`attention_plain`, recomputed from the saved q, k, v (TF32 off on the card).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .conv3x3 import full_fp32

Tensor = torch.Tensor

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

HEAD_DIMS = (32, 64)  # head widths the CUDA kernel is compiled for

_P = ctypes.c_void_p
_I = ctypes.c_int


def attention_plain(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Plain PyTorch version of `xla_attention`, (B, N, H, D) in and out."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", (q * scale).float(), k.float())
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", weights, v)


def _lib():
    lib = _build.library("attention")
    fn = lib.kdt_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
        fn.restype = _I
    return lib


def attention_cuda(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Launch the CUDA kernel on bf16 (B, N, H, D) tensors; raises on
    anything else."""
    global LAUNCHES
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"attention wants (B, N, H, D) q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if nq < 1 or nk < 1:
        raise ValueError(f"attention needs at least one query and one key, got {nq}, {nk}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA attention takes head widths {HEAD_DIMS}, got {d}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("the CUDA attention takes bf16 q, k and v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel's grid")
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    o = torch.empty_like(q)
    lib = _lib()
    rc = lib.kdt_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, nq, nk, h, d, float(d**-0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "attention")
    LAUNCHES += 1
    return o


class AttentionFunction(torch.autograd.Function):
    """`attention` under autograd: `launch` (`attention_cuda` on the card,
    `attention_plain` on the CPU) forward; autograd of `attention_plain`,
    recomputed from the saved inputs, backward."""

    @staticmethod
    def forward(ctx, launch, q, k, v):
        ctx.save_for_backward(q, k, v)
        return launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad(), full_fp32(g.device):
            leaves = [t.detach().requires_grad_() for t in saved]
            grads = torch.autograd.grad(attention_plain(*leaves), leaves, g)
        return (None, *grads)


def attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, N, H, D) tensors (keys may be
    longer than queries). CPU tensors run the plain version; CUDA tensors
    run the kernel or raise. While autograd records an input that needs a
    gradient, the same forward runs inside `AttentionFunction`."""
    if q.device.type == "cpu":
        launch = attention_plain
    elif q.device.type == "cuda":
        launch = attention_cuda
    else:
        raise ValueError(f"attention runs on the CPU or a CUDA device, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return AttentionFunction.apply(launch, q, k, v)
    return launch(q, k, v)
