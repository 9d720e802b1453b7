"""Building blocks of the efficient U-Net (NHWC), exact path.

Port of `kidney_diffusion_tpu/models/blocks.py`. Parameters keep the Flax
names and layouts (`kernel` HWIO for convs and (in, out) for dense layers,
`bias`, `scale`), so a Flax parameter tree maps onto `state_dict()` by
joining its path with dots (`convert.py`). Every op casts its parameters to
its compute dtype as the Flax module does, so a module whose parameters
were cast to bf16 for sampling computes what the JAX package computes.

Every 3x3 conv goes through `kernels.conv3x3.conv3x3` and every attention
through `kernels.attention.attention`.

The w8a8 serving path (`quant=True` on `Conv3x3`, `Upsample`, `Block`,
`ResnetBlock`) runs the int8 mode of the conv at the sites `_quant_site`
admits and, while `ranges_enabled()`, threads a bound on each activation's
amax beside it (`:42-54`, `:177-227`), so a conv's int8 scale is a
precomputed scalar: the modules then return `(out, amax)` pairs as the Flax
ones do.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import attention
from ..kernels.conv3x3 import conv3x3, kmajor_weights, quantize_weights

Tensor = torch.Tensor


def lecun_normal_(t: Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """Flax's `lecun_normal`: a normal truncated at two standard deviations,
    scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Module):
    """`flax.linen.Dense`: y = x @ kernel (+ bias), computed in `dtype`."""

    def __init__(self, features_in: int, features: int, *, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features_in, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_params(self, generator=None) -> None:
        lecun_normal_(self.kernel.data, self.kernel.shape[0], generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: Tensor) -> Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """`flax.linen.LayerNorm(dtype=float32)` over the last axis, eps 1e-6."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_params(self, generator=None) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                            self.bias.float(), eps=1e-6)


class PlainConv(nn.Module):
    """`flax.linen.Conv` with a (kh, kw) = stride kernel and VALID padding,
    computed as a matmul over non-overlapping patches in `dtype`: the 1x1
    `res_proj` and the 2x2 stride-2 `Downsample` projection."""

    def __init__(self, features_in: int, features: int, size: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.size = size
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(size, size, features_in, features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_params(self, generator=None) -> None:
        s, _, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel.data, s * s * cin, generator)
        self.bias.data.zero_()

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, c = x.shape
        s = self.size
        if s > 1:  # space-to-depth: (dy, dx, c) is the kernel's HWI order
            x = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, h // s, w // s, s * s * c)
        k = self.kernel.reshape(-1, self.kernel.shape[-1])
        return torch.matmul(x.to(self.dtype), k.to(self.dtype)) + self.bias.to(self.dtype)


class SinusoidalPosEmb(nn.Module):
    """Sinusoidal embedding of continuous diffusion time (scaled by 1000)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: Tensor) -> Tensor:
        half = self.dim // 2
        freqs = torch.exp(
            -math.log(10000.0)
            * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1)
        )
        args = t.float()[:, None] * 1000.0 * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _quant_site(shape, cout: int, chunks: int) -> bool:
    """Does this conv site run the w8a8 int8 path? Gated by the FULL image
    extent (rows * W * chunks) and by both channel widths, with the JAX
    package's defaults and environment variables (`KDT_QUANT_MIN_PIX`, 64²;
    `KDT_QUANT_MIN_CH`, 32)."""
    min_pix = int(os.environ.get("KDT_QUANT_MIN_PIX", 64 * 64))
    min_ch = int(os.environ.get("KDT_QUANT_MIN_CH", 32))
    _, h, w, cin = shape
    return h * w * max(chunks, 1) >= min_pix and cin >= min_ch and cout >= min_ch


def ranges_enabled() -> bool:
    """Range-propagated int8 scales (default); `KDT_QUANT_RANGES=0` falls
    back to a dynamic amax at every int8 conv."""
    return os.environ.get("KDT_QUANT_RANGES", "1") != "0"


# |silu| on (-inf, 0] is bounded by |silu(-1.2785)| = 0.2785, so the max of
# |silu| over z <= zhi is max(silu(zhi), 0.2785)
_SILU_NEG_BOUND = 0.2785
# ranges are reduced in fp32 but bound tensors that round through bf16 (some
# twice): inflate every produced bound past two bf16 half-ulps
_ROUND = 1.0 + 2.0**-7


def amax_from_ranges(ranges: Tensor) -> Tensor:
    """Per-tensor amax bound (fp32 scalar) from a conv range epilogue's
    per-channel [max, min] (B[*chunks], 2, C)."""
    return _ROUND * torch.maximum(ranges[:, 0].abs(), ranges[:, 1].abs()).amax().float()


def silu_affine_amax(affine: Tensor, ranges: Tensor) -> Tensor:
    """Bound (fp32 scalar) on max|silu(a*y + c)| from the affine (B[*chunks],
    2, C) and y's per-channel [max, min]: the range of the deferred
    GroupNorm+FiLM+SiLU activation the next conv consumes."""
    a, c = affine[:, 0], affine[:, 1]
    zhi = torch.maximum(a * ranges[:, 0], a * ranges[:, 1]) + c
    return _ROUND * torch.clamp(F.silu(zhi).amax(), min=_SILU_NEG_BOUND).float()


def dynamic_amax(x: Tensor) -> Tensor:
    """Per-tensor amax (fp32 scalar), reduced in the input's dtype: the exact
    max|x| of a tensor whose producer has no range epilogue (a re-anchor
    point). A NaN propagates, as in `jnp.max`."""
    if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        # sign-magnitude: |x| orders as the low 7 bits, with NaN on top
        # (e4m3fn: 0x7f; e5m2: inf 0x7c, then NaN 0x7d-0x7f), so an inf stays
        # inf and a NaN propagates, as in `jnp.max(jnp.abs(x))`
        m = (x.view(torch.uint8) & 0x7F).amax().reshape(1)
        return m.view(x.dtype).float().reshape(())
    return x.abs().amax().float()


class Conv3x3(nn.Module):
    """3x3 SAME conv through the fused kernel (`kernels.conv3x3`), with its
    silu-affine prologue, GroupNorm-stats and range epilogues. `chunks > 0`:
    the input is row-chunked and the conv exchanges halo rows. `quant=True`
    runs the int8 mode where `_quant_site` admits the input's shape, with
    the weights quantized once per weight tensor; `a_max` bounds the
    (post-prologue) input's amax."""

    def __init__(self, features_in: int, features: int, dtype=torch.bfloat16,
                 zero_init: bool = False, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_init = zero_init
        self.quant = quant
        self.kernel = nn.Parameter(torch.empty(3, 3, features_in, features))
        self.bias = nn.Parameter(torch.empty(features))
        self._w_q = (None, None)  # (key of the weights it was made from, w_q)

    def init_params(self, generator=None) -> None:
        if self.zero_init:
            self.kernel.data.zero_()
        else:
            lecun_normal_(self.kernel.data, 9 * self.kernel.shape[2], generator)
        self.bias.data.zero_()

    def quantized_weights(self, w: Tensor):
        """`quantize_weights(w)` for this module's current weights, made once
        and reused while the parameter is unchanged; on the card followed by
        the same int8 weights laid out K-major for the wgmma int8 kernel."""
        key = (self.kernel.data_ptr(), self.kernel._version, w.dtype, w.device)
        if self._w_q[0] != key:
            w_q = quantize_weights(w)
            if w.device.type == "cuda":
                w_q = w_q + (kmajor_weights(w_q[0]),)
            self._w_q = (key, w_q)
        return self._w_q[1]

    def forward(self, x: Tensor, pro: Optional[Tensor] = None, want_stats: bool = False,
                chunks: int = 0, a_max: Optional[Tensor] = None, want_range: bool = False,
                bias_in_dtype: bool = False):
        """`bias_in_dtype=True` computes what `flax.linen.Conv(dtype)` does
        (output rounded, then the bias added in the compute dtype) and is
        never quantized: the JAX U-Net's unchunked init conv."""
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype)
        quant = (self.quant and not bias_in_dtype
                 and _quant_site(x.shape, w.shape[-1], chunks))
        return conv3x3(x, w, self.bias, pro=pro, want_stats=want_stats, chunks=chunks,
                       quant=quant, a_max=a_max, want_range=want_range,
                       bias_in_dtype=bias_in_dtype,
                       w_q=self.quantized_weights(w) if quant else None)


def FinalConv(features_in: int, features: int, dtype=torch.bfloat16):
    """Output 3x3 conv (`blocks.py:229`): bf16 operands, fp32 accumulation,
    zero-initialised kernel."""
    return Conv3x3(features_in, features, dtype, zero_init=True)


class GroupNormParams(nn.Module):
    """GroupNorm scale / bias; the normalize itself is folded into the next
    conv's prologue by `gn_film_affine`."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def init_params(self, generator=None) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()


def gn_film_affine(stats: Tensor, npix: int, gamma: Tensor, beta: Tensor,
                   scale_shift=None, groups: int = 8, eps: float = 1e-6,
                   chunks: int = 0) -> Tensor:
    """Fold GroupNorm (+ optional FiLM) into a per-(batch, channel) affine:
    silu(y*A + C) == silu(FiLM(GN(y))). `stats` is the conv's (B, 2, C)
    [sum, centered sumsq] over npix pixels; group moments come from the
    exact decomposition var_g = mean_c(var_c) + mean_c((mu_c - mu_g)^2).

    chunks > 0: stats are per row chunk; they combine per image by the
    parallel-variance rule and the affine is repeated back per chunk."""
    if chunks:
        bc = stats.shape[0]
        st = stats.reshape(bc // chunks, chunks, 2, -1)
        s1_i, q_i = st[:, :, 0], st[:, :, 1]
        s1 = s1_i.sum(1)
        mu_i = s1_i / npix
        mu_tot = s1 / (npix * chunks)
        q = q_i.sum(1) + npix * torch.sum((mu_i - mu_tot[:, None]) ** 2, dim=1)
        stats = torch.stack([s1, q], dim=1)
        npix = npix * chunks
    b, _, c = stats.shape
    cpg = c // groups
    mu_c = stats[:, 0] / npix
    var_c = stats[:, 1] / npix
    mu_g = mu_c.reshape(b, groups, cpg).mean(-1)
    spread = ((mu_c.reshape(b, groups, cpg) - mu_g[:, :, None]) ** 2).mean(-1)
    var = var_c.reshape(b, groups, cpg).mean(-1) + spread
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)

    def per_channel(g):  # (B, G) -> (B, C)
        return g[:, :, None].expand(b, groups, cpg).reshape(b, c)

    mu_bc, rstd_c = per_channel(mu_g), per_channel(rstd)
    gamma = gamma.float()[None, :]
    beta = beta.float()[None, :]
    a = gamma * rstd_c
    cc = beta - mu_bc * rstd_c * gamma
    if scale_shift is not None:
        scale, shift = scale_shift
        scale = scale.float() + 1.0
        a = a * scale
        cc = cc * scale + shift.float()
    out = torch.stack([a, cc], dim=1)
    if chunks:
        out = torch.repeat_interleave(out, chunks, dim=0)
    return out


class Downsample(nn.Module):
    """2x downsample: 2x2 stride-2 conv (`blocks.py:264`)."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.bfloat16):
        super().__init__()
        self.proj = PlainConv(dim_in, dim_out, 2, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(x)


class Upsample(nn.Module):
    """2x upsample: nearest neighbour + 3x3 conv (`blocks.py:283`). Row
    chunks upsample chunk-locally and convolve with halo exchange. While
    ranges are tracked (quant) it takes the input's amax bound, which
    nearest neighbour keeps, and returns (out, amax) from the conv's range."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.bfloat16, quant: bool = False):
        super().__init__()
        self.quant = quant
        self.proj = Conv3x3(dim_in, dim_out, dtype, quant=quant)

    def forward(self, x: Tensor, chunks: int = 0, a_max: Optional[Tensor] = None):
        b, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)
        if not (self.quant and ranges_enabled()):
            return self.proj(x, chunks=chunks)
        out, ranges = self.proj(x, chunks=chunks, a_max=a_max, want_range=True)
        return out, amax_from_ranges(ranges)


class Block(nn.Module):
    """3x3 conv -> GroupNorm -> (FiLM) -> SiLU, the GroupNorm from the conv's
    stats epilogue. `defer=True` returns (y, affine) so the caller can fold
    the affine into the next conv's prologue; `pro` is such an affine for
    this block's conv input. While ranges are tracked (quant), `a_max`
    bounds this conv's post-prologue input and the return value gains the
    bound on this block's activation output: (y, affine, amax) or
    (out, amax)."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8, dtype=torch.bfloat16,
                 quant: bool = False):
        super().__init__()
        self.groups = groups
        self.quant = quant
        self.conv = Conv3x3(dim_in, dim_out, dtype, quant=quant)
        self.norm = GroupNormParams(dim_out)

    def forward(self, x: Tensor, scale_shift=None, *, pro: Optional[Tensor] = None,
                defer: bool = False, chunks: int = 0, a_max: Optional[Tensor] = None):
        track = self.quant and ranges_enabled()
        if track:
            y, stats, ranges = self.conv(x, pro=pro, want_stats=True, chunks=chunks,
                                         a_max=a_max, want_range=True)
        else:
            y, stats = self.conv(x, pro=pro, want_stats=True, chunks=chunks)
        affine = gn_film_affine(stats, y.shape[1] * y.shape[2], self.norm.scale,
                                self.norm.bias, scale_shift, self.groups, chunks=chunks)
        out_amax = silu_affine_amax(affine, ranges) if track else None
        if defer:
            return (y, affine, out_amax) if track else (y, affine)
        a = affine[:, 0][:, None, None, :]
        c = affine[:, 1][:, None, None, :]
        out = F.silu(y.float() * a + c).to(y.dtype)
        return (out, out_amax) if track else out


class ResnetBlock(nn.Module):
    """Two conv blocks with FiLM time conditioning and a residual path;
    block1's GroupNorm+FiLM+SiLU is deferred into block2's conv prologue."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: Optional[int],
                 groups: int = 8, dtype=torch.bfloat16, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.quant = quant
        if time_dim is not None:
            self.time_proj = Dense(time_dim, dim_out * 2, dtype=torch.float32)
        self.block1 = Block(dim_in, dim_out, groups, dtype, quant)
        self.block2 = Block(dim_out, dim_out, groups, dtype, quant)
        if dim_in != dim_out:
            self.res_proj = PlainConv(dim_in, dim_out, 1, dtype)

    def forward(self, x: Tensor, time_emb: Optional[Tensor] = None,
                chunks: int = 0, a_max: Optional[Tensor] = None):
        """`time_emb` is per image, also when `x` is row-chunked. While ranges
        are tracked (quant) returns (out, amax): block1's scale comes from
        `a_max` (a dynamic amax of `x` without one), block2's from block1's
        silu-affine range, and the residual add bounds subadditively."""
        track = self.quant and ranges_enabled()
        x = x.to(self.dtype)  # inputs may arrive in the storage dtype
        scale_shift = None
        if time_emb is not None:
            emb = self.time_proj(F.silu(time_emb.float()))
            scale_shift = torch.chunk(emb, 2, dim=-1)
        if track:
            if a_max is None:
                a_max = dynamic_amax(x)
            y1, pro1, a1 = self.block1(x, scale_shift, defer=True, chunks=chunks, a_max=a_max)
            h, ah = self.block2(y1, pro=pro1, chunks=chunks, a_max=a1)
        else:
            y1, pro1 = self.block1(x, scale_shift, defer=True, chunks=chunks)
            h = self.block2(y1, pro=pro1, chunks=chunks)
        if hasattr(self, "res_proj"):
            res = self.res_proj(x)
            ares = dynamic_amax(res) if track else None
        else:
            res, ares = x, a_max
        if not track:
            return h + res
        return h + res, _ROUND * (ah + ares)


def _heads(t: Tensor, b: int, n: int, heads: int, dim_head: int) -> Tensor:
    return t.reshape(b, n, heads, dim_head)


class SelfAttention(nn.Module):
    """Self-attention; optional context tokens (cond_dim wide) get their own
    LayerNorm and k/v projections and are appended to the keys."""

    def __init__(self, dim: int, context_dim: Optional[int], heads: int = 8,
                 dim_head: int = 64, dtype=torch.bfloat16):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.norm = LayerNorm(dim)
        self.to_q = Dense(dim, inner, use_bias=False, dtype=dtype)
        self.to_k = Dense(dim, inner, use_bias=False, dtype=dtype)
        self.to_v = Dense(dim, inner, use_bias=False, dtype=dtype)
        if context_dim is not None:
            self.ctx_norm = LayerNorm(context_dim)
            self.ctx_to_k = Dense(context_dim, inner, use_bias=False, dtype=dtype)
            self.ctx_to_v = Dense(context_dim, inner, use_bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x: Tensor, context: Optional[Tensor] = None) -> Tensor:
        b, n, _ = x.shape
        normed = self.norm(x).to(self.dtype)
        q, k, v = self.to_q(normed), self.to_k(normed), self.to_v(normed)
        m = n
        if context is not None:
            ctx = self.ctx_norm(context).to(self.dtype)
            k = torch.cat([k, self.ctx_to_k(ctx)], dim=1)
            v = torch.cat([v, self.ctx_to_v(ctx)], dim=1)
            m = n + context.shape[1]
        out = attention(_heads(q, b, n, self.heads, self.dim_head),
                        _heads(k, b, m, self.heads, self.dim_head),
                        _heads(v, b, m, self.heads, self.dim_head)).to(self.dtype)
        return self.to_out(out.reshape(b, n, self.heads * self.dim_head))


class CrossAttention(nn.Module):
    """Pixels attend to conditioning tokens (time tokens + text tokens)."""

    def __init__(self, dim: int, context_dim: int, heads: int = 8, dim_head: int = 64,
                 dtype=torch.bfloat16):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.norm = LayerNorm(dim)
        self.ctx_norm = LayerNorm(context_dim)
        self.to_q = Dense(dim, inner, use_bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, use_bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, use_bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x: Tensor, context: Tensor) -> Tensor:
        b, n, _ = x.shape
        m = context.shape[1]
        normed = self.norm(x).to(self.dtype)
        ctx = self.ctx_norm(context).to(self.dtype)
        out = attention(_heads(self.to_q(normed), b, n, self.heads, self.dim_head),
                        _heads(self.to_k(ctx), b, m, self.heads, self.dim_head),
                        _heads(self.to_v(ctx), b, m, self.heads, self.dim_head)).to(self.dtype)
        return self.to_out(out.reshape(b, n, self.heads * self.dim_head))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 2, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(dim)
        self.add_module("in", Dense(dim, dim * mult, dtype=dtype))  # Flax name
        self.out = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        h = self.norm(x).to(self.dtype)
        h = F.gelu(getattr(self, "in")(h), approximate="tanh")  # flax nn.gelu
        return self.out(h)


class TransformerBlock(nn.Module):
    """Self-attention (+ context) then a feed-forward, on a feature map."""

    def __init__(self, dim: int, context_dim: Optional[int], heads: int = 8,
                 dim_head: int = 64, ff_mult: int = 2, dtype=torch.bfloat16):
        super().__init__()
        self.attn = SelfAttention(dim, context_dim, heads, dim_head, dtype)
        self.ff = FeedForward(dim, ff_mult, dtype)

    def forward(self, x: Tensor, context: Optional[Tensor] = None) -> Tensor:
        b, h, w, c = x.shape
        seq = x.reshape(b, h * w, c)
        seq = seq + self.attn(seq, context)
        seq = seq + self.ff(seq)
        return seq.reshape(b, h, w, c)


class CrossAttentionBlock(nn.Module):
    """Residual cross-attention applied to a feature map."""

    def __init__(self, dim: int, context_dim: int, heads: int = 8, dim_head: int = 64,
                 dtype=torch.bfloat16):
        super().__init__()
        self.attn = CrossAttention(dim, context_dim, heads, dim_head, dtype)

    def forward(self, x: Tensor, context: Tensor) -> Tensor:
        b, h, w, c = x.shape
        seq = x.reshape(b, h * w, c)
        seq = seq + self.attn(seq, context)
        return seq.reshape(b, h, w, c)
