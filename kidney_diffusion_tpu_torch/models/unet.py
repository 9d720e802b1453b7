"""Efficient U-Net for cascaded diffusion (NHWC, bf16 compute).

Port of `kidney_diffusion_tpu/models/unet.py::EfficientUNet` (exact path):
time tokens, text tokens with learned CFG null tokens, `cond_images`,
low-res conditioning with its noise-level embedding, `memory_efficient`
downsampling at each level's entry, the init -> final conv residual, and the
batch-of-row-chunks layout (`spatial_chunks`, applied only when
H % (chunks * 2**levels) == 0), and the serving options `quant_conv="int8"`
(w8a8 convs at the `_quant_site` sites, with range-propagated activation
scales) and `storage_dtype` (block-boundary feature maps and skips stored
narrow, cast exactly where the JAX forward casts). `remat` (training only)
recomputes every `ResnetBlock` in the backward instead of keeping its
activations, as `nn.remat(ResnetBlock)` does, through
`torch.utils.checkpoint` (non-reentrant); it does not change the function.
Submodule and parameter
names are the Flax ones, so `state_dict()` keys are the Flax parameter
paths joined by dots.

Flax infers input widths at call time; a torch module needs them when it is
built, so `EfficientUNet.__init__` walks the same level structure as the
forward to size every block.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import (
    Conv3x3,
    CrossAttentionBlock,
    Dense,
    Downsample,
    FinalConv,
    ResnetBlock,
    SinusoidalPosEmb,
    TransformerBlock,
    Upsample,
    amax_from_ranges,
    dynamic_amax,
    ranges_enabled,
)
from .configs import UNetConfig, per_level

Tensor = torch.Tensor


# float8_e4m3fn has no infinity: JAX (ml_dtypes) turns a value that rounds
# past its largest finite value, 448, into NaN; torch saturates to 448. The
# rounding midpoint between 448 and the next step, 480, is 464 (a tie goes
# to 448, the even one).
_E4M3_NAN_ABOVE = 464.0


def cast_storage(x: Tensor, dtype: torch.dtype) -> Tensor:
    """`x.astype(dtype)` as JAX does it: for float8_e4m3fn, |x| > 464, inf and
    NaN become NaN instead of torch's saturated +-448; below that both round
    to nearest even. float8_e5m2 has infinities, and torch's cast is JAX's
    (round to nearest even; from 61440 up, inf). Other dtypes cast as torch
    casts; another 1-byte float raises."""
    if x.dtype == dtype:
        return x
    if dtype == torch.float8_e4m3fn:
        return torch.where(x.abs() <= _E4M3_NAN_ABOVE, x, float("nan")).to(dtype)
    if dtype.is_floating_point and dtype.itemsize == 1 and dtype != torch.float8_e5m2:
        raise NotImplementedError(f"storage in {dtype}: only float8_e4m3fn and e5m2 are ported")
    return x.to(dtype)


def resize_nearest(x: Tensor, h: int, w: int) -> Tensor:
    """`jax.image.resize(..., method="nearest")` on NHWC: source index
    floor((i + 0.5) * in / out), computed in fp32 as JAX does."""
    for dim, out in ((1, h), (2, w)):
        n_in = x.shape[dim]
        if n_in == out:
            continue
        pos = (torch.arange(out, dtype=torch.float32, device=x.device) + 0.5) * n_in / out
        x = torch.index_select(x, dim, torch.floor(pos).long())
    return x


class EfficientUNet(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        if config.quant_conv not in (None, "int8"):
            raise ValueError(f"quant_conv must be None or 'int8', got {config.quant_conv!r}")
        cfg = self.config = config
        dt = cfg.compute_dtype
        qt = cfg.quant_conv == "int8"
        L = cfg.num_levels
        dims = tuple(cfg.dim * m for m in cfg.dim_mults)
        blocks_per = per_level(cfg.num_resnet_blocks, L)
        attns_per = per_level(cfg.layer_attns, L)
        cross_per = per_level(cfg.layer_cross_attns, L)
        tdim = cfg.dim * 4
        cond_dim = cfg.resolved_cond_dim

        def res(name, cin, cout):
            self.add_module(name, ResnetBlock(cin, cout, tdim, cfg.groups, dt, qt))

        def cross(name, d):
            self.add_module(name, CrossAttentionBlock(
                d, cond_dim, cfg.attn_heads, cfg.attn_dim_head, dt))

        def attn(name, d):
            self.add_module(name, TransformerBlock(
                d, cond_dim, cfg.attn_heads, cfg.attn_dim_head, cfg.ff_mult, dt))

        in_ch = cfg.channels * (2 if cfg.lowres_cond else 1) + cfg.cond_images_channels
        self.time_pos_emb = SinusoidalPosEmb(cfg.dim)
        self.time_mlp = Dense(cfg.dim, tdim)
        self.to_time_cond = Dense(tdim, tdim)
        self.to_time_tokens = Dense(tdim, cond_dim * cfg.num_time_tokens)
        if cfg.lowres_cond:
            self.lowres_time_pos_emb = SinusoidalPosEmb(cfg.dim)
            self.lowres_time_mlp = Dense(cfg.dim, tdim)
            self.lowres_to_time_cond = Dense(tdim, tdim)
            self.lowres_to_time_tokens = Dense(tdim, cond_dim * cfg.num_time_tokens)
        if cfg.text_embed_dim is not None:
            self.text_to_cond = Dense(cfg.text_embed_dim, cond_dim)
            self.null_text_token = nn.Parameter(torch.empty(1, 1, cond_dim))
            self.null_text_pooled = nn.Parameter(torch.empty(1, tdim))
            self.text_pool_proj = Dense(cond_dim, tdim)

        self.init_conv = Conv3x3(in_ch, cfg.dim, dt, quant=qt)
        cur = cfg.dim
        skips = []
        for i in range(L):
            d = dims[i]
            if cfg.memory_efficient:
                self.add_module(f"down{i}_pre", Downsample(cur, d, dt))
                cur = d
            res(f"down{i}_block0", cur, d)
            cur = d
            if cross_per[i]:
                cross(f"down{i}_cross", d)
            skips.append(d)
            for j in range(blocks_per[i]):
                res(f"down{i}_block{j + 1}", d, d)
                skips.append(d)
            if attns_per[i]:
                attn(f"down{i}_attn", d)
            if not cfg.memory_efficient and i < L - 1:
                self.add_module(f"down{i}_post", Downsample(d, dims[i + 1], dt))
                cur = dims[i + 1]
        res("mid_block1", cur, dims[-1])
        if cross_per[-1]:
            cross("mid_cross", dims[-1])
        if attns_per[-1]:
            attn("mid_attn", dims[-1])
        res("mid_block2", dims[-1], dims[-1])
        cur = dims[-1]
        for i in reversed(range(L)):
            d = dims[i]
            for j in range(blocks_per[i] + 1):
                res(f"up{i}_block{j}", cur + skips.pop(), d)
                cur = d
            if cross_per[i]:
                cross(f"up{i}_cross", d)
            if attns_per[i]:
                attn(f"up{i}_attn", d)
            if cfg.memory_efficient or i > 0:
                up_dim = ((dims[i - 1] if i > 0 else cfg.dim)
                          if cfg.memory_efficient else dims[i - 1])
                self.add_module(f"up{i}_upsample", Upsample(d, up_dim, dt, qt))
                cur = up_dim
        assert not skips, "skip connection mismatch"
        if cfg.init_conv_to_final_conv_residual:
            cur += cfg.dim
        res("final_block", cur, cfg.dim)
        self.final_conv = FinalConv(cfg.dim, cfg.channels, dt)

    def init_params(self, generator=None) -> None:
        if self.config.text_embed_dim is not None:
            nn.init.normal_(self.null_text_token.data, 0.0, 0.02, generator=generator)
            nn.init.normal_(self.null_text_pooled.data, 0.0, 0.02, generator=generator)

    def forward(
        self,
        x: Tensor,
        time: Tensor,
        *,
        text_embeds: Optional[Tensor] = None,
        cond_images: Optional[Tensor] = None,
        lowres_cond_img: Optional[Tensor] = None,
        lowres_noise_times: Optional[Tensor] = None,
        cond_drop_mask: Optional[Tensor] = None,
    ) -> Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        b, h_in, w_in, _ = x.shape
        L = cfg.num_levels
        blocks_per = per_level(cfg.num_resnet_blocks, L)
        attns_per = per_level(cfg.layer_attns, L)
        cross_per = per_level(cfg.layer_cross_attns, L)
        cond_dim = cfg.resolved_cond_dim

        # ---- assemble input channels ------------------------------------
        parts = [x.to(dt)]
        if cfg.lowres_cond:
            if lowres_cond_img is None:
                raise ValueError("stage configured with lowres_cond needs lowres_cond_img")
            parts.append(lowres_cond_img.to(dt))
        if cfg.cond_images_channels:
            if cond_images is None:
                raise ValueError(
                    f"model expects {cfg.cond_images_channels} cond_image channels")
            parts.append(resize_nearest(cond_images, h_in, w_in).to(dt))
        x = torch.cat(parts, dim=-1)

        # ---- time conditioning --------------------------------------------
        t_hidden = F.silu(self.time_mlp(self.time_pos_emb(time)))
        t_cond = self.to_time_cond(t_hidden)
        time_tokens = self.to_time_tokens(t_hidden).reshape(b, cfg.num_time_tokens, cond_dim)
        if cfg.lowres_cond:
            if lowres_noise_times is None:
                lowres_noise_times = torch.zeros((b,), dtype=torch.float32, device=x.device)
            lr_hidden = F.silu(self.lowres_time_mlp(self.lowres_time_pos_emb(lowres_noise_times)))
            t_cond = t_cond + self.lowres_to_time_cond(lr_hidden)
            lr_tokens = self.lowres_to_time_tokens(lr_hidden).reshape(
                b, cfg.num_time_tokens, cond_dim)
            time_tokens = torch.cat([time_tokens, lr_tokens], dim=1)

        # ---- text conditioning with CFG null tokens -------------------------
        context = time_tokens
        if cfg.text_embed_dim is not None and text_embeds is not None:
            text_tokens = self.text_to_cond(text_embeds.float())
            pooled = F.silu(self.text_pool_proj(text_tokens.mean(dim=1)))
            if cond_drop_mask is not None:
                keep = (1.0 - cond_drop_mask.float())[:, None, None]
                null_token = self.null_text_token.float()
                null_pooled = self.null_text_pooled.float()
                text_tokens = text_tokens * keep + null_token * (1.0 - keep)
                pooled = pooled * keep[:, :, 0] + null_pooled * (1.0 - keep[:, :, 0])
            t_cond = t_cond + pooled
            context = torch.cat([time_tokens, text_tokens], dim=1)
        context = context.to(dt)

        # ---- batch-of-row-chunks layout -------------------------------------
        ch = cfg.spatial_chunks
        if ch and (h_in % (ch * 2**L) != 0 or h_in // ch < 2):
            ch = 0  # shape not chunkable (e.g. tiny test inputs)
        if ch:
            x = x.reshape(b * ch, h_in // ch, w_in, x.shape[-1])

        def unchunked(y):
            y = y.to(dt)
            return y.reshape(b, y.shape[1] * ch, *y.shape[2:]) if ch else y

        def rechunked(y):
            return y.reshape(b * ch, y.shape[1] // ch, *y.shape[2:]) if ch else y

        # range propagation (w8a8 serving): `xa` bounds the amax of `x` so
        # every int8 conv's scale is a precomputed scalar; None where no bound
        # is known. Untracked producers (downsamples, attention) re-anchor
        # with one reduction.
        track = cfg.quant_conv == "int8" and ranges_enabled()
        sdt = getattr(torch, cfg.storage_dtype) if cfg.storage_dtype else None
        # narrow storage rounds half an ulp either way: inflate carried bounds
        sf = 1.0 + torch.finfo(sdt).eps if sdt is not None else 1.0

        def store(y, ya=None):
            """Block-boundary storage of a feature map and its bound."""
            if sdt is not None:
                y = cast_storage(y, sdt)
                ya = None if ya is None else ya * sf
            return y, ya

        def reanchor(y):
            return dynamic_amax(y) if track else None

        remat = cfg.remat and torch.is_grad_enabled()

        def res_block(name, *args, **kw):
            mod = getattr(self, name)
            if remat:  # `nn.remat(ResnetBlock)`: recomputed in the backward
                return checkpoint(mod, *args, use_reentrant=False, **kw)
            return mod(*args, **kw)

        def block(name, y, ya):
            if track:
                return store(*res_block(name, y, t_cond, chunks=ch, a_max=ya))
            return store(res_block(name, y, t_cond, chunks=ch))[0], None

        def attn_block(name, y):
            y, _ = store(rechunked(getattr(self, name)(unchunked(y), context)))
            return y, reanchor(y)

        def bound_max(a, b):
            return torch.maximum(a, b) if a is not None and b is not None else None

        # ---- init conv ----------------------------------------------------------
        xa = None
        if ch:
            if track:
                x, r = self.init_conv(x, chunks=ch, want_range=True)
                xa = amax_from_ranges(r)
            else:
                x = self.init_conv(x, chunks=ch)
        else:  # `nn.Conv(dtype)` in the JAX forward: never quantized
            x = self.init_conv(x, bias_in_dtype=True)
            xa = reanchor(x)
        x, xa = store(x, xa)
        init_conv_out, init_a = x, xa

        # ---- down path ----------------------------------------------------------
        skips = []
        for i in range(L):
            if cfg.memory_efficient:
                x, _ = store(getattr(self, f"down{i}_pre")(x))
                xa = reanchor(x)
            x, xa = block(f"down{i}_block0", x, xa)
            if cross_per[i]:
                x, xa = attn_block(f"down{i}_cross", x)
            skips.append((x, xa))
            for j in range(blocks_per[i]):
                x, xa = block(f"down{i}_block{j + 1}", x, xa)
                skips.append((x, xa))
            if attns_per[i]:
                x, xa = attn_block(f"down{i}_attn", x)
            if not cfg.memory_efficient and i < L - 1:
                x, _ = store(getattr(self, f"down{i}_post")(x))
                xa = reanchor(x)

        # ---- middle -------------------------------------------------------------
        x, xa = block("mid_block1", x, xa)
        if cross_per[-1]:
            x, xa = attn_block("mid_cross", x)
        if attns_per[-1]:
            x, xa = attn_block("mid_attn", x)
        x, xa = block("mid_block2", x, xa)

        # ---- up path ------------------------------------------------------------
        for i in reversed(range(L)):
            for j in range(blocks_per[i] + 1):
                skip, ska = skips.pop()
                x, xa = store(x, xa)
                xa = bound_max(xa, ska)
                x, xa = block(f"up{i}_block{j}", torch.cat([x, skip], dim=-1), xa)
            if cross_per[i]:
                x, xa = attn_block(f"up{i}_cross", x)
            if attns_per[i]:
                x, xa = attn_block(f"up{i}_attn", x)
            if cfg.memory_efficient or i > 0:
                up = getattr(self, f"up{i}_upsample")
                if track:
                    x, xa = store(*up(x, chunks=ch, a_max=xa))
                else:
                    x, _ = store(up(x, chunks=ch))
        assert not skips, "skip connection mismatch"

        # ---- final --------------------------------------------------------------
        if cfg.init_conv_to_final_conv_residual:
            x, xa = store(x, xa)
            xa = bound_max(xa, init_a)
            x = torch.cat([x, init_conv_out], dim=-1)
        if track:
            x = res_block("final_block", x, t_cond, chunks=ch, a_max=xa)[0]
        else:
            x = res_block("final_block", x, t_cond, chunks=ch)
        return unchunked(self.final_conv(x, chunks=ch))


class NullUNet:
    """Identity placeholder for cascade stages not owned by this process
    (`kidney_diffusion_tpu/models/unet.py:389`)."""

    def __init__(self, lowres_cond: bool = False):
        self.lowres_cond = lowres_cond

    def init(self, *args, **kwargs):
        return {}

    def apply(self, params, x, *args, **kwargs):
        return x
