"""Declarative configurations: U-Net, stage and cascade dataclasses.

Own copies of `kidney_diffusion_tpu/models/unet.py:UNetConfig`,
`kidney_diffusion_tpu/models/configs.py` and the `EDMConfig` fields of
`kidney_diffusion_tpu/core/elucidated.py` — the JAX modules import JAX, and
the port must not. Field names, defaults and factory values are the same,
so a config built here describes the same network as its JAX twin.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch


def per_level(value, num_levels: int) -> Tuple:
    if isinstance(value, (tuple, list)):
        assert len(value) == num_levels, f"{value} vs {num_levels} levels"
        return tuple(value)
    return (value,) * num_levels


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static U-Net configuration (`kidney_diffusion_tpu/models/unet.py:61`).

    `quant_conv="int8"` runs the w8a8 int8 conv at the sites
    `models.blocks._quant_site` admits; `storage_dtype` (e.g.
    "float8_e4m3fn") stores block-boundary feature maps narrow while compute
    stays in `dtype` (`serving_overrides`). `remat` only trades memory in
    training and does not change the forward function."""

    dim: int = 128
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    channels: int = 3
    cond_dim: Optional[int] = None  # defaults to dim
    text_embed_dim: Optional[int] = None  # None => unconditional on text
    num_resnet_blocks: Union[int, Tuple[int, ...]] = 1
    layer_attns: Union[bool, Tuple[bool, ...]] = False
    layer_cross_attns: Union[bool, Tuple[bool, ...]] = False
    attn_heads: int = 8
    attn_dim_head: int = 64
    ff_mult: int = 2
    memory_efficient: bool = False
    init_conv_to_final_conv_residual: bool = False
    cond_images_channels: int = 0
    lowres_cond: bool = False
    num_time_tokens: int = 2
    groups: int = 8
    dtype: str = "bfloat16"  # compute dtype; params are always fp32
    remat: bool = False
    spatial_chunks: int = 0  # >0: batch-of-row-chunks layout
    quant_conv: Optional[str] = None
    storage_dtype: Optional[str] = None

    @property
    def num_levels(self) -> int:
        return len(self.dim_mults)

    @property
    def resolved_cond_dim(self) -> int:
        return self.cond_dim or self.dim

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    """Fields of `kidney_diffusion_tpu/core/elucidated.py:EDMConfig`. The
    EDM sampler is not ported yet; the dataclass is a field type only."""

    num_sample_steps: int = 32
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0
    P_mean: float = -1.2
    P_std: float = 1.2
    S_churn: float = 80.0
    S_tmin: float = 0.05
    S_tmax: float = 50.0
    S_noise: float = 1.003


@dataclasses.dataclass(frozen=True)
class StageConfig:
    unet: UNetConfig
    image_size: int
    timesteps: int
    pred_objective: str = "noise"  # "noise" | "v" | "x_start"
    random_crop_size: Optional[int] = None
    noise_schedule: str = "cosine"
    sampler: str = "ddpm"  # "ddpm" | "edm"
    edm: Optional[EDMConfig] = None

    @property
    def lowres_cond(self) -> bool:
        return self.unet.lowres_cond


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    name: str
    stages: Tuple[StageConfig, ...]
    text_embed_dim: Optional[int] = None
    condition_on_text: bool = False
    cond_drop_prob: float = 0.1
    channels: int = 3
    lowres_sample_noise_level: float = 0.2
    lowres_max_aug_level: float = 0.999
    lowres_noise_schedule: str = "linear"

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def stage(self, unet_number: int) -> StageConfig:
        """1-indexed, mirroring the reference's `unet_number` convention."""
        return self.stages[unet_number - 1]


def _base_unet(*, dim_mults=(1, 2, 4, 8), cond_dim=None, text_embed_dim=None,
               cond_images_channels=0) -> UNetConfig:
    """64² base stage."""
    return UNetConfig(
        dim=256,
        dim_mults=dim_mults,
        cond_dim=cond_dim,
        text_embed_dim=text_embed_dim,
        num_resnet_blocks=3,
        layer_attns=(False, True, True, True),
        layer_cross_attns=(False, True, True, True),
        cond_images_channels=cond_images_channels,
        lowres_cond=False,
    )


def _sr256_unet(*, cond_dim=None, text_embed_dim=None, cond_images_channels=0) -> UNetConfig:
    """64->256 super-res stage."""
    return UNetConfig(
        dim=128,
        dim_mults=(1, 2, 4, 8),
        cond_dim=cond_dim,
        text_embed_dim=text_embed_dim,
        num_resnet_blocks=2,
        memory_efficient=True,
        layer_attns=(False, False, False, True),
        layer_cross_attns=(False, False, True, True),
        init_conv_to_final_conv_residual=True,
        cond_images_channels=cond_images_channels,
        lowres_cond=True,
    )


def _sr1024_unet(*, num_resnet_blocks=(2, 4, 4, 4), cond_dim=None, text_embed_dim=None,
                 cond_images_channels=0) -> UNetConfig:
    """256->1024 super-res stage, run in the batch-of-row-chunks layout."""
    return UNetConfig(
        dim=128,
        dim_mults=(1, 2, 4, 8),
        cond_dim=cond_dim,
        text_embed_dim=text_embed_dim,
        num_resnet_blocks=num_resnet_blocks,
        memory_efficient=True,
        layer_attns=False,
        layer_cross_attns=(False, False, False, True),
        init_conv_to_final_conv_residual=True,
        cond_images_channels=cond_images_channels,
        lowres_cond=True,
        spatial_chunks=16,
    )


def patch_conditioned() -> CascadeConfig:
    kw = dict(cond_dim=512, text_embed_dim=3, cond_images_channels=4)
    return CascadeConfig(
        name="patch_conditioned",
        stages=(
            StageConfig(_base_unet(dim_mults=(1, 2, 3, 4), **kw), 64, 1024, "noise"),
            StageConfig(_sr256_unet(**kw), 256, 256, "v"),
            StageConfig(_sr1024_unet(**kw), 1024, 256, "v", random_crop_size=256),
        ),
        text_embed_dim=3,
        condition_on_text=True,
    )


def patch_unconditional() -> CascadeConfig:
    kw = dict(cond_dim=512)
    return CascadeConfig(
        name="patch_unconditional",
        stages=(
            StageConfig(_base_unet(**kw), 64, 1024, "noise"),
            StageConfig(_sr256_unet(**kw), 256, 256, "noise"),
            StageConfig(_sr1024_unet(**kw), 1024, 256, "noise", random_crop_size=256),
        ),
        condition_on_text=False,
    )


_ULTRA_RES_VARIANTS = {
    # version: (base dim_mults, sr1024 blocks, objectives, cond channels for mag>0)
    "v1": ((1, 2, 4, 8), (2, 4, 6, 8), ("noise", "noise", "noise"), 3),
    "v2": ((1, 2, 4, 8), (2, 4, 6, 8), ("noise", "noise", "noise"), 6),
    "v_param": ((1, 2, 3, 4), (2, 4, 6, 8), ("noise", "v", "v"), 3),
    "airs": ((1, 2, 3, 4), (2, 4, 6, 8), ("v", "v", "v"), 3),
}


def ultra_res(magnification_level: int, version: str = "v1") -> CascadeConfig:
    """Ultra-res cascade for one magnification level
    (`kidney_diffusion_tpu/models/configs.py:180`)."""
    if version not in _ULTRA_RES_VARIANTS:
        raise ValueError(f"unknown ultra-res version {version!r}")
    base_mults, sr1024_blocks, objectives, cond_ch = _ULTRA_RES_VARIANTS[version]
    cc = cond_ch if magnification_level > 0 else 0
    return CascadeConfig(
        name=f"ultra_res_{version}_mag{magnification_level}",
        stages=(
            StageConfig(
                _base_unet(dim_mults=base_mults, cond_images_channels=cc),
                64, 1024, objectives[0],
            ),
            StageConfig(_sr256_unet(cond_images_channels=cc), 256, 256, objectives[1]),
            StageConfig(
                _sr1024_unet(num_resnet_blocks=sr1024_blocks, cond_images_channels=cc),
                1024, 256, objectives[2], random_crop_size=256,
            ),
        ),
        condition_on_text=False,
    )


def kumar() -> CascadeConfig:
    kw = dict(cond_dim=512, text_embed_dim=2, cond_images_channels=1)
    return CascadeConfig(
        name="kumar",
        stages=(
            StageConfig(_base_unet(dim_mults=(1, 2, 3, 4), **kw), 64, 1000, "noise"),
            StageConfig(_sr256_unet(**kw), 256, 1000, "noise"),
        ),
        text_embed_dim=2,
        condition_on_text=True,
    )


_REGISTRY = {
    "patch_conditioned": lambda **kw: patch_conditioned(),
    "patch_unconditional": lambda **kw: patch_unconditional(),
    "ultra_res": lambda **kw: ultra_res(**kw),
    "kumar": lambda **kw: kumar(),
}


def get_cascade(name: str, **kwargs) -> CascadeConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown cascade {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def serving_overrides(config: CascadeConfig, *, quant: Optional[str] = None,
                      storage: Optional[str] = None,
                      min_image_size: int = 512) -> CascadeConfig:
    """Serving-time overrides (`kidney_diffusion_tpu/models/configs.py:308`):
    the w8a8 int8 conv path (`quant="int8"`) and/or narrow activation
    storage (`storage="float8_e4m3fn"`) on every stage at or above
    `min_image_size`. Checkpoints are unchanged: weights quantize from the
    bf16 parameters at run time."""
    if not quant and not storage:
        return config
    stages = tuple(
        dataclasses.replace(
            st, unet=dataclasses.replace(st.unet, quant_conv=quant, storage_dtype=storage))
        if st.image_size >= min_image_size else st
        for st in config.stages
    )
    return dataclasses.replace(config, stages=stages)


def tiny_test_cascade(
    *,
    num_stages: int = 2,
    condition_on_text: bool = False,
    cond_images_channels: int = 0,
    objectives: Tuple[str, ...] = ("noise", "v"),
    image_sizes: Tuple[int, ...] = (16, 32),
    timesteps: int = 8,
) -> CascadeConfig:
    """Miniature cascade for CPU tests: same topology, toy dims."""
    text_dim = 3 if condition_on_text else None
    stages = []
    for i in range(num_stages):
        stages.append(
            StageConfig(
                UNetConfig(
                    dim=16,
                    dim_mults=(1, 2),
                    cond_dim=16,
                    text_embed_dim=text_dim,
                    num_resnet_blocks=1,
                    layer_attns=(False, True),
                    layer_cross_attns=(False, True),
                    memory_efficient=i > 0,
                    init_conv_to_final_conv_residual=i > 0,
                    cond_images_channels=cond_images_channels,
                    lowres_cond=i > 0,
                    attn_heads=2,
                    attn_dim_head=8,
                    dtype="float32",
                ),
                image_sizes[i],
                timesteps,
                objectives[i],
            )
        )
    return CascadeConfig(
        name="tiny_test",
        stages=tuple(stages),
        text_embed_dim=text_dim,
        condition_on_text=condition_on_text,
    )
