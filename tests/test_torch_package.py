"""Package-level rules of the PyTorch port: what it imports, where it runs."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kidney_diffusion_tpu_torch
from kidney_diffusion_tpu_torch import cascade as tcas
from kidney_diffusion_tpu_torch import convert
from kidney_diffusion_tpu_torch.models import configs as tcfg

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(kidney_diffusion_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "flax", "kidney_diffusion_tpu")


def _port_modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    """Every module of the port imports in a fresh interpreter without
    bringing in jax, flax or the JAX package."""
    mods = list(_port_modules())
    assert len(mods) > 10
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", ["kidney_diffusion_tpu_torch", "chip_smoke.py"])
def test_sources_name_no_jax(path):
    """No source of the port, nor the chip smoke script, imports JAX."""
    files = [ROOT / path] if path.endswith(".py") else sorted((ROOT / path).rglob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (f, n)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the entry points raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.tiny_test_cascade()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcas.Cascade(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.init_stage_params(cfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_flax({"params": {}})
    cascade = tcas.Cascade(cfg, device="cpu")
    params = cascade.init_stage_params(1, torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in params.values())
    out = cascade.sample_stage(params, 1, torch.Generator().manual_seed(1), batch_size=1,
                               ddim_steps=1, use_ddim=True)
    assert out.shape == (1, 16, 16, 3) and out.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    """`chip_smoke.py` exits non-zero and prints no result line off the card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_configs_match_the_flagship():
    cfg = tcfg.get_cascade("ultra_res", magnification_level=0, version="v_param")
    assert [st.timesteps for st in cfg.stages] == [1024, 256, 256]
    assert [st.pred_objective for st in cfg.stages] == ["noise", "v", "v"]
    s1, s2, s3 = (st.unet for st in cfg.stages)
    assert (s1.dim, s1.dim_mults, s1.num_resnet_blocks) == (256, (1, 2, 3, 4), 3)
    assert s2.memory_efficient and s2.lowres_cond and s2.dim == 128
    assert (s3.num_resnet_blocks, s3.spatial_chunks) == ((2, 4, 6, 8), 16)
    # the shipped serving overrides build: int8 + fp8 storage on stage 3 only
    from kidney_diffusion_tpu_torch.models.unet import EfficientUNet

    served = tcfg.serving_overrides(cfg, quant="int8", storage="float8_e4m3fn")
    assert [st.unet.storage_dtype for st in served.stages] == [None, None, "float8_e4m3fn"]
    with torch.device("meta"):
        EfficientUNet(served.stage(3).unet)
    with pytest.raises(ValueError):
        EfficientUNet(tcfg.UNetConfig(quant_conv="int4"))
