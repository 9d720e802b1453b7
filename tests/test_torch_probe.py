"""The port's int8 tap-product probe against the JAX package's Pallas probe
bodies, on the CPU.

`tools/probe_int8_pallas.py` is loaded from its file (it is a script, not a
package module) and its kernel bodies are called with numpy arrays in place
of the Pallas refs: they only index and assign. The inputs are the
original's own draws (seed 0, full size M = 8192). Tolerances: the two int8
variants are bit-equal (exact int32 sums, the same fp32 scale steps); the
bf16 variant sums 1152 fp32 products in another order than XLA's dot, so
about one output in 10^4 rounds to the neighbouring bf16 value: 2 bf16 ulps
of the largest value and 2^-8 normwise, the conv kernel's output tolerance
on the card.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kidney_diffusion_tpu_torch.tools import probe_int8 as tp

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = (2 * 2.0**-7, 2.0**-8)  # (max abs / max|ref|, normwise)


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_int8_pallas", ROOT / "tools" / "probe_int8_pallas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _original_inputs():
    """`tools/probe_int8_pallas.py:main`'s arrays, as numpy (bf16 via
    ml_dtypes), drawn in its order."""
    rng = np.random.default_rng(0)
    bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    i8 = lambda a: np.asarray(jnp.asarray(a, jnp.int8))  # noqa: E731
    out = {"bf16_dot": (bf16(rng.normal(size=(tp.M, tp.K))),
                        bf16(rng.normal(size=(tp.TAPS, tp.K, tp.N)) * 0.1))}
    out["int8_dot"] = (i8(rng.integers(-127, 127, (tp.M, tp.K))),
                       i8(rng.integers(-127, 127, (tp.TAPS, tp.K, tp.N))))
    out["int8_quantize_dot"] = (bf16(rng.normal(size=(tp.M, tp.K))),
                                i8(rng.integers(-127, 127, (tp.TAPS, tp.K, tp.N))),
                                np.full((1, 1), 0.031, np.float32))
    return out


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_probe_plain_matches_jax_body(variant):
    jp = _jax_probe()
    assert (jp.M, jp.K, jp.N, jp.TAPS, jp.REPS) == (tp.M, tp.K, tp.N, tp.TAPS, tp.REPS)
    body = {"bf16_dot": jp.kernel_bf16, "int8_dot": jp.kernel_int8,
            "int8_quantize_dot": jp.kernel_int8_quantize}[variant]
    args = _original_inputs()[variant]
    want = np.zeros((tp.M, tp.N), jnp.bfloat16)
    body(*args, want)
    want = want.astype(np.float32)
    targs = [_torch(a) for a in args]
    if variant == "int8_quantize_dot":
        targs[2] = targs[2].reshape(1)
    got = tp.probe(variant, *targs)
    assert got.dtype == torch.bfloat16 and got.shape == (tp.M, tp.N)
    got = got.float().numpy()
    if variant == "bf16_dot":
        diff = np.abs(got - want)
        assert diff.max() <= BF16_TOL[0] * np.abs(want).max()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_TOL[1]
    else:
        np.testing.assert_array_equal(got, want)


def test_probe_inputs_are_the_originals():
    """The entry point draws the original's integers and scale; its bf16 draws
    round through fp32 first, which moves at most one bf16 ulp."""
    want = _original_inputs()
    got = tp.make_inputs("cpu")
    for variant in ("int8_dot", "int8_quantize_dot"):
        np.testing.assert_array_equal(got[variant][1].numpy(), want[variant][1])
    np.testing.assert_array_equal(got["int8_dot"][0].numpy(), want["int8_dot"][0])
    assert float(got["int8_quantize_dot"][2]) == float(want["int8_quantize_dot"][2][0, 0])
    for variant in ("bf16_dot", "int8_quantize_dot"):
        ref = want[variant][0].astype(np.float32)
        np.testing.assert_allclose(got[variant][0].float().numpy(), ref, rtol=2.0**-7)


def test_probe_entry_point_on_the_cpu(capsys):
    """`--device cpu` runs the plain versions and prints one JSON line per
    variant with the original's keys, labelled with the device; nothing is
    launched."""
    before = dict(tp.LAUNCHES)
    tp.main(["--device", "cpu", "--reps", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in lines] == list(tp.VARIANTS)
    for r in lines:
        assert r["device"] == "cpu" and r["us_per_call"] > 0
        assert r["effective_tops"] == pytest.approx(tp.ops_per_call() / r["us_per_call"] / 1e6)
    assert tp.LAUNCHES == before


def test_probe_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port: the card, unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.make_inputs()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "kidney_diffusion_tpu_torch.tools.probe_int8"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "device='cpu'" in r.stderr
    assert "us_per_call" not in r.stdout


def test_probe_wrapper_refuses_other_devices():
    x = torch.empty((64, 16), dtype=torch.int8, device="meta")
    w = torch.empty((1, 16, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tp.probe("int8_dot", x, w)
    with pytest.raises(ValueError):
        tp.probe_plain("fp8_dot", x, w)
