"""Helpers shared by the PyTorch port's parity tests (no tests of its own)."""

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny U-Nets and levels are thousands of small torch ops: on one
    intra-op thread each, parallel test workers do not oversubscribe the
    cores (each would otherwise spin one thread per core on every op). A
    speed setting: no tolerance depends on it. A test file imports it to
    make it autouse there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_flax_params(init, seed=0):
    """Random parameters with the names and shapes of a Flax init (taken
    with `jax.eval_shape`, so nothing runs): norm scales 1 + 0.1 N(0, 1),
    other vectors 0.1 N(0, 1), kernels N(0, 1/fan_in) like lecun-normal —
    zero-initialised layers such as the final conv get weights too, and
    activations stay O(1) through a deep net, so an fp32 atol is meaningful."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        z = rng.normal(size=leaf.shape)
        if leaf.ndim >= 2:
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        elif getattr(path[-1], "key", None) == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, jax.eval_shape(init))
