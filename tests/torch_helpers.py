"""Shared by the port's CPU tests (``tests/test_torch_*.py``).

``one_torch_thread``: an autouse fixture a test module imports to run torch's CPU ops on one
thread. A parallel pytest run puts a worker on each of several cores, and torch's per-op
thread pools, each as wide as the machine, then spin against each other: six concurrent
runs of the long-form generation tests took 614 s with the default pools and 120 s on one
thread each.

``jax_tree_from_port``: JAX parameter trees holding the port's own random initialisation, for
the tests that hold the port against the JAX package on the same weights.

``jax.jit(init)`` compiles for 5-20 s on the CPU at the test configs; the port's ``init``
draws the same schemes (``tests/test_torch_mmdit.py::test_init_schemes_and_param_count``,
``tests/test_torch_dac.py::test_init_is_he_scaled``) in well under a second. The tree's
structure and shapes come from ``jax.eval_shape`` of the JAX ``init``, which traces it and
compiles nothing. ``jax_tree_from_port`` inverts ``io/from_jax.py::state_dict_from_jax``,
leaf by leaf: the tests still build the port's side from the tree through the bridge.
"""

import jax
import numpy as np
import pytest
import torch

from foley_tpu_torch.io.from_jax import _STACKED


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _key(entry) -> str:
    return str(entry.key if hasattr(entry, "key") else entry.idx)


def _leaf(state, path):
    name = path[-1]
    a = state[".".join(path[:-1] + ({"b": "bias", "w": "weight"}.get(name, name),))]
    if name == "w" and a.ndim == 2:
        return a.T  # [out, in] -> [in, out]
    if name == "w" and a.ndim == 3:  # conv [out, in, K], conv_t [in, out, K] -> [K, in, out]
        return a.transpose(2, 0, 1) if "conv_t" in path else a.transpose(2, 1, 0)
    return a


def jax_tree_from_port(module: torch.nn.Module, jax_init, *init_args):
    """The tree of ``jax_init(key, *init_args)`` (its structure and shapes) holding
    ``module``'s weights, as host numpy arrays."""
    state = {k: v.detach().cpu().float().numpy() for k, v in module.state_dict().items()}
    template = jax.eval_shape(lambda key: jax_init(key, *init_args), jax.random.PRNGKey(0))

    def fill(path, spec):
        path = tuple(_key(p) for p in path)
        if path[0] in _STACKED:
            a = np.stack([_leaf(state, (path[0], str(i)) + path[1:])
                          for i in range(spec.shape[0])])
        else:
            a = _leaf(state, path)
        assert a.shape == spec.shape, (path, a.shape, spec.shape)
        return np.ascontiguousarray(a, dtype=spec.dtype)

    return jax.tree_util.tree_map_with_path(fill, template)
