"""Shared by the port's CPU tests (``tests/test_torch_*.py``).

``one_torch_thread``: an autouse fixture a test module imports to run torch's CPU ops on one
thread. A parallel pytest run puts a worker on each of several cores, and torch's per-op
thread pools, each as wide as the machine, then spin against each other: six concurrent
runs of the long-form generation tests took 614 s with the default pools and 120 s on one
thread each.

``jax_native_library``: an autouse fixture a test module imports when it reaches the JAX
package's native audio library (``foley_tpu.io.native``, under its WAV reader and writer, the
CLI and the server): the library is built once for the module into a directory of its own,
and the JAX module pointed at it. The library in
``native/`` is git-ignored, so a fresh tree has none, and ``foley_tpu.io.native`` builds it
there with ``make`` on first use and remembers a failed load for the process. Built from six
pytest workers at once (``-n 6``, every worker collecting every module), one worker's
``ctypes`` load can read another's half-written file ("file too short"); that worker then
keeps the numpy route, and ``tests/test_native.py``, run there later, fails all six of its
tests. A port test that reaches the JAX library goes through this fixture instead, and
builds nothing in ``native/``.

``jax_tree_from_port``: JAX parameter trees holding the port's own random initialisation, for
the tests that hold the port against the JAX package on the same weights.

``jax.jit(init)`` compiles for 5-20 s on the CPU at the test configs; the port's ``init``
draws the same schemes (``tests/test_torch_mmdit.py::test_init_schemes_and_param_count``,
``tests/test_torch_dac.py::test_init_is_he_scaled``) in well under a second. The tree's
structure and shapes come from ``jax.eval_shape`` of the JAX ``init``, which traces it and
compiles nothing. ``jax_tree_from_port`` inverts ``io/from_jax.py::state_dict_from_jax``,
leaf by leaf: the tests still build the port's side from the tree through the bridge.
"""

import os
import subprocess

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


@pytest.fixture(scope="module", autouse=True)
def jax_native_library(tmp_path_factory):
    """``foley_tpu.io.native`` on a library built for the module with ``native/Makefile``'s
    flags (the numpy route when ``g++`` fails), restored after it; yields whether the C++
    route is taken."""
    from foley_tpu.io import native as jnative

    lib = str(tmp_path_factory.mktemp("jax_native") / "libaudioio.so")
    src = os.path.join(os.path.dirname(jnative._LIB_PATH), "audioio.cpp")
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-o", lib, src],
                       check=True, capture_output=True)
        built = True
    except (OSError, subprocess.CalledProcessError):
        built = False
    saved = jnative._LIB_PATH, jnative._lib, jnative._lib_checked
    # without a build, the numpy route: no make in native/
    jnative._LIB_PATH, jnative._lib, jnative._lib_checked = lib, None, not built
    try:
        yield jnative.native_available()
    finally:
        jnative._LIB_PATH, jnative._lib, jnative._lib_checked = saved


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


BPE_CORPUS = ("glass shattering footsteps on ice rain thunder noisy harsh a the clink "
              "crunchy metal water wind rain drums on a tin roof while heavy rain falls "
              "the dog's bark isn't loud 1234 5678 it's 2024 café naïve")


def save_bpe_tokenizer(dirpath: str, n_merges: int = 120) -> str:
    """A RoBERTa byte-level BPE tokenizer (``vocab.json``, ``merges.txt`` and the config
    ``transformers.AutoTokenizer`` reads) with merges learnt greedily from ``BPE_CORPUS``:
    ``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, ``<unk>`` 3, then the 256 byte symbols, then one
    token per merge."""
    import collections
    import os

    from transformers import RobertaTokenizer
    from transformers.models.roberta.tokenization_roberta import bytes_to_unicode

    from foley_tpu_torch.io.tokenizer import _pattern

    byte_map = bytes_to_unicode()
    words = collections.Counter(
        "".join(byte_map[b] for b in piece.encode("utf-8"))
        for piece in _pattern().findall(BPE_CORPUS))
    splits = {w: list(w) for w in words}
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in sorted(byte_map.values()):
        vocab[ch] = len(vocab)
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, parts in splits.items():
            for a, b in zip(parts, parts[1:]):
                pairs[a, b] += words[w]
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        for w, parts in splits.items():
            out, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            splits[w] = out
    os.makedirs(dirpath, exist_ok=True)
    import json

    with open(os.path.join(dirpath, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(dirpath, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    RobertaTokenizer(os.path.join(dirpath, "vocab.json"),
                     os.path.join(dirpath, "merges.txt")).save_pretrained(dirpath)
    return dirpath


def save_checkpoint_dir(root) -> None:
    """A reference-layout checkpoint directory at the TINY config under ``root`` (a
    ``pathlib.Path``), as a ``--model_path`` or ``load_model`` reads it: the denoiser of
    ``tests/test_io.py`` (every weight random and nonzero), the DAC, and a CLAP under
    ``clap/`` with a byte-level BPE tokenizer beside it, which both packages read."""
    import os

    from foley_tpu.configs import TINY
    from foley_tpu_torch.io.convert import save_safetensors
    from helpers import save_dac_checkpoint, save_tiny_clap_checkpoint
    from test_io import _synthetic_mmdit_sd

    save_safetensors(str(root / "hunyuanvideo_foley.safetensors"),
                     {k: torch.from_numpy(np.array(v))
                      for k, v in _synthetic_mmdit_sd(TINY.model).items()})
    save_dac_checkpoint(str(root / "vae_128d_48k.safetensors"), TINY.dac)
    save_tiny_clap_checkpoint(str(root / "clap"), hidden=TINY.model.condition_dim, heads=2,
                              vocab_size=400)
    os.remove(root / "clap" / "tokenizer.json")  # its WordLevel tokenizer: BPE's files instead
    save_bpe_tokenizer(str(root / "clap"))


def jax_latents(seed: int):
    """A stand-in for the port's ``prepare_latents`` that returns the JAX package's initial
    noise for ``seed`` (``jax.random`` and a ``torch.Generator`` draw other bits)."""
    from foley_tpu.sampling.denoise import prepare_latents

    def noise(gen, b, length, dim, dtype=torch.float32):
        return torch.from_numpy(np.array(prepare_latents(jax.random.PRNGKey(seed), b, length,
                                                         dim)))

    return noise
