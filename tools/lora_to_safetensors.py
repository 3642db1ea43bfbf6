"""Convert a LoRA adapter of the JAX package (orbax, ``foley_tpu/models/lora.py::save_lora``
or ``training/loop.py::export_lora``) into the PyTorch port's adapter format: a directory
holding ``lora.safetensors`` (the JAX tree's flat names, each factor in its JAX layout with
the stacked block axis first) and ``lora_meta.json`` (rank and recommended scale).

It runs where JAX and orbax are installed; the port reads its output with no JAX, orbax or
``safetensors`` package (``foley_tpu_torch/models/lora.py::load_lora``):

    python tools/lora_to_safetensors.py ADAPTER_DIR OUT_DIR
    python -m foley_tpu_torch.cli --model_path ckpts/ --lora OUT_DIR ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(adapter_dir: str, out_dir: str) -> dict:
    """Read ``adapter_dir`` through the JAX package and write the port's adapter to
    ``out_dir``; returns ``lora_meta.json``'s contents."""
    import jax

    from foley_tpu.models.lora import load_lora
    from foley_tpu_torch.io.from_jax import lora_from_jax
    from foley_tpu_torch.models.lora import save_lora

    tree, scale = load_lora(adapter_dir)
    adapter = lora_from_jax(jax.device_get(tree))
    rank = next(t.shape[-1] for name, t in sorted(adapter.items()) if name.endswith(".a"))
    meta_path = os.path.join(adapter_dir, "lora_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            rank = int(json.load(f).get("rank", rank))
    save_lora(out_dir, adapter, rank, scale)
    return {"rank": rank, "scale": scale, "tensors": len(adapter)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("adapter_dir", help="the JAX package's orbax adapter directory")
    p.add_argument("out_dir", help="the port's adapter directory to write")
    args = p.parse_args(argv)
    print(json.dumps(convert(args.adapter_dir, args.out_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
