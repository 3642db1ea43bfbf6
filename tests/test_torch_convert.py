"""The port's checkpoint loading (``io/convert.py``, the encoders' ``convert_*`` / ``load``,
``io/tokenizer.py``) against the JAX package's, on the CPU.

- Every converted state dict equals the JAX converter's tree taken through ``from_jax``
  (``state_dict_from_jax``), name for name and bit for bit, on the synthetic
  reference-layout checkpoints of ``tests/test_io.py`` and ``tests/helpers.py``. The one
  exception is the DAC's weight-norm fold, computed in fp32 in another summation order than
  XLA's: relative 1e-6 there (everything else in the DAC exact).
- The port's ``.safetensors`` reader against the safetensors package on every dtype it
  takes (``safetensors.numpy`` where numpy has the dtype, ``safetensors.torch`` for bf16 and
  fp8), plus the cases a hand-made file can hold: a space-padded header, ``__metadata__``,
  zero-size tensors and offsets not aligned to the dtype. ``.pth`` through ``torch.load``.
- The three encoders' ``load`` on the tiny checkpoints, SigLIP2's naflex patch embedding.
- The BPE tokenizer's ids against ``transformers.RobertaTokenizer`` (and the fast one, from
  a ``tokenizer.json``) on a vocabulary the test writes.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.io import convert as jconv
from foley_tpu.models import clap as jclap
from foley_tpu.models import siglip2 as jsig
from foley_tpu.models import synchformer as jsync
from foley_tpu_torch.configs import TINY, SynchformerConfig
from foley_tpu_torch.io import convert as tconv
from foley_tpu_torch.io.from_jax import state_dict_from_jax
from foley_tpu_torch.io.tokenizer import load_tokenizer
from foley_tpu_torch.models import clap as tclap
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.models import siglip2 as tsig
from foley_tpu_torch.models import synchformer as tsync
from foley_tpu_torch.models.dac_vae import DAC
from foley_tpu_torch.ops.nn import fold_weight_norm
from helpers import make_dac_state_dict, save_tiny_clap_checkpoint, save_tiny_siglip2_checkpoint
from test_io import _synthetic_mmdit_sd
from torch_helpers import one_torch_thread, save_bpe_tokenizer  # noqa: F401 (autouse)

FOLD_TOL = dict(rtol=1e-6, atol=1e-7)


def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _assert_state_equal(got, ref, close=()):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        if k in close:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), **FOLD_TOL, err_msg=k)
        else:
            assert torch.equal(got[k].to(ref[k].dtype), ref[k]), k


# ---------------------------------------------------------------------------------
# MMDiT and DAC
# ---------------------------------------------------------------------------------

def test_convert_mmdit_equals_jax_then_from_jax():
    sd = _synthetic_mmdit_sd(J_TINY.model)
    ref = state_dict_from_jax(jax.device_get(
        jconv.convert_mmdit_state_dict(dict(sd), J_TINY.model, strict=True)))
    src = _torch_sd(sd)
    got = tconv.convert_mmdit_state_dict(src, TINY.model, strict=True, consume=True)
    assert not src  # consumed
    _assert_state_equal(got, ref)
    model = tconv.module_from_state_dict(tmm.MMDiT, got, TINY.model, "cpu")
    assert torch.equal(model.single_blocks[0].linear_qkv.weight,
                       got["single_blocks.0.linear_qkv.weight"])


def test_hdk_to_khd_splits_like_the_reference():
    """The reordered fused qkv reproduces torch's (H D K) split (``hifi_foley.py:362``)."""
    h, d = 4, 8
    w, b = torch.randn(3 * h * d, h * d), torch.randn(3 * h * d)
    x = torch.randn(2, 5, h * d)
    ref = torch.nn.functional.linear(x, w, b).reshape(2, 5, h, d, 3)
    out = torch.nn.functional.linear(x, tconv._hdk_to_khd(w, h, d), tconv._hdk_to_khd(b, h, d))
    for i, part in enumerate(out.chunk(3, dim=-1)):
        assert torch.equal(part.reshape(2, 5, h, d), ref[..., i])


def test_convert_mmdit_reports_missing_keys():
    sd = _torch_sd(_synthetic_mmdit_sd(J_TINY.model))
    del sd["single_blocks.0.q_norm.weight"]
    with pytest.raises(KeyError, match="missing"):
        tconv.convert_mmdit_state_dict(sd, TINY.model, strict=True)
    state = tconv.convert_mmdit_state_dict(sd, TINY.model)  # logged only
    with pytest.raises(RuntimeError, match="Missing key"):
        tconv.module_from_state_dict(tmm.MMDiT, state, TINY.model, "cpu")


@pytest.mark.parametrize("style", ["old", "new", "plain"])
def test_convert_dac_equals_jax_then_from_jax(style):
    sd, _ = make_dac_state_dict(J_TINY.dac, seed=3)
    folded = {k[:-len(".weight_g")] for k in sd if k.endswith(".weight_g")}
    if style == "new":
        sd = {k.replace(".weight_g", ".parametrizations.weight.original0")
              .replace(".weight_v", ".parametrizations.weight.original1"): v
              for k, v in sd.items()}
    elif style == "plain":  # already folded: plain weights pass through exactly
        plain = {}
        for k, v in sd.items():
            if k.endswith(".weight_g"):
                base = k[:-len(".weight_g")]
                plain[base + ".weight"] = np.asarray(jconv.fold_weight_norm(
                    v, sd[base + ".weight_v"], dim=0))
            elif not k.endswith(".weight_v"):
                plain[k] = v
        sd, folded = plain, set()
    ref = state_dict_from_jax(jax.device_get(
        jconv.convert_dac_state_dict(dict(sd), J_TINY.dac, strict=True)))
    got = tconv.convert_dac_state_dict(_torch_sd(sd), TINY.dac, strict=True)
    port_names = {dst for src, dst, _ in tconv.dac_key_map(TINY.dac) if src in folded}
    _assert_state_equal(got, ref, close={n + ".weight" for n in port_names})
    tconv.module_from_state_dict(DAC, got, TINY.dac, "cpu")


def test_dac_reference_layout_round_trip(tmp_path):
    sd, _ = make_dac_state_dict(J_TINY.dac, seed=4)
    state = tconv.convert_dac_state_dict(_torch_sd(sd), TINY.dac, strict=True)
    ref_layout = tconv.dac_reference_state_dict(state, TINY.dac)
    tconv.save_safetensors(str(tmp_path / "dac.safetensors"), ref_layout)
    back = tconv.convert_dac_state_dict(
        tconv.load_safetensors(str(tmp_path / "dac.safetensors")), TINY.dac, strict=True)
    _assert_state_equal(back, state)


def test_fold_weight_norm_matches_torch_parametrization():
    conv = torch.nn.Conv1d(6, 10, 7)
    wn = torch.nn.utils.parametrizations.weight_norm(conv)
    g, v = wn.parametrizations.weight.original0, wn.parametrizations.weight.original1
    np.testing.assert_allclose(fold_weight_norm(g.detach(), v.detach()).numpy(),
                               wn.weight.detach().numpy(), **FOLD_TOL)
    ref = np.asarray(jconv.fold_weight_norm(g.detach().numpy(), v.detach().numpy(), dim=0))
    np.testing.assert_allclose(fold_weight_norm(g.detach(), v.detach()).numpy(), ref,
                               **FOLD_TOL)


def test_detect_precision_and_refuse_fp8():
    sd = {"a": torch.zeros(10, dtype=torch.bfloat16), "b": torch.zeros(4)}
    assert tconv.detect_ckpt_major_precision(sd) == "bf16"
    assert tconv.detect_ckpt_fp8(sd) is None
    tconv.refuse_fp8(sd, "test")
    for dtype, name in ((torch.float8_e4m3fn, "fp8_e4m3fn"), (torch.float8_e5m2, "fp8_e5m2")):
        sd["c"] = torch.zeros(2, dtype=dtype)
        assert tconv.detect_ckpt_fp8(sd) == name
        with pytest.raises(NotImplementedError, match="item 12"):
            tconv.refuse_fp8(sd, "test")


# ---------------------------------------------------------------------------------
# The .safetensors reader and .pth
# ---------------------------------------------------------------------------------

def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for dtype in (torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
                  torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
                  torch.float8_e4m3fn, torch.float8_e5m2):
        x = torch.randn(3, 5, generator=g) * 4
        out[str(dtype).split(".")[-1]] = x.to(dtype)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 7)
    return out


def _assert_tensors_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert torch.equal(got[k].view(torch.uint8) if got[k].element_size() == 1
                           and got[k].dtype != torch.bool else got[k],
                           ref[k].view(torch.uint8) if ref[k].element_size() == 1
                           and ref[k].dtype != torch.bool else ref[k]), k


def test_safetensors_reader_equals_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import load_file as torch_load
    from safetensors.torch import save_file as torch_save

    tensors = _tensors(0)
    torch_save(tensors, str(tmp_path / "t.safetensors"), metadata={"format": "pt"})
    _assert_tensors_equal(tconv.load_safetensors(str(tmp_path / "t.safetensors")),
                          torch_load(str(tmp_path / "t.safetensors")))
    numpyable = {k: v.numpy() for k, v in tensors.items()
                 if v.dtype not in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)}
    np_save(numpyable, str(tmp_path / "n.safetensors"))
    got = tconv.load_safetensors(str(tmp_path / "n.safetensors"))
    ref = np_load(str(tmp_path / "n.safetensors"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_safetensors_writer_misaligned_offsets_and_metadata(tmp_path):
    """The port's writer lays tensors out in name order with no alignment, so a 3-byte
    uint8 tensor puts every later tensor off its dtype's alignment; the package reads it."""
    from safetensors.torch import load_file as torch_load

    tensors = {"a_odd": torch.arange(3, dtype=torch.uint8), **_tensors(1)}
    path = str(tmp_path / "m.safetensors")
    tconv.save_safetensors(path, tensors, metadata={"note": "x"})
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        raw = f.read(n)
    assert n % 8 == 0
    header = json.loads(raw)
    assert header["__metadata__"] == {"note": "x"}
    assert any(v["data_offsets"][0] % 8 for k, v in header.items() if k != "__metadata__")
    _assert_tensors_equal(tconv.load_safetensors(path), tensors)
    _assert_tensors_equal(torch_load(path), tensors)
    # every tensor owns its bytes: the file can go while they live
    got = tconv.load_safetensors(path)
    os.remove(path)
    assert torch.equal(got["float32"], tensors["float32"])


def test_load_torch_state_dict_pth_and_directories(tmp_path):
    sd = {"w": torch.randn(4, 3), "b": torch.randn(4).to(torch.bfloat16)}
    torch.save(sd, tmp_path / "plain.pth")
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "wrapped.pth")
    for name in ("plain.pth", "wrapped.pth"):
        _assert_tensors_equal(tconv.load_torch_state_dict(str(tmp_path / name)), sd)
    shards = tmp_path / "sharded"
    shards.mkdir()
    tconv.save_safetensors(str(shards / "model-00001-of-00002.safetensors"), {"w": sd["w"]})
    tconv.save_safetensors(str(shards / "model-00002-of-00002.safetensors"), {"b": sd["b"]})
    _assert_tensors_equal(tconv.load_torch_state_dict(str(shards)), sd)
    with pytest.raises(FileNotFoundError):
        tconv.load_torch_state_dict(str(tmp_path / "sharded" / "nothing"))


# ---------------------------------------------------------------------------------
# The encoders
# ---------------------------------------------------------------------------------

def test_siglip2_load_equals_jax(tmp_path):
    ckpt = save_tiny_siglip2_checkpoint(str(tmp_path / "siglip2"), hidden=16, heads=2)
    ref_enc = jsig.load(ckpt)
    enc = tsig.load(ckpt, device="cpu")
    assert tuple(getattr(enc.cfg, f) for f in enc.cfg.__dataclass_fields__) == tuple(
        getattr(ref_enc.cfg, f) for f in enc.cfg.__dataclass_fields__)
    _assert_state_equal(enc.model.state_dict(),
                        state_dict_from_jax(jax.device_get(ref_enc.params)))


def test_siglip2_naflex_patch_embedding_equals_conv():
    """naflex's linear patch embedding [h, P*P*C] (features ordered (ph, pw, c)) converts
    to the same weights as the conv one it flattens, and as the JAX converter's."""
    cfg = tsig.SiglipVisionConfig.tiny()
    g = torch.Generator().manual_seed(2)
    h, p, c = cfg.hidden_size, cfg.patch_size, cfg.num_channels
    sd = {"embeddings.patch_embedding.weight": torch.randn(h, c, p, p, generator=g),
          "embeddings.patch_embedding.bias": torch.randn(h, generator=g),
          "embeddings.position_embedding.weight": torch.randn(cfg.grid ** 2, h, generator=g)}
    for name, shape in (("post_layernorm", (h,)),):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = torch.randn(shape), torch.randn(shape)
    for i in range(cfg.num_hidden_layers):
        for n, (o, k) in (("layer_norm1", (h, None)), ("self_attn.q_proj", (h, h)),
                          ("self_attn.k_proj", (h, h)), ("self_attn.v_proj", (h, h)),
                          ("self_attn.out_proj", (h, h)), ("layer_norm2", (h, None)),
                          ("mlp.fc1", (cfg.intermediate_size, h)),
                          ("mlp.fc2", (h, cfg.intermediate_size))):
            sd[f"encoder.layers.{i}.{n}.weight"] = torch.randn(o, k) if k else torch.randn(o)
            sd[f"encoder.layers.{i}.{n}.bias"] = torch.randn(o)
    conv = tsig.convert_hf_state_dict(sd, cfg, prefix="")
    naflex = dict(sd)
    naflex["embeddings.patch_embedding.weight"] = sd["embeddings.patch_embedding.weight"] \
        .permute(0, 2, 3, 1).reshape(h, -1)
    got = tsig.convert_hf_state_dict(naflex, cfg, prefix="")
    assert torch.equal(got["patch_embedding.weight"], conv["patch_embedding.weight"])
    jcfg = jsig.SiglipVisionConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    ref = jsig.convert_hf_state_dict({k: v.numpy() for k, v in naflex.items()}, jcfg, prefix="")
    _assert_state_equal(got, state_dict_from_jax(jax.device_get(ref)))
    assert tsig._infer_config(naflex, "", "none") == tsig._infer_config(sd, "", "none")


def _synchformer_sd(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    d, hid = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    pre = "vfeat_extractor."
    sd = {pre + "patch_embed_3d.proj.weight": torch.randn(d, 3, cfg.temporal_patch_size,
                                                          cfg.patch_size, cfg.patch_size,
                                                          generator=g),
          pre + "patch_embed_3d.proj.bias": torch.randn(d, generator=g),
          pre + "cls_token": torch.randn(1, 1, d, generator=g),
          pre + "pos_embed": torch.randn(1, cfg.patches_per_frame + 1, d, generator=g),
          pre + "temp_embed": torch.randn(1, cfg.temporal_resolution, d, generator=g),
          "afeat_extractor.ignored.weight": torch.randn(3)}

    def lin(name, o, i):
        sd[name + ".weight"] = torch.randn(o, i, generator=g) if i else torch.randn(o, generator=g)
        sd[name + ".bias"] = torch.randn(o, generator=g)

    lin(pre + "norm", d, None)
    for b in range(cfg.depth):
        p = f"{pre}blocks.{b}."
        for n, o, i in (("norm1", d, None), ("attn.qkv", 3 * d, d), ("attn.proj", d, d),
                        ("norm3", d, None), ("timeattn.qkv", 3 * d, d),
                        ("timeattn.proj", d, d), ("norm2", d, None), ("mlp.fc1", hid, d),
                        ("mlp.fc2", d, hid)):
            lin(p + n, o, i)
    a = pre + "spatial_attn_agg."
    sd[a + "cls_token"] = torch.randn(1, 1, d, generator=g)
    sd[a + "self_attn.in_proj_weight"] = torch.randn(3 * d, d, generator=g)
    sd[a + "self_attn.in_proj_bias"] = torch.randn(3 * d, generator=g)
    for n, o, i in (("self_attn.out_proj", d, d), ("linear1", hid, d), ("linear2", d, hid),
                    ("norm1", d, None), ("norm2", d, None)):
        lin(a + n, o, i)
    return sd


def test_synchformer_load_equals_jax(tmp_path):
    fields = dict(img_size=32, patch_size=8, temporal_patch_size=2, num_frames=16,
                  embed_dim=16, depth=2, num_heads=2, mlp_ratio=2.0)
    cfg = SynchformerConfig(**fields)
    sd = _synchformer_sd(cfg, 5)
    path = str(tmp_path / "synchformer_state_dict.safetensors")
    tconv.save_safetensors(path, sd)
    enc = tsync.load(path, cfg, device="cpu")
    ref = jsync.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                   jsync.SynchformerConfig(**fields))
    _assert_state_equal(enc.model.state_dict(), state_dict_from_jax(jax.device_get(ref)))
    bf16 = tsync.load(path, cfg, device="cpu", dtype=torch.bfloat16)
    assert bf16.compute_dtype == torch.bfloat16 and bf16.model.pos_embed.dtype == torch.bfloat16


def test_clap_load_equals_jax_and_tokenizer(tmp_path):
    ckpt = save_tiny_clap_checkpoint(str(tmp_path / "clap"), hidden=16, heads=2,
                                     vocab_size=400)
    tok = save_bpe_tokenizer(str(tmp_path / "bpe"))
    ref = jclap.load(ckpt, tokenizer_path=tok)
    enc = tclap.load(ckpt, tokenizer_path=tok, device="cpu")
    assert tuple(getattr(enc.cfg, f) for f in enc.cfg.__dataclass_fields__) == tuple(
        getattr(ref.cfg, f) for f in enc.cfg.__dataclass_fields__)
    _assert_state_equal(enc.model.state_dict(), state_dict_from_jax(jax.device_get(ref.params)))
    prompts = ["noisy harsh", "glass shattering on ice while rain drums"]
    np.testing.assert_allclose(enc.encode(prompts).numpy(), np.asarray(ref.encode(prompts)),
                               atol=1e-5, rtol=1e-5)
    # the checkpoint's own tokenizer is a WordLevel one: not a byte-level BPE, refused
    with pytest.raises(ValueError, match="BPE"):
        tclap.load(ckpt, device="cpu")


# ---------------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------------

PROMPTS = ["glass shattering on ice", "the dog's bark isn't LOUD!!  ok", "café naïve 1234x",
           "rain\n\ttin   roof  ", "emoji 🎵 here", "", " leading space",
           "ün Ωmega 中文字 ٣٤", "we'll they've I'm you'd", "a" * 60]


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    return save_bpe_tokenizer(str(tmp_path_factory.mktemp("bpe")))


@pytest.mark.parametrize("max_length", [None, 8, 77])
def test_bpe_ids_equal_roberta(bpe_dir, max_length):
    from transformers import RobertaTokenizer

    ref_tok = RobertaTokenizer.from_pretrained(bpe_dir)
    tok = load_tokenizer(bpe_dir)
    for p in PROMPTS:
        assert tok.encode(p) == ref_tok.encode(p, add_special_tokens=False), p
    kw = dict(padding=True, truncation=max_length is not None, max_length=max_length,
              return_tensors="np")
    got, ref = tok(PROMPTS, **kw), ref_tok(PROMPTS, **kw)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], ref[k])


def test_bpe_tokenizer_json_equals_fast(bpe_dir, tmp_path):
    from transformers import RobertaTokenizerFast

    fast = RobertaTokenizerFast.from_pretrained(bpe_dir)
    fast.save_pretrained(str(tmp_path))
    os.remove(tmp_path / "vocab.json")  # the tokenizer.json route alone
    tok = load_tokenizer(str(tmp_path))
    got = tok(PROMPTS, padding=True, truncation=True, max_length=77, return_tensors="np")
    ref = fast(PROMPTS, padding=True, truncation=True, max_length=77, return_tensors="np")
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], ref[k])
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec["model"]["type"] = "WordPiece"
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="BPE"):
        load_tokenizer(str(tmp_path))
