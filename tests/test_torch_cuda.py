"""The port's CUDA kernels on the card (K1, fused qk-norm + RoPE attention; K2, flash
attention; K3, the chained GEMM sweep): each against its plain PyTorch version, and the
wrappers' dispatch; and the paths around them that only the card can show (launch counts,
long-form stream against batch, CLAP's fp32 under TF32-permitting precision). Every test
skips without a CUDA card (the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a machine with a card and
no JAX: ``python -m pytest tests/test_torch_cuda.py --noconftest -q``.

Tolerance, bf16 and fp16 atol 2e-2: each attention kernel's online softmax rounds the
unnormalised p to the 16-bit type and divides by the row sum only at the end, and it sums in
another order than the plain version. fp32 (K1's and K2's fp32 kernels, 3xTF32 on the
tensor cores): a relative L2 error of at most 1e-5 against the plain version in true fp32
(``true_fp32``); a single TF32 product would read about 1e-4.
K3 sums the same fp32 products in another order, and a flipped bf16 rounding
carries forward through the chain; tanh bounds its output by 1. Its relative L2 error is
held to 1e-2 block by block (``_assert_sweep_close`` says how the chain is held).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from foley_tpu_torch.configs import TINY, ClapTextConfig
from foley_tpu_torch.core.params import perturb_zero_leaves
from foley_tpu_torch.models import clap, dac_vae, mmdit, siglip2
from foley_tpu_torch.ops.kernels import flash_attention as FL
from foley_tpu_torch.ops.kernels import fused_attention as FA
from foley_tpu_torch.ops.kernels import gemm_sweep as GS
from foley_tpu_torch.ops.nn import true_fp32
from foley_tpu_torch.ops.rope import rope_table
from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio
from foley_tpu_torch.tools import probe_gemm

KERNEL_TOL = dict(atol=2e-2, rtol=0)
FP32_REL_TOL = 1e-5


def _assert_kernel_close(got, ref):
    """The dtype's bound: atol 2e-2 for bf16 and fp16, relative L2 1e-5 for fp32."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == torch.float32:
        rel = float((got - ref).norm() / ref.norm())
        assert rel <= FP32_REL_TOL, rel
    else:
        torch.testing.assert_close(got.float(), ref.float(), **KERNEL_TOL)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _operands(dev, b, lq, lk, h, d=128, seed=0, split=None, dtype=torch.bfloat16):
    """q, k, v (of ``dtype``) and the tables. ``split`` None: per-position random norm
    weights; an int: the joint blocks' [v_cond; audio] weights, one [D] row for the first
    ``split`` positions and another for the rest, different for q and k."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, lq, h, d, device=dev, generator=gen).to(dtype)
    k, v = (torch.randn(b, lk, h, d, device=dev, generator=gen).to(dtype) for _ in range(2))

    def weights(length):
        if split is None:
            return torch.empty(length, d, device=dev).uniform_(0.5, 1.5, generator=gen)
        rows = [torch.empty(d, device=dev).uniform_(0.5, 1.5, generator=gen).expand(n, d)
                for n in (min(split, length), max(length - split, 0))]
        return torch.cat(rows).contiguous()

    wq, wk = weights(lq), weights(lk)
    return (q, k, v, wq, wk, *rope_table(lq, d, device=dev), *rope_table(lk, d, device=dev))


def _misaligned(x):
    """``x`` copied to a view 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def _odd_rows(x):
    """``x`` copied to a view whose row stride is not a multiple of 16 bytes."""
    b, length, h, d = x.shape
    wide = torch.zeros(b, length, h * d + 4, dtype=x.dtype, device=x.device)
    view = wide[..., :h * d].unflatten(-1, (h, d))
    view.copy_(x)
    return view


@pytest.mark.parametrize("b,lq,lk,h,split", [
    (2, 290, 290, 12, None), (2, 250, 250, 12, None), (1, 1, 1, 2, None), (1, 63, 63, 2, None),
    (1, 65, 65, 2, None), (2, 37, 53, 3, None), (1, 65, 1, 2, None), (1, 1740, 1740, 2, None),
    (1, 64, 64, 2, None), (1, 127, 127, 2, None), (1, 128, 128, 2, None),
    (1, 129, 129, 2, None), (2, 290, 290, 12, 40), (2, 290, 290, 4, 37),
    (1, 1740, 1740, 2, 240)])
def test_kernel_matches_plain(dev, b, lq, lk, h, split):
    """Lengths on both sides of the 64-row tiles and the 5-stage ring (320 keys); ``split``:
    the joint blocks' two-stream weights, split at 40 and at 37 (not a multiple of 8)."""
    args = _operands(dev, b, lq, lk, h, split=split)
    got = FA.fused_qk_attention(*args)
    ref = FA.fused_qk_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), **KERNEL_TOL)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,h,split", [
    (2, 290, 290, 12, 40), (2, 250, 250, 12, None), (1, 1, 1, 2, None), (1, 63, 63, 2, None),
    (1, 65, 65, 2, None), (2, 37, 53, 3, None), (1, 65, 1, 2, None), (1, 129, 129, 2, None),
    (1, 1740, 1740, 2, 240)])
def test_kernel_matches_plain_in_fp16_and_fp32(dev, dtype, b, lq, lk, h, split):
    """The fp16 kernel (the bf16 one's template) and the fp32 one (``attention_f32.cu``);
    fp32 against the plain version in true fp32."""
    args = _operands(dev, b, lq, lk, h, split=split, dtype=dtype)
    with true_fp32():
        got = FA.fused_qk_attention(*args)
        ref = FA.fused_qk_attention_plain(*args)
    torch.cuda.synchronize()
    _assert_kernel_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_counts_launches_by_dtype(dev, dtype):
    args = _operands(dev, 1, 16, 16, 2, dtype=dtype)
    before = FA.fused_qk_attention.launches_by_dtype.get(dtype, 0)
    FA.fused_qk_attention(*args)
    assert FA.fused_qk_attention.launches_by_dtype[dtype] == before + 1


def test_kernel_reads_strided_views(dev):
    """q, k and v as views of one fused qkv projection, as the single blocks pass them."""
    b, length, h, d = 2, 70, 4, 128
    q, k, v, *tabs = _operands(dev, b, length, length, h, seed=1)
    qkv = torch.cat([q.flatten(2), k.flatten(2), v.flatten(2)], dim=-1)  # [B, L, 3*H*D]
    views = [u.unflatten(-1, (h, d)) for u in qkv.chunk(3, dim=-1)]
    assert not views[0].is_contiguous()
    got = FA.fused_qk_attention(*views, *tabs)
    torch.testing.assert_close(got.float(), FA.fused_qk_attention_plain(q, k, v, *tabs).float(),
                               **KERNEL_TOL)


def test_cuda_tensor_never_reaches_plain(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain path")

    monkeypatch.setattr(FA, "fused_qk_attention_plain", refuse)
    q, k, v, *tabs = _operands(dev, 1, 16, 16, 2, seed=2)
    before = FA.fused_qk_attention.launches
    FA.fused_qk_attention(q, k, v, *tabs)
    assert FA.fused_qk_attention.launches == before + 1
    with pytest.raises(TypeError):  # fp64 on the card raises; it does not fall back
        FA.fused_qk_attention(q.double(), k.double(), v.double(), *tabs)
    with pytest.raises(TypeError):  # nor do mixed types
        FA.fused_qk_attention(q, k.half(), v, *tabs)
    with pytest.raises(ValueError, match="256"):  # so does a head_dim no kernel takes: odd
        FA.fused_qk_attention(q[..., :47], k[..., :47], v[..., :47],
                              *(t[:, :47] for t in tabs))
    wide = _operands(dev, 1, 16, 16, 2, d=258, seed=2)  # or past 256
    with pytest.raises(ValueError, match="256"):
        FA.fused_qk_attention(*wide)
    for bad in (_misaligned, _odd_rows):  # and what a TMA tensor map cannot describe
        with pytest.raises(ValueError):
            FA.fused_qk_attention(bad(q), k, v, *tabs)
        with pytest.raises(ValueError):
            FA.fused_qk_attention(q, k, bad(v), *tabs)
    assert FA.fused_qk_attention.launches == before + 1


def test_generate_audio_on_card_launches_the_kernel(dev):
    """A small denoiser with 128-wide heads, end to end on the card: one launch per block
    and step, and the same audio for the same seed."""
    cfg = dataclasses.replace(TINY, model=dataclasses.replace(TINY.model, hidden_size=256))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = perturb_zero_leaves(mmdit.init(cfg.model, gen, device=dev, dtype=torch.bfloat16),
                                gen)
    dac = dac_vae.init(cfg.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    bundle = ModelBundle(model, dac, cfg)
    text = torch.zeros(1, 16, cfg.model.condition_dim)
    before = FA.fused_qk_attention.launches
    a = generate_audio(bundle, text, text, 1.0, num_inference_steps=3, seed=1)
    steps_blocks = 3 * (cfg.model.depth_triple_blocks + cfg.model.depth_single_blocks)
    assert FA.fused_qk_attention.launches - before == steps_blocks
    b = generate_audio(bundle, text, text, 1.0, num_inference_steps=3, seed=1)
    assert a.audio_batch.shape == (1, 1, cfg.dac.sample_rate)
    assert a.audio_batch.tobytes() == b.audio_batch.tobytes()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d", [18, 32, 48, 64, 80, 96, 160, 256])
@pytest.mark.parametrize("b,lq,lk,h,split", [
    (2, 66, 66, 2, 16), (2, 50, 50, 2, None), (1, 1, 1, 2, None), (1, 33, 31, 3, None),
    (1, 65, 65, 2, None), (1, 31, 65, 2, None), (1, 129, 129, 2, None), (1, 300, 300, 2, 40)])
def test_narrow_kernel_matches_plain(dev, dtype, d, b, lq, lk, h, split):
    """K1 at every head width but 128 (``fused_qk_attention_mma.cu``, which replaced the
    narrow kernel of heads of 32 and 64): widths that are not a multiple of 16 (padded in
    shared memory) or of 8 (loaded in 4-byte chunks), lengths on both sides of its 64-key
    tiles and 128-row blocks (ragged 1, 33, 65, 129), the joint blocks' two-stream weights;
    fp32 against the plain version in true fp32."""
    args = _operands(dev, b, lq, lk, h, d=d, split=split, dtype=dtype)
    before = FA.fused_qk_attention.launches_by_dtype.get(dtype, 0)
    with true_fp32():
        got = FA.fused_qk_attention(*args)
        ref = FA.fused_qk_attention_plain(*args)
    torch.cuda.synchronize()
    assert FA.fused_qk_attention.launches_by_dtype[dtype] == before + 1
    _assert_kernel_close(got, ref)


@pytest.mark.parametrize("d", [18, 64, 96])
def test_any_width_kernel_reads_strided_views(dev, d):
    """q, k and v as views of one fused qkv projection at widths other than 128: an 18-wide
    bf16 row is 36 bytes, loaded in 4-byte chunks."""
    b, length, h = 2, 70, 3
    q, k, v, *tabs = _operands(dev, b, length, length, h, d=d, seed=4)
    qkv = torch.cat([q.flatten(2), k.flatten(2), v.flatten(2)], dim=-1)
    views = [u.unflatten(-1, (h, d)) for u in qkv.chunk(3, dim=-1)]
    assert FA.kernel_route(*views) == (True, (d, FA.chunk_bytes(*views)))
    got = FA.fused_qk_attention(*views, *tabs)
    torch.testing.assert_close(got.float(), FA.fused_qk_attention_plain(q, k, v, *tabs).float(),
                               **KERNEL_TOL)


def test_narrow_heads_launch_the_narrow_kernel_on_card(dev):
    """TINY's 32-wide heads on the card: K1's kernel for widths other than 128
    (``fused_qk_attention_mma.cu``) in every block, one launch a block, and the CPU's
    velocity in fp32."""
    cfg = TINY.model
    model = mmdit.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    perturb_zero_leaves(model, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    clip_len, sync_len = TINY.t2a_lengths(1.0)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(1, TINY.latent_length(1.0), cfg.audio_vae_latent_dim)),
        np.asarray([500.0]), rng.normal(size=(1, cfg.text_length, cfg.condition_dim)),
        rng.normal(size=(1, clip_len, cfg.clip_dim)),
        rng.normal(size=(1, sync_len, cfg.sync_feat_dim)))]
    with torch.no_grad(), true_fp32():
        ref = model(*args)
        model.to(dev)
        before = FA.fused_qk_attention.launches
        got = model(*(a.to(dev) for a in args))
    assert FA.fused_qk_attention.launches - before == (cfg.depth_triple_blocks
                                                       + cfg.depth_single_blocks)
    assert float((got.cpu() - ref).norm() / ref.norm()) <= FP32_REL_TOL


def test_long_stream_equals_batch_on_card(dev):
    """Windowed long-form on the card: one launch per block, step and window, and the
    stream's chunks concatenate to the batch path's audio within 1.5/32767 (both run the
    same segment decodes, so cuDNN sees the same shapes)."""
    from foley_tpu_torch.pipeline.longform import generate_audio_long, generate_audio_long_stream

    cfg = dataclasses.replace(TINY, model=dataclasses.replace(TINY.model, hidden_size=256))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = perturb_zero_leaves(mmdit.init(cfg.model, gen, device=dev, dtype=torch.bfloat16),
                                gen)
    dac = dac_vae.init(cfg.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    bundle = ModelBundle(model, dac, cfg)
    text = torch.zeros(1, 16, cfg.model.condition_dim)
    kw = dict(window_s=2.0, overlap_s=0.5, num_inference_steps=2, seed=3)
    before = FA.fused_qk_attention.launches
    batch = generate_audio_long(bundle, text, text, 3.0, **kw)
    blocks = cfg.model.depth_triple_blocks + cfg.model.depth_single_blocks
    assert FA.fused_qk_attention.launches - before == 2 * 2 * blocks  # windows x steps
    chunks = list(generate_audio_long_stream(bundle, text, text, 3.0, **kw))
    streamed = np.concatenate([c.audio for c in chunks], axis=-1)
    assert streamed.shape == batch.audio_batch.shape == (1, 1, 3 * cfg.dac.sample_rate)
    assert np.abs(streamed - batch.audio_batch).max() <= 1.5 / 32767.0


def test_clap_on_card_is_true_fp32(dev, monkeypatch):
    """CLAP at its real width on the card agrees with the CPU within 1e-5 relative L2, with
    and without ``torch.set_float32_matmul_precision("high")`` (fp32 reads about 7e-7 on an
    H100). The control, ``true_fp32`` bypassed under ``"high"`` (TF32 matmuls, about 4e-4),
    breaks the bound."""
    cfg = ClapTextConfig()
    model = clap.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(2, cfg.vocab_size, (2, 77), generator=gen)
    mask = torch.ones(2, 77, dtype=torch.long)
    mask[1, 20:] = 0
    ids[1, 20:] = cfg.pad_token_id
    ref = clap.apply(model, ids, mask)
    model.to(dev)
    saved = torch.get_float32_matmul_precision()
    try:
        for precision in ("highest", "high"):
            torch.set_float32_matmul_precision(precision)
            got = clap.apply(model, ids.to(dev), mask.to(dev)).cpu()
            rel = float((got - ref).norm() / ref.norm())
            assert rel < 1e-5, (precision, rel)
        monkeypatch.setattr(clap, "true_fp32", contextlib.nullcontext)
        got = clap.apply(model, ids.to(dev), mask.to(dev)).cpu()
        assert float((got - ref).norm() / ref.norm()) > 1e-5  # TF32 breaks the bound
    finally:
        torch.set_float32_matmul_precision(saved)


# ---- K2: flash attention ----

def _qkv(dev, b, lq, lk, h, d, seed=0, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, lq, h, d, device=dev, generator=gen).to(dtype)
    k, v = (torch.randn(b, lk, h, d, device=dev, generator=gen).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,lq,lk,h,d", [(4, 1024, 1024, 12, 64), (1, 1, 1, 2, 64),
                                         (1, 63, 63, 2, 64), (1, 65, 65, 2, 64),
                                         (1, 250, 77, 2, 128), (2, 37, 53, 3, 64),
                                         (1, 65, 1, 2, 128), (2, 290, 290, 12, 128),
                                         (2, 1024, 1024, 4, 128), (1, 1, 1, 2, 128),
                                         (1, 63, 63, 2, 128), (1, 65, 65, 2, 128),
                                         (1, 250, 77, 2, 64), (1, 65, 1, 2, 64),
                                         (1, 129, 300, 2, 64)])
def test_flash_kernel_matches_plain(dev, b, lq, lk, h, d):
    q, k, v = _qkv(dev, b, lq, lk, h, d)
    got = FL.flash_attention(q, k, v)
    ref = FL.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), **KERNEL_TOL)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,h,d", [(4, 1024, 1024, 12, 64), (1, 1, 1, 2, 64),
                                         (1, 65, 65, 2, 64), (1, 250, 77, 2, 128),
                                         (2, 37, 53, 3, 64), (1, 65, 1, 2, 128),
                                         (2, 290, 290, 12, 128), (1, 129, 300, 2, 64)])
def test_flash_kernel_matches_plain_in_fp16_and_fp32(dev, dtype, b, lq, lk, h, d):
    q, k, v = _qkv(dev, b, lq, lk, h, d, dtype=dtype)
    with true_fp32():
        got = FL.flash_attention(q, k, v)
        ref = FL.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _assert_kernel_close(got, ref)


def test_flash_kernel_reads_strided_views(dev):
    """q, k and v as head views of one [B, L, 3*H*D] projection."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(3, 100, 3 * 768, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (12, 64)) for t in x.chunk(3, dim=-1))
    assert not q.is_contiguous()
    torch.testing.assert_close(FL.flash_attention(q, k, v).float(),
                               FL.flash_attention_plain(q, k, v).float(), **KERNEL_TOL)


def test_flash_cuda_tensor_never_reaches_plain(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain path")

    monkeypatch.setattr(FL, "flash_attention_plain", refuse)
    q, k, v = _qkv(dev, 1, 16, 16, 2, 64, seed=4)
    before = FL.flash_attention.launches
    FL.flash_attention(q, k, v)
    assert FL.flash_attention.launches == before + 1
    with pytest.raises(TypeError):  # fp64 raises on the card; no fallback
        FL.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):  # so does a head_dim other than 64 or 128
        FL.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    for bad in (_misaligned, _odd_rows):  # and what a TMA tensor map cannot describe
        with pytest.raises(ValueError):
            FL.flash_attention(bad(q), k, v)
        with pytest.raises(ValueError):
            FL.flash_attention(q, bad(k), v)
    assert FL.flash_attention.launches == before + 1


def test_siglip2_on_card_launches_the_kernel_per_layer(dev):
    cfg = siglip2.SiglipVisionConfig(hidden_size=128, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=2, image_size=32, patch_size=8)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = perturb_zero_leaves(siglip2.init(cfg, gen, device=dev, dtype=torch.bfloat16), gen)
    enc = siglip2.Siglip2Encoder(model, compute_dtype=torch.bfloat16)
    frames = torch.rand(5, 40, 40, 3, generator=torch.Generator().manual_seed(1)).numpy()
    before = FL.flash_attention.launches
    feats = enc.encode(frames)
    assert FL.flash_attention.launches - before == cfg.num_hidden_layers
    assert feats.shape == (1, 5, 128) and bool(torch.isfinite(feats).all())
    cpu = siglip2.Siglip2Encoder(model.float().cpu()).encode(frames)  # the plain route
    torch.testing.assert_close(feats.cpu(), cpu, atol=0.1, rtol=0.05)  # bf16 vs fp32


# ---- K3: the chained GEMM sweep ----

def _sweep_inputs(dev, m, k, n, blocks, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn(blocks, k, n, device=dev, generator=gen) / k ** 0.5).to(torch.bfloat16)
    return x, w


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _assert_sweep_close(x, w, got, wk=None):
    """K3's checks, as chip_smoke.py makes them: the chain's max abs error (2e-2); each
    block's relative L2 error on the plain version's activations (1e-2); and the chain's
    relative L2 error within 1e-2 or twice the plain chain's own drift from fp64 sums, since
    every block rounds to bf16 and two right chains drift apart as they go."""
    wk = w if wk is None else wk
    ref = GS.gemm_sweep_plain(x, w)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), **KERNEL_TOL)
    xb = x
    for b in range(w.shape[0]):
        nxt = GS.gemm_sweep_plain(xb, w[b:b + 1])
        assert _rel(GS.gemm_sweep(xb, wk[b:b + 1]), nxt) <= 1e-2
        xb = nxt
    drift = _rel(GS.gemm_sweep_plain(x, w, torch.float64), ref)
    assert _rel(got, ref) <= max(1e-2, 2 * drift)


@pytest.mark.parametrize("m,k,n,blocks", [(784, 1536, 4608, 36), (1, 1536, 4608, 2),
                                          (65, 1536, 4608, 2), (192, 192, 576, 3),
                                          (40, 64, 192, 3), (130, 64, 64, 1), (300, 128, 136, 4),
                                          (4096, 1536, 1536, 3), (784, 1536, 4608, 1)]
                         + [(m, k, 2 * k, 3) for m in (784, 1) for k in (64, 128, 192, 256, 320)])
def test_gemm_sweep_matches_plain(dev, m, k, n, blocks):
    """M 4096: every block walks several tiles (64 x 8 tiles of 64 x 192 over 132 SMs). K 64
    to 320 at the probe's M and at one row: the last column tile 64, 128 or 192 columns wide,
    and a cluster's second column tile past K (K 64, 128, 192)."""
    x, w = _sweep_inputs(dev, m, k, n, blocks)
    got = GS.gemm_sweep(x, w)
    torch.cuda.synchronize()
    _assert_sweep_close(x, w, got)


def test_gemm_sweep_repeats_bit_for_bit(dev):
    """Ten sweeps back to back on one stream, and twenty replays of a captured sweep, all
    equal to the first eager sweep bit for bit: the flags are reset before every sweep and
    carry the chain without a race."""
    x, w = _sweep_inputs(dev, 784, 1536, 4608, 36, seed=6)
    first = GS.gemm_sweep(x, w)
    outs = [GS.gemm_sweep(x, w) for _ in range(10)]
    assert all(torch.equal(o, first) for o in outs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch.cuda.graph asks
        GS.gemm_sweep(x, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = GS.gemm_sweep.launches
    with torch.cuda.graph(graph):
        out = GS.gemm_sweep(x, w)
    assert GS.gemm_sweep.launches == before + 1
    for _ in range(20):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    _assert_sweep_close(x, w, first)


def test_gemm_sweep_reads_strided_views(dev):
    """w as the head view w[:, :, :K] (the kernel reads it through its strides), and x as
    the first K columns of a wider activation."""
    x, w = _sweep_inputs(dev, 100, 256, 768, 3, seed=1)
    wide = torch.cat([x, x], dim=1)[:, :256]
    head = w[:, :, :256]
    assert not head.is_contiguous() and not wide.is_contiguous()
    _assert_sweep_close(x, w, GS.gemm_sweep(wide, head), wk=head)
    assert torch.equal(GS.gemm_sweep(x, head), GS.gemm_sweep(x, head.contiguous()))


def test_gemm_sweep_cuda_tensor_never_reaches_plain(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain path or a library GEMM")

    x, w = _sweep_inputs(dev, 64, 128, 384, 5, seed=2)
    monkeypatch.setattr(GS, "gemm_sweep_plain", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    before = GS.gemm_sweep.launches
    got = GS.gemm_sweep(x, w)
    assert GS.gemm_sweep.launches == before + 1  # one launch a sweep
    for dtype in (torch.float32, torch.float16):  # the card takes bf16 only; no fallback
        with pytest.raises(TypeError):
            GS.gemm_sweep(x.to(dtype), w.to(dtype))
    with pytest.raises(ValueError):  # so does a K that is not a multiple of the k-step
        GS.gemm_sweep(x[:, :48], w[:, :48, :48])
    assert GS.gemm_sweep.launches == before + 1
    monkeypatch.undo()
    _assert_sweep_close(x, w, got)


def test_probe_measures_on_the_card(dev, monkeypatch):
    for name, value in dict(M=256, K=512, N=1536, BLOCKS=4, ITERS=3, PLAIN_ITERS=1).items():
        monkeypatch.setattr(probe_gemm, name, value)
    rec = probe_gemm.measure(dev)
    assert rec["device"] == torch.cuda.get_device_name(dev)
    assert rec["launches_per_sweep"] == 1
    assert rec["max_abs_err"] <= 2e-2
    assert rec["rel_l2_err"] <= max(1e-2, 2 * rec["plain_fp64_rel_l2"])
    for v in ("kernel", "library_sweep", "library_sweep_full", "plain"):
        assert rec[v]["ms_per_sweep"] > 0 and rec[v]["graph_ms_per_sweep"] > 0
    # wrapper calls: the checked sweep, a warm-up, three timed, the graph's warm-up and capture
    assert rec["kernel_sweeps"] == 1 + 1 + 3 + 2


@pytest.mark.parametrize("precision", ["bf16", "fp16", "fp32"])
def test_every_precision_runs_on_card(dev, precision):
    """A small denoiser with 128-wide heads and SigLIP2 in each precision the nodes offer:
    K1 and K2 launch in that type (no fallback to the plain attention), and the fp32 runs
    agree with the same modules on the CPU within 1e-5 relative L2."""
    from foley_tpu_torch.api.nodes import HunyuanModelLoader, resolve_dtype

    dtype = resolve_dtype(precision)
    cfg = dataclasses.replace(TINY, model=dataclasses.replace(TINY.model, hidden_size=256))
    fm = HunyuanModelLoader.init_random("tiny", precision, 0, perturb=True, device=dev)
    model = perturb_zero_leaves(mmdit.init(cfg.model, torch.Generator(device=dev).manual_seed(0),
                                           device=dev, dtype=dtype),
                                torch.Generator(device=dev).manual_seed(1))
    assert fm["dtype"] == dtype and fm["params"].final_layer.linear.weight.device.type == "cuda"
    gen = torch.Generator().manual_seed(2)
    args = (torch.randn(2, 50, cfg.model.audio_vae_latent_dim, generator=gen),
            torch.full((2,), 500.0), torch.randn(2, 77, cfg.model.condition_dim, generator=gen),
            torch.randn(2, 8, cfg.model.clip_dim, generator=gen),
            torch.randn(2, 24, cfg.model.sync_feat_dim, generator=gen))
    before = FA.fused_qk_attention.launches_by_dtype.get(dtype, 0)
    with torch.no_grad():
        got = model(*(a.to(dev, dtype) if a.is_floating_point() and a.ndim > 1 else a.to(dev)
                      for a in args)).float().cpu()
    blocks = cfg.model.depth_triple_blocks + cfg.model.depth_single_blocks
    assert FA.fused_qk_attention.launches_by_dtype[dtype] - before == blocks
    assert bool(torch.isfinite(got).all())
    enc = siglip2.init_random(0, 128, device=dev, dtype=dtype)  # 2 heads of 64
    before = FL.flash_attention.launches_by_dtype.get(dtype, 0)
    feats = enc.encode(torch.rand(3, 40, 40, 3, generator=gen).numpy())
    assert FL.flash_attention.launches_by_dtype[dtype] - before == enc.cfg.num_hidden_layers
    assert bool(torch.isfinite(feats).all())
    if dtype == torch.float32:
        model.cpu()
        with torch.no_grad():
            ref = model(*(a.float() for a in args)).float()
        assert float((got - ref).norm() / ref.norm()) <= FP32_REL_TOL


def test_http_round_trip_on_card_launches_the_kernel(dev):
    """One request through the HTTP server at a small width with 128-wide heads: the
    handler thread launches K1 once per block and step, and the WAV holds the request's
    samples."""
    import io
    import json
    import threading
    import urllib.request
    import wave

    from foley_tpu_torch.serving.server import FoleyService, create_server

    cfg = dataclasses.replace(TINY, model=dataclasses.replace(TINY.model, hidden_size=256))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = perturb_zero_leaves(mmdit.init(cfg.model, gen, device=dev, dtype=torch.bfloat16),
                                gen)
    dac = dac_vae.init(cfg.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    service = FoleyService(ModelBundle(model, dac, cfg), durations=(1.0,), text_buckets=(16,),
                           default_steps=3)
    service.warmup()
    srv = create_server(service, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        before = FA.fused_qk_attention.launches
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/generate",
            data=json.dumps({"prompt": "x", "duration": 1.0, "seed": 2}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            data = r.read()
    finally:
        srv.shutdown()
    blocks = cfg.model.depth_triple_blocks + cfg.model.depth_single_blocks
    assert FA.fused_qk_attention.launches - before == 3 * blocks
    with wave.open(io.BytesIO(data)) as f:
        assert (f.getframerate(), f.getnframes()) == (48000, 48000)
        pcm = np.frombuffer(f.readframes(48000), "<i2")
    assert np.abs(pcm).max() > 0


# ---------------------------------------------------------------------------------
# The memory modes: int8_dynamic's integer product and block swap on the card
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 2, 17, 250])
def test_int8_dynamic_dense_on_card_equals_the_cpu(dev, rows):
    """``torch._int_mm`` on the card (rows padded past 16) gives the CPU's exact int32 sums,
    and the fp32 epilogue the same bits."""
    from foley_tpu_torch.ops.nn import QuantizedWeight, dense, int_mm, quantize_act

    gen = torch.Generator().manual_seed(rows)
    w = torch.randint(-127, 128, (4608, 1536), generator=gen, dtype=torch.int8)
    scale = torch.rand(4608, 1, generator=gen) * 1e-3 + 1e-4
    x = torch.randn(rows, 1536, generator=gen).to(torch.bfloat16)
    bias = torch.randn(4608, generator=gen).to(torch.bfloat16)
    xq, _ = quantize_act(x)
    assert torch.equal(int_mm(xq.to(dev), w.to(dev)).cpu(), int_mm(xq, w))
    qw = QuantizedWeight("int8_dyn", w, scale)
    got = dense(x.to(dev), QuantizedWeight("int8_dyn", w.to(dev), scale.to(dev)), bias.to(dev))
    assert torch.equal(got.cpu(), dense(x, qw, bias))


def _swap_model(dev):
    cfg = dataclasses.replace(TINY.model, hidden_size=256)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, perturb_zero_leaves(mmdit.init(cfg, gen, device=dev, dtype=torch.bfloat16), gen)


def _swap_inputs(dev, cfg):
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen).to(torch.bfloat16)  # noqa
    return (rnd(2, 20, cfg.audio_vae_latent_dim), torch.full((2,), 500.0, device=dev),
            rnd(2, 8, cfg.condition_dim), rnd(2, 4, cfg.clip_dim), rnd(2, 8, cfg.sync_feat_dim))


@pytest.mark.parametrize("n", [3, 6])
@pytest.mark.parametrize("prefetch_blocks", [0, 1])
def test_swapped_forward_equals_resident_on_card(dev, n, prefetch_blocks):
    """The swapped blocks in page-locked host memory, copied on the side stream into the
    window's slots: the velocity equals the resident one bit for bit, K1 still launches once
    a block, and the card holds at most the window's swapped blocks."""
    from foley_tpu_torch.parallel import offload

    cfg, model = _swap_model(dev)
    args = _swap_inputs(dev, cfg)
    with torch.no_grad():
        resident = model(*args)
        offload.offload_block_suffix(model, n)
        for family in offload.FAMILIES:
            for i in offload.swapped_blocks(model, family):
                tensors = offload.block_tensors(getattr(model, family)[i]).values()
                assert all(t.device.type == "cpu" and t.is_pinned() for t in tensors)
        before = FA.fused_qk_attention.launches
        got = model(*args, offload_prefetch=prefetch_blocks + 1)
        torch.cuda.synchronize()
    assert FA.fused_qk_attention.launches - before == (cfg.depth_triple_blocks
                                                       + cfg.depth_single_blocks)
    assert torch.equal(got, resident)
    for fam in model.block_swap.families.values():
        assert len(fam.slots) <= prefetch_blocks + 1
        assert all(t.device.type == "cuda" for slot in fam.slots for t in slot.values())


def test_swapped_block_k1_tables_are_on_the_card(dev):
    from foley_tpu_torch.parallel import offload

    cfg, model = _swap_model(dev)
    offload.offload_block_suffix(model, 6)
    assert model.triple_blocks[1].audio_self_q_norm.weight.device.type == "cpu"
    tables = model.attention_tables(20, 4, 8, dev)
    for tab in tables.triple_norms + tables.single_norms:
        assert all(t.device.type == "cuda" for t in tab)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_refuse_operands_that_require_a_gradient(dev, dtype):
    """K1 and K2 have no backward: under autograd, operands that require a gradient raise
    (a launch would return a tensor without ``grad_fn`` and drop every gradient), naming the
    plain route; under ``no_grad`` the same call launches."""
    q, k, v, *tabs = _operands(dev, 1, 16, 16, 2, dtype=dtype, seed=5)
    before = (FA.fused_qk_attention.launches, FL.flash_attention.launches)
    for leaf in (q, tabs[0]):  # an activation, or a norm table (a trained weight)
        leaf.requires_grad_(True)
        with pytest.raises(RuntimeError, match='no backward.*attn_impl="xla"'):
            FA.fused_qk_attention(q, k, v, *tabs)
        leaf.requires_grad_(False)
    v.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*sdpa"):
        FL.flash_attention(q, k, v)
    assert (FA.fused_qk_attention.launches, FL.flash_attention.launches) == before
    with torch.no_grad():
        FA.fused_qk_attention(q, k, v, *tabs)
        FL.flash_attention(q, k, v)
    assert (FA.fused_qk_attention.launches, FL.flash_attention.launches) == (
        before[0] + 1, before[1] + 1)


def test_lora_train_step_on_card_launches_no_kernel(dev):
    """A LoRA train step on the card at TINY depth with K1's head size (hidden 256, heads of
    128): the plain attention route, so no K1 launch, finite factor gradients, the base
    unchanged; then the default route under ``no_grad`` launches K1 once a block."""
    from foley_tpu_torch.models.lora import init_lora
    from foley_tpu_torch.training import train

    cfg, model = _swap_model(dev)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    args = _swap_inputs(dev, cfg)
    batch = dict(zip(("latents", "cond", "clip_feat", "sync_feat"), (args[0], *args[2:])))
    init_state, step = train.make_lora_train_step(model)
    state = init_state(init_lora(model, torch.Generator(device=dev).manual_seed(2), rank=4))
    before = FA.fused_qk_attention.launches
    state, loss = step(state, batch, torch.Generator(device=dev).manual_seed(3))
    assert FA.fused_qk_attention.launches == before and bool(torch.isfinite(loss))
    assert any(bool(v.any()) for k, v in state.lora.items() if k.endswith(".b"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, base[k]), k
    with torch.no_grad():
        model(*args)
    assert FA.fused_qk_attention.launches == before + cfg.depth_triple_blocks + (
        cfg.depth_single_blocks)


def test_pil_resize_on_the_card_equals_the_cpu(dev):
    """Pillow's 8-bit resampler (``ops/pil_resize.py``) gives the same bytes on the card as
    on the CPU (where ``tests/test_torch_pil_resize.py`` holds it to Pillow), both filters,
    down and up, at the encoders' sizes among others."""
    from foley_tpu_torch.ops import pil_resize

    rng = np.random.default_rng(0)
    for h, w, oh, ow in ((720, 1280, 224, 398), (720, 1280, 512, 512), (48, 48, 512, 512),
                         (37, 23, 11, 50), (1, 60, 9, 1)):
        frames = torch.from_numpy(rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8))
        for kind in (pil_resize.BICUBIC, pil_resize.BILINEAR):
            got = pil_resize.resize(frames.to(dev), (ow, oh), kind)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), pil_resize.resize(frames, (ow, oh), kind)), (h, w, kind)


def test_tiny_dac_gan_step_on_the_card_matches_the_cpu(dev):
    """One discriminator + generator step (``training/dac_train.py``) at TINY's codec on the
    card against the same step on the CPU, the posterior noise injected: every loss part
    within 1e-5 relative (``tests/test_torch_dac_train.py``'s bound against JAX) and both
    first moments (0.2 x the gradients) within 2e-2 relative L2 per leaf: the card's cuDNN
    and cuFFT sum in other orders than the CPU's, and a leaf whose gradient is small reads
    its rounding (the MRD's top band, 0.75-1.0 of Nyquist, sees almost no energy of a 220 Hz
    tone: its first conv's weights read 4.5e-3 on the H100; a Snake alpha of two elements
    2.5e-4). The init's encoder and decoder weights are scaled (x0.65, x0.7) as there, so the
    latents stay O(1)."""
    import copy

    from foley_tpu_torch.models import dac_discriminator, dac_vae
    from foley_tpu_torch.training import dac_train

    cfg = TINY.dac
    gen = dac_vae.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("weight") and name.split(".")[0] in ("encoder", "decoder"):
                p.mul_(0.65 if name.startswith("encoder.") else 0.7)
    disc = dac_discriminator.init(
        dac_discriminator.DiscriminatorConfig(periods=(2,), fft_sizes=(512,)),
        torch.Generator().manual_seed(1), device="cpu")
    t = 2 * cfg.hop_length
    audio = (0.3 * torch.sin(2 * np.pi * 220 * torch.arange(t) / cfg.sample_rate)).reshape(
        1, t, 1)
    ng = torch.Generator().manual_seed(2)
    noise = tuple(torch.randn(1, 2, cfg.latent_dim, generator=ng) for _ in range(2))
    kw = dict(gen_lr=1e-3, disc_lr=1e-3, stft_windows=(512,), mel_cfg=((40, 512),))
    results = []
    for d in ("cpu", dev):
        g, dm = copy.deepcopy(gen).to(d), copy.deepcopy(disc).to(d)
        init_state, step = dac_train.make_dac_train_steps(g, dm, **kw)
        state, metrics = step(init_state(), audio.to(d), noise=tuple(n.to(d) for n in noise))
        results.append((state, {k: float(v) for k, v in metrics.items()}))
    (ref_state, ref), (got_state, got) = results
    for name, r in ref.items():
        assert abs(got[name] - r) <= 1e-5 * abs(r), (name, got[name], r)
    rel = {}
    for got_opt, ref_opt in ((got_state.gen_opt, ref_state.gen_opt),
                             (got_state.disc_opt, ref_state.disc_opt)):
        for name, r in ref_opt.mu.items():
            diff = float((got_opt.mu[name].cpu() - r).norm())
            rel[name] = diff / max(float(r.norm()), 1e-30)
    worst = max(rel, key=rel.get)
    print(f"worst first-moment leaf {worst}: relative L2 {rel[worst]:.3e}")
    assert rel[worst] <= 2e-2, (worst, rel[worst])


@pytest.mark.parametrize("data,model", [(1, 1), (1, 2), (2, 1)])
def test_mesh_forward_on_the_card(dev, data, model):
    """The denoiser (128-wide heads, fp32) placed on a mesh of ranks on this card: one rank
    over NCCL equals one card bit for bit; two ranks sharing ``cuda:0`` over gloo (NCCL
    refuses two ranks on one card) hold it within 1e-5 relative L2, each K1 launch on the
    rank's heads."""
    import torch_parallel_programs as programs
    from foley_tpu_torch.parallel.launch import launch
    from foley_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(TINY.model, hidden_size=256, num_heads=2)
    denoiser, inputs = programs.card_model_and_inputs(cfg, torch.float32,
                                                      torch.device("cuda:0"))
    with torch.no_grad():
        ref = denoiser(*inputs).cpu()
    del denoiser
    torch.cuda.empty_cache()
    mesh = make_mesh(data, model, ["cuda:0"] * (data * model))
    assert mesh.backend == ("nccl" if data * model == 1 else "gloo")
    out = launch(mesh, programs.card_forward, cfg, torch.float32, timeout=600)
    if data * model == 1:
        assert torch.equal(out["velocity"], ref)
    else:
        rel = float((out["velocity"] - ref).norm() / ref.norm())
        assert rel <= FP32_REL_TOL, rel
    calls = cfg.depth_triple_blocks + cfg.depth_single_blocks
    for r in out["ranks"]:
        assert r["launches"] == calls and r["heads"] == {cfg.num_heads // model: calls}


@pytest.mark.parametrize("data,model", [(1, 1), (1, 2), (2, 1)])
def test_mesh_train_gradients_on_the_card(dev, data, model):
    """The fp32 flow-matching gradients of the denoiser (128-wide heads) over a mesh of
    ranks on this card (``parallel/training.py``), gathered, against one card's on the same
    global batch and draws: one rank over NCCL bit for bit, two ranks over gloo within 1e-5
    relative L2 per leaf."""
    import torch_parallel_programs as programs
    from foley_tpu_torch.parallel.launch import launch
    from foley_tpu_torch.parallel.mesh import make_mesh
    from foley_tpu_torch.training import train
    from foley_tpu_torch.training.loop import step_generator

    cfg = dataclasses.replace(TINY.model, hidden_size=256, num_heads=2)
    denoiser, _ = programs.card_model_and_inputs(cfg, torch.float32, torch.device("cuda:0"))
    batch = programs.card_train_batch(cfg, torch.device("cuda:0"))
    params = dict(denoiser.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, ref = train.value_and_grad(lambda: train.flow_match_loss(
        denoiser, batch, step_generator(3, 0, "cuda:0"), compute_dtype=torch.float32), params)
    ref = {k: v.cpu() for k, v in ref.items() if v is not None}
    del denoiser, params
    torch.cuda.empty_cache()
    mesh = make_mesh(data, model, ["cuda:0"] * (data * model))
    out = launch(mesh, programs.card_train_grads, cfg, timeout=600)
    assert out["grads"].keys() == ref.keys()
    if data * model == 1:
        assert out["loss"] == float(loss)
        assert all(torch.equal(out["grads"][k], r) for k, r in ref.items())
        return
    assert abs(out["loss"] - float(loss)) <= FP32_REL_TOL * abs(float(loss))
    for k, r in ref.items():
        if r.any():
            assert float((out["grads"][k] - r).norm() / r.norm()) <= FP32_REL_TOL, k
