"""The port's CUDA kernels on the card (K1, fused qk-norm + RoPE attention; K2, flash
attention; K3, the chained GEMM sweep): each against its plain PyTorch version, and the
wrappers' dispatch. Every test skips without a CUDA card (the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a machine with a card and
no JAX: ``python -m pytest tests/test_torch_cuda.py --noconftest -q``.

Tolerance, bf16 atol 2e-2: each attention kernel's online softmax rounds the unnormalised p
to bf16 and divides by the row sum only at the end, and it sums in another order than the
plain version. K3 sums the same fp32 products in another order, and a flipped bf16 rounding
carries forward through the chain; tanh bounds its output by 1. Its relative L2 error is
held to 1e-2 block by block (``_assert_sweep_close`` says how the chain is held).
"""

import dataclasses

import pytest
import torch

from foley_tpu_torch.configs import TINY
from foley_tpu_torch.core.params import perturb_zero_leaves
from foley_tpu_torch.models import dac_vae, mmdit, siglip2
from foley_tpu_torch.ops.kernels import flash_attention as FL
from foley_tpu_torch.ops.kernels import fused_attention as FA
from foley_tpu_torch.ops.kernels import gemm_sweep as GS
from foley_tpu_torch.ops.rope import rope_table
from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio
from foley_tpu_torch.tools import probe_gemm

KERNEL_TOL = dict(atol=2e-2, rtol=0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _operands(dev, b, lq, lk, h, d=128, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, lq, h, d, device=dev, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(b, lk, h, d, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    wq = torch.empty(lq, d, device=dev).uniform_(0.5, 1.5, generator=gen)
    wk = torch.empty(lk, d, device=dev).uniform_(0.5, 1.5, generator=gen)
    return (q, k, v, wq, wk, *rope_table(lq, d, device=dev), *rope_table(lk, d, device=dev))


@pytest.mark.parametrize("b,lq,lk,h", [(2, 290, 290, 12), (2, 250, 250, 12), (1, 1, 1, 2),
                                       (1, 63, 63, 2), (1, 65, 65, 2), (2, 37, 53, 3),
                                       (1, 65, 1, 2), (1, 1740, 1740, 2)])
def test_kernel_matches_plain(dev, b, lq, lk, h):
    args = _operands(dev, b, lq, lk, h)
    got = FA.fused_qk_attention(*args)
    ref = FA.fused_qk_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), **KERNEL_TOL)


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
    with pytest.raises(TypeError):  # fp32 on the card raises; it does not fall back
        FA.fused_qk_attention(q.float(), k.float(), v.float(), *tabs)
    with pytest.raises(ValueError):  # so does a head_dim other than 128
        FA.fused_qk_attention(q[..., :64], k[..., :64], v[..., :64],
                              *(t[:, :64] for t in tabs))
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


# ---- K2: flash attention ----

def _qkv(dev, b, lq, lk, h, d, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, lq, h, d, device=dev, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(b, lk, h, d, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,lq,lk,h,d", [(4, 1024, 1024, 12, 64), (1, 1, 1, 2, 64),
                                         (1, 63, 63, 2, 64), (1, 65, 65, 2, 64),
                                         (1, 250, 77, 2, 128), (2, 37, 53, 3, 64),
                                         (1, 65, 1, 2, 128), (2, 290, 290, 12, 128)])
def test_flash_kernel_matches_plain(dev, b, lq, lk, h, d):
    q, k, v = _qkv(dev, b, lq, lk, h, d)
    got = FL.flash_attention(q, k, v)
    ref = FL.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), **KERNEL_TOL)


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
    for dtype in (torch.float32, torch.float16):  # the card takes bf16 only; no fallback
        with pytest.raises(TypeError):
            FL.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
    with pytest.raises(ValueError):  # so does a head_dim other than 64 or 128
        FL.flash_attention(q[..., :32], k[..., :32], v[..., :32])
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
                                          (40, 64, 192, 3), (130, 64, 64, 1), (300, 128, 136, 4)])
def test_gemm_sweep_matches_plain(dev, m, k, n, blocks):
    x, w = _sweep_inputs(dev, m, k, n, blocks)
    got = GS.gemm_sweep(x, w)
    torch.cuda.synchronize()
    _assert_sweep_close(x, w, got)


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
    assert GS.gemm_sweep.launches == before + 5  # one launch per weight block
    for dtype in (torch.float32, torch.float16):  # the card takes bf16 only; no fallback
        with pytest.raises(TypeError):
            GS.gemm_sweep(x.to(dtype), w.to(dtype))
    with pytest.raises(ValueError):  # so does a K that is not a multiple of the k-step
        GS.gemm_sweep(x[:, :48], w[:, :48, :48])
    assert GS.gemm_sweep.launches == before + 5
    monkeypatch.undo()
    _assert_sweep_close(x, w, got)


def test_probe_measures_on_the_card(dev, monkeypatch):
    for name, value in dict(M=256, K=512, N=1536, BLOCKS=4, ITERS=3, PLAIN_ITERS=1).items():
        monkeypatch.setattr(probe_gemm, name, value)
    rec = probe_gemm.measure(dev)
    assert rec["device"] == torch.cuda.get_device_name(dev)
    assert rec["launches_per_sweep"] == 4
    assert rec["max_abs_err"] <= 2e-2
    assert rec["rel_l2_err"] <= max(1e-2, 2 * rec["plain_fp64_rel_l2"])
    for v in ("kernel", "library_sweep", "library_sweep_full", "plain"):
        assert rec[v]["ms_per_sweep"] > 0 and rec[v]["graph_ms_per_sweep"] > 0
    # wrapper calls: the checked sweep, a warm-up, three timed, the graph's warm-up and capture
    assert rec["kernel_sweeps"] == 1 + 1 + 3 + 2
