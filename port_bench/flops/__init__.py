"""The yardstick's arithmetic: the card's peaks, a kernel's least time, and the operations
and bytes of the work a request needs, from shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 989 TFLOP/s dense bf16 on
the tensor cores, 67 TFLOP/s fp32 on the CUDA cores (the DAC decode runs in fp32 with TF32
off), 3.35 TB/s of HBM. A kernel's least time is the larger of its operations at the peak
and its bytes at the memory rate, each input read once and each output written once.

Operation counts are those of the plain reference (``reference/``): a multiply-add is two
operations; a linear or convolution counts ``2 * out * in * kernel`` a position, an
attention ``4 * heads * Lq * Lk * head_dim``; norms, activations and other elementwise work
count nothing. ``tests/test_port_bench_flops.py`` holds them to
``torch.utils.flop_counter.FlopCounterMode``'s count of the reference.
"""

from __future__ import annotations

from port_bench.reference.layout import conv_mlp_hidden

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_s(n_bytes: float, flops: float, peak: float = BF16_FLOPS) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak)


def k1_launch(rows: int, length: int, heads: int, head_dim: int, streams: int):
    """(bytes, operations) of one K1 call (``fused_qk_attention``: q and k RMS-normed and
    rotated, then attention) on [rows, length, heads, head_dim] bf16 operands: q, k, v read
    and o written in bf16, the fp32 cos / sin tables [length, head_dim] read once, the norm
    weights as the [head_dim] rows they are made of (one a stream), for q and for k."""
    n_bytes = 4 * rows * length * heads * head_dim * 2 + 2 * length * head_dim * 4 \
        + 2 * streams * head_dim * 4
    return n_bytes, 4 * rows * heads * length * length * head_dim


def k1_step(m: dict, audio_len: int, visual_len: int, rows: int):
    """K1's calls in one denoiser forward over ``rows`` rows: one joint ``[visual; audio]``
    call a triple block, one audio call a single block. [(count, bytes, operations)]."""
    h, hd = m["num_heads"], m["hidden_size"] // m["num_heads"]
    return [(m["depth_triple_blocks"], *k1_launch(rows, audio_len + visual_len, h, hd, 2)),
            (m["depth_single_blocks"], *k1_launch(rows, audio_len, h, hd, 1))]


def _lin(positions: int, n_in: int, n_out: int, k: int = 1) -> int:
    return 2 * positions * n_in * n_out * k


def denoiser_flops(m: dict, audio_len: int, visual_len: int, text_len: int, sync_len: int,
                   rows: int) -> int:
    """Operations of one reference forward (``reference/mmdit.py::forward``) over ``rows``
    rows."""
    h, nh = m["hidden_size"], m["num_heads"]
    hd, hc, mlp = h // nh, conv_mlp_hidden(m), int(h * m["mlp_ratio"])
    la, lv, lt = audio_len, visual_len, text_len
    k = m["sync_in_ksz"]
    f = _lin(1, 256, h) + _lin(1, h, h)                                   # time_in
    f += _lin(sync_len, m["sync_feat_dim"], h) + 3 * _lin(sync_len, h, hc, k)  # sync_in
    f += _lin(lt, m["condition_dim"], h) + _lin(lt, h, h)                 # cond_in
    f += _lin(la, m["audio_vae_latent_dim"], h, m["patch_size"])          # audio_embedder
    f += 2 * _lin(lv, m["clip_dim"], h) + _lin(lv, h, h)                  # visual_proj
    lj = la + lv
    triple = (2 * _lin(1, h, 9 * h)                                       # adaLN, two streams
              + _lin(lj, h, 3 * h) + 4 * nh * lj * lj * hd + _lin(lj, h, h)  # joint attention
              + _lin(lj, h, h) + _lin(lt, h, 2 * h) + 4 * nh * lj * lt * hd  # cross attention
              + _lin(lj, h, h)
              + 2 * _lin(lj, h, mlp))                                     # MLPs
    single = (_lin(la, h, 6 * h) + _lin(la, h, 3 * h) + 4 * nh * la * la * hd
              + _lin(la, h, h, 3) + 3 * _lin(la, h, hc, 3))
    f += m["depth_triple_blocks"] * triple + m["depth_single_blocks"] * single
    f += _lin(la, h, m["audio_vae_latent_dim"] * m["patch_size"])         # final layer
    return rows * f


def decode_flops(d: dict, latent_len: int, rows: int) -> int:
    """Operations of the reference DAC decode (``reference/dac.py::decode``) of ``rows``
    latent sequences of ``latent_len`` frames. A transposed convolution counts ``2 * in *
    out * kernel`` an input position."""
    lat, dim = d["latent_dim"], d["decoder_dim"]
    f = _lin(latent_len, lat, lat) + _lin(latent_len, lat, dim, 7)
    length = latent_len
    for i, s in enumerate(d["decoder_rates"]):
        cin, cout = dim // 2 ** i, dim // 2 ** (i + 1)
        f += _lin(length, cin, cout, 2 * s)
        length *= s
        f += 3 * (_lin(length, cout, cout, 7) + _lin(length, cout, cout))
    f += _lin(length, dim // 2 ** len(d["decoder_rates"]), 1, 7)
    return rows * f
