"""The whole request's share of the card's peak: the least time the window's requests need
(every matmul and attention product of the denoiser's forwards, CFG rows included, at 989
TFLOP/s bf16; the DAC decode's convolutions at 67 TFLOP/s, fp32 with TF32 off; counted from
shapes, ``flops``) over the traced window, in percent."""

from port_bench import flops
from port_bench.reference.sampling import t2a_lengths


def read(run):
    if run.trace is None or not run.requests:
        return None
    m, p = run.config["model"], run.params
    la, lv, ls = t2a_lengths(run.config["pipeline"], p["duration_s"])
    per_request = (p["steps"] * flops.denoiser_flops(m, la, lv, p["text_len"], ls, 2)
                   / flops.BF16_FLOPS
                   + flops.decode_flops(run.config["dac"], la, 1) / flops.FP32_FLOPS)
    return 100.0 * len(run.requests) * per_request / run.window_s
