"""The mean of ``GenerationResult.timings["denoise_decode_s"]`` over the window's requests:
the solver loop, the denoiser and the DAC decode, ended by the host copy of the audio."""


def read(run):
    t = [r.timings["denoise_decode_s"] for r in run.requests if r.timings]
    return sum(t) / len(t) if t else None
