"""The whole DeepSeek-V2 prefill's share of the card's bf16 peak: the
model FLOPs of the requests finished in the traced window (the
architecture's own count from the configuration's widths, routed experts
at the choices that fall on the experts held) over the window's length
on the host's clock times 989 TFLOP/s, in per cent."""
from bench import models
from bench.readers import peak_share


def read(run):
    cfg, mix = run.config, run.mix
    one = models.arch(cfg).forward_flops(cfg, mix["batch"], mix["seq_len"])
    return peak_share(run, run.counters.get("requests", 0) * one)
