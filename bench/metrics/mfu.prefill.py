"""The whole prefill's share of the card's bf16 peak: the model FLOPs of
the prefills finished in the traced window (the benchmark's own count
from the configuration) over the window's length on the host's clock
times 989 TFLOP/s, in per cent."""
from bench import yardstick
from bench.readers import peak_share


def read(run):
    cfg, mix = run.config, run.mix
    s = mix["seq_len"]
    one = yardstick.forward_flops(cfg, cfg["num_hidden_layers"], mix["batch"],
                                  s + cfg.get("num_patches", 0), s)
    return peak_share(run, run.counters.get("requests", 0) * one)
