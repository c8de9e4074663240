"""The whole train step's share of the card's bf16 peak: three times the
forward's model FLOPs (the benchmark's own count from the configuration;
the recomputation under remat is not counted) of the steps finished in
the traced window, over the window's length on the host's clock times
989 TFLOP/s, in per cent."""
from bench import yardstick
from bench.readers import peak_share


def read(run):
    cfg, mix = run.config, run.mix
    s = mix["seq_len"]
    step = 3 * yardstick.forward_flops(cfg, cfg["num_hidden_layers"],
                                       mix["batch"], s, s)
    return peak_share(run, run.counters.get("steps", 0) * step)
