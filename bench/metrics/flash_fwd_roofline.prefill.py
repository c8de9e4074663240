"""The sm90 flash forward's share of its roofline (``kernels/flash``):
the frozen bound of one launch at [B*H, P+S, hd] times the launches, over
their traced time, in per cent."""
from bench import yardstick
from bench.readers import roofline


def read(run):
    cfg, mix = run.config, run.mix
    hd = yardstick.head_dim(cfg)
    bound = yardstick.flash_bound(mix["batch"] * cfg["num_attention_heads"],
                                  mix["seq_len"] + cfg.get("num_patches", 0),
                                  hd, hd)
    return roofline(run, [("flash_fwd_sm90_kernel", bound)])
