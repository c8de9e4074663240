"""The sm90 flash backward's share of its roofline (``kernels/flash``):
the frozen bounds of the dq and the dk/dv kernel at [B*H, S, hd] times
their launches, over their traced time, in per cent."""
from bench import yardstick
from bench.readers import roofline


def read(run):
    cfg, mix = run.config, run.mix
    hd = yardstick.head_dim(cfg)
    shape = (mix["batch"] * cfg["num_attention_heads"], mix["seq_len"], hd, hd)
    return roofline(run, [
        ("flash_bwd_dq_sm90_kernel",
         yardstick.flash_bwd_bound(*shape, "flash_bwd_dq")),
        ("flash_bwd_dkv_sm90_kernel",
         yardstick.flash_bwd_bound(*shape, "flash_bwd_dkv"))])
