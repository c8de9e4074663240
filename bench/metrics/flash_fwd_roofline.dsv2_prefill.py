"""The sm90 flash forward's share of its roofline in MLA's prefill
(``kernels/flash`` at (qk_nope + qk_rope, v) = (192, 128)): the frozen
bound of one launch at [B*H, S, 192 -> 128] times the launches, over
their traced time, in per cent."""
from bench import yardstick
from bench.readers import roofline


def read(run):
    cfg, mix = run.config, run.mix
    bound = yardstick.flash_bound(
        mix["batch"] * cfg["num_attention_heads"], mix["seq_len"],
        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        cfg["v_head_dim"])
    return roofline(run, [("flash_fwd_sm90_kernel", bound)])
