"""Model flops of the traced steps (6 N a token and causal attention's
forward and backward; recomputation not counted) over the traced window
at the chip's bf16 peak."""
from portbench import counts


def read(run):
    steps = len(run.of("optimizer"))
    flops = steps * counts.train_step_flops(run.arch, run.mix["rows"],
                                            run.mix["seq_len"])
    return run.mfu(flops)
