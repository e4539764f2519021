"""Model flops done in the traced window over the window at the chip's
bf16 peak: every prefill (2 N a prompt token, the head once, causal
attention) and every decode step's active rows (2 N and attention over
each row's keys)."""
from portbench import counts


def read(run):
    flops = sum(counts.prefill_flops(run.arch, r["S"]) * (r["tokens"] // r["S"])
                for r in run.of("prefill"))
    flops += sum(counts.decode_flops(run.arch, r["active_lens"])
                 for r in run.of("decode"))
    return run.mfu(flops)
