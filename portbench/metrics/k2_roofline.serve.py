"""Percent of the roofline reached by the attention calls of prefill
(``flash_attention.ops.flash_attention``): their bounds from the frozen
counts over their device time."""


def read(run):
    return run.roofline("k2")
