"""Percent of the roofline reached by the attention backward, from the
identity functions around the attention call to the end of its gradient:
the frozen K2-bwd counts over that device time."""


def read(run):
    return run.roofline("k2bwd")
