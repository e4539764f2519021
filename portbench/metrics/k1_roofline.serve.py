"""Percent of the roofline reached by the attention calls of decode
(``decode_attention.ops.decode_attention``), bytes over each row's
length."""


def read(run):
    return run.roofline("k1")
