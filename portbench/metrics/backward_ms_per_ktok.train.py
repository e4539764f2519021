"""Device ms of the program's ``train.backward`` spans (``autograd.grad``
and the gradients' layout, CUDA events on the stream) per 1000 label
tokens."""
from portbench import program_spans


def read(run):
    return program_spans.device_ms_per_ktok("train.backward")
