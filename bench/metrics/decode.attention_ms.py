"""The device ms a decode step of the program's ``lm.attention`` spans (the
attention core of every layer: ``decode_attention`` over the cache), summed
over the layers, mean over the traced steps."""

import program_spans


def read(run):
    return program_spans.device_ms_per_call(run, ["lm.attention"])
