"""The device ms a prefill call of the program's ``lm.norm`` and ``lm.rope``
spans (each layer's two RMSNorms and its rotary of q and k), summed over
the layers, mean over the traced calls."""

import program_spans


def read(run):
    return program_spans.device_ms_per_call(run, ["lm.norm", "lm.rope"])
