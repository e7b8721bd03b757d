"""granite-3's dense decoder is the llama form: the same layers, with four
multipliers that :func:`llama.dims` holds to the plain form (the
configuration lists them under ``reduced``)."""

from families.llama import *  # noqa: F401,F403
