"""Flash attention: the Hopper kernels (``csrc/tma_wgmma_flash.cu``,
``csrc/tma_wgmma_flash_tf32x3.cu``, ``csrc/flash_decode.cu``), their plain
PyTorch version (``ref.py``) and the wrapper (``ops.py``)."""
