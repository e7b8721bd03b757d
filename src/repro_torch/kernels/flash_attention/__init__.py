"""Flash attention: the Hopper kernel (``csrc/flash_attention.cu``), its
plain PyTorch version (``ref.py``) and the wrapper (``ops.py``)."""
