"""``repro_torch`` — the PyTorch / CUDA port of the synchronization compiler.

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module and imports nothing of it.  Its main path is the
reference's: ``plan(prog, PlanOptions(...))`` → ``SyncPlan.compile("torch",
device=...)`` → ``Executable.run(store)``, plus the pipelined matmul whose
ring depth and waits come from that same path
(:mod:`repro_torch.kernels.pipelined_matmul`).
"""
