"""Runtime control plane: fault tolerance, supervised training."""
