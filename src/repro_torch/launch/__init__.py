"""Step functions and entry points of the port's LM serving and training paths."""
