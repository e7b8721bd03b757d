"""Step functions and drivers of the port's LM serving path."""
