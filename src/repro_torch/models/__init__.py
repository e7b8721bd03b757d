"""The port's LM stack: dense decoder families (``transformer``), their
layers and attention, and the ``model_zoo`` entry points."""
