"""Checkpointing: atomic step dirs, async writer, retention, resume."""
