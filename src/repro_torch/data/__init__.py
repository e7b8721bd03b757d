"""Data substrate: deterministic synthetic sharded token pipeline."""
