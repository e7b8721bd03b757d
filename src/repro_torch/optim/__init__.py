"""Optimizer substrate: AdamW, schedules, gradient compression."""
