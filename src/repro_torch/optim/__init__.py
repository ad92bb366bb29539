"""Optimizer (AdamW) and learning-rate schedules."""
