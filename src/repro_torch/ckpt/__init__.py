"""Checkpointing of training state under the persistence policies."""
