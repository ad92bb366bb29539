"""Optimizer configuration and state.  The update step waits for the
train slice."""
