"""Training: the train state, the step and the trainer."""
