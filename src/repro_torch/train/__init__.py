"""Training state.  The step and the trainer wait for the train slice."""
