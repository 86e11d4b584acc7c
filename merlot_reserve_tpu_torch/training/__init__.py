"""Pretraining: the optimizer, the step and the step loop."""
