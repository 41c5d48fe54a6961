"""Training data: the step-indexed synthetic pipeline."""
