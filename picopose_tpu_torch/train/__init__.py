"""The training step: GT keypoints, losses, affine noise, optimizers and
schedules, and warm starts from checkpoint files."""
