"""Training: losses, AdamW with clipping and schedules, metrics, checkpoints and the trainer."""
