"""Training: AdamW with an optional 8-bit state, checkpoints and the train step."""
