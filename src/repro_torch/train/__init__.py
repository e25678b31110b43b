"""LM training of the port: AdamW, checkpoints, the loop."""
