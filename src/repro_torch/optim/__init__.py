"""Optimizers of the training path: AdamW and gradient compression."""
