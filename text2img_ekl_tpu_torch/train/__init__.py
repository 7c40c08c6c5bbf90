"""Losses, training state and step, sampling, and the trainer loop."""
