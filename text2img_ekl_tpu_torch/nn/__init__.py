"""Generator and discriminator building blocks and conditioning networks."""
