"""The plain float32 reference: network, training step, pseudo-labeller."""
