"""Device ops of the charge chain."""
