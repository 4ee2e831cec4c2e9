"""Inputs drawn from the run's seed, handed the same to the port and the reference."""
