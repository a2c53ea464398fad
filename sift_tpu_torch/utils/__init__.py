"""Utilities: stage timing, logging and counters, capacity ladder,
evaluation metrics."""
