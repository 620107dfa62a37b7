"""Analyses around the checker; so far the shrink of invalid verdicts."""
