"""History decomposition; so far only the row projection the shrink of
invalid verdicts needs."""
