"""Training (not yet ported) and checkpoint discovery (load side)."""
