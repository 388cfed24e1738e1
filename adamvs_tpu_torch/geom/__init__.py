"""Camera conventions (numpy)."""
