"""Loops of the traffic kinds, one module per kind, found by the mix's ``kind``."""
