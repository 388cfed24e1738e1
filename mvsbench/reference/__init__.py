"""The plain PyTorch reference the benchmark compares the port with; it imports
nothing of the port."""
