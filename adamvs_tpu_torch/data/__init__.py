"""Sample lists, sample assembly, the batching loader and synthetic fixture trees."""
