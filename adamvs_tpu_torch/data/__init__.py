"""Predict-source lists, sample assembly and synthetic fixture trees."""
