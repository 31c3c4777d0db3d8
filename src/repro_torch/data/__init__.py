"""Synthetic stand-ins for the paper's datasets."""
