"""Pairwise IoU matrix for the matcher (kernel B3)."""
