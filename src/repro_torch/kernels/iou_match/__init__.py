"""Pairwise IoU matrix for the matcher (kernel B3, with a batched entry over queries)."""
