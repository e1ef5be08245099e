"""Fused Wilson–Hilferty Thompson choice (kernel B1)."""
