"""Fused Wilson–Hilferty Thompson choice (kernels B1 and B2, its batch over queries)."""
