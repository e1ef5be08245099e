"""Selectable configurations (the paper's own evaluation setups)."""
