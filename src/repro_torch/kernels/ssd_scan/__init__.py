"""The Mamba-2 SSD chunk scan (kernel B6)."""
