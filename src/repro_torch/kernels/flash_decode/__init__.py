"""One query token per sequence against a KV cache (kernel B5)."""
