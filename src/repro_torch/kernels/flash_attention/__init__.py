"""Causal or full GQA attention forward for prefill (kernel B4)."""
