"""Causal (optionally sliding-window) GQA attention: the flash kernel."""
