"""Inference: the bucketed synthesis engine and the CLI."""
