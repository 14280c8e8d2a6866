"""Inference: the bucketed synthesis engine, the streaming vocoder, the HTTP server and the CLI."""
