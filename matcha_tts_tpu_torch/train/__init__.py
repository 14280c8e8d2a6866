"""Training of the Matcha acoustic model: losses, optimizer step, loop, CLI."""
