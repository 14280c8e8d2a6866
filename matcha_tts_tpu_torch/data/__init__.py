"""Training data: filelists, WAV loading, bucketed batches, mel statistics."""
