"""Stage ABI and vector metadata."""
