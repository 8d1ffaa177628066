"""Graph examples: build, convert, reorder and colour."""
