"""Host-side data constants (the batcher is not ported yet)."""
