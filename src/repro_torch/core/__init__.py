"""Host sketch (copied jax-free modules) and the device bank of sketches."""
