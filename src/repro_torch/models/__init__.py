"""Model code: shared layers and the decoder-only transformer."""
