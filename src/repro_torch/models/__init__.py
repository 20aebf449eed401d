"""The LM substrate: layers, attention, the decoder-only stack and the
model factory."""
