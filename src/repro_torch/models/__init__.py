"""The LM substrate: layers, attention, the mamba and xLSTM blocks, the
decoder-only stack, the encoder-decoder and the model factory."""
