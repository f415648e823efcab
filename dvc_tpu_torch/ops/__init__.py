"""DSP on torch tensors: lws-framed STFT, Slaney mel, 64-frame chunking."""
