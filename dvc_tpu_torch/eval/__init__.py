"""Evaluation: mel-cepstral distortion and the speaker encoder's equal error rate."""
