"""Evaluation: mel-cepstral distortion."""
