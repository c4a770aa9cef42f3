"""Model zoo of the port (DeepSpeech2 so far)."""
