"""Host-device overlap; the model-parallel axes come beside it."""
