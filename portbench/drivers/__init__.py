"""One driver per configuration kind: set-up, window, reference and check."""
