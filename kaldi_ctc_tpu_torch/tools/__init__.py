"""Diagnostic helpers (counterpart of the repo's ``tools/``)."""
