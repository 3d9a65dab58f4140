"""Shared utilities: structured logging, image IO, the stage timer."""
