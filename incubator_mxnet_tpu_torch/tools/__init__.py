"""Measurement scripts that run on the card; nothing here is imported by
the framework."""
