"""Data-side helpers the port needs (``units``: the unit dictionaries)."""
