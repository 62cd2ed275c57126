"""Delivery layer above the engine: leased counter windows and producers."""
